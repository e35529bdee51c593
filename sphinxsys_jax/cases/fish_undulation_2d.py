"""2D fish undulation — the active-strain muscle drive of the fish case.

Counterpart of the structural half of /root/reference/tests/2d_examples/
test_2d_flow_stream_around_fish/: the fish body (5th-order-polynomial
outline, DOI 10.1016/j.jtbi.2016.08.025) is a composite total-Lagrangian
solid of three materials — active muscle flanks (E=0.8e6), passive body
(E=0.5e6), stiff head+spine (E=1.1e6) — and the muscle carries a
traveling-wave active strain

    E_a00 = -Am hx(x) (1 - e^{-t/0.2}) sin^2(w t/2 + k x/2 + phase)

with antiphase top/bottom flanks (ImposingActiveStrain,
2d_flow_stream_around_fish.h:167-213), producing the swimming undulation.
Here the body undulates in vacuum (no fluid): linear momentum must stay
zero and the tail must beat at the 4 Hz drive frequency — the structural
oracle for the full FSI case.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import solid as sd

# 2d_flow_stream_around_fish.h:27-48
FISH_LENGTH = 0.2
FISH_THICKNESS = 0.03
MUSCLE_THICKNESS = 0.02
HEAD_LENGTH = 0.03
BONE_THICKNESS = 0.003
RHO0_S = 1050.0
E_MUSCLE, E_BODY, E_HEAD = 0.8e6, 0.5e6, 1.1e6
POISSON = 0.49

AM = 0.12            # active strain amplitude
FREQUENCY = 4.0      # Hz
WAVELENGTH = 3.0 * FISH_LENGTH
START_TIME = 0.2     # ramp time constant


def outline(x, h, L=FISH_LENGTH):
    """Fish half-width y(x) (2d_fish_and_bones.h:9-23)."""
    a = [1.22 * h / L, 3.19 * h / L**2, -15.73 * h / L**3,
         21.87 * h / L**4, -10.55 * h / L**5]
    return sum(a[n] * x ** (n + 1) for n in range(5))


def fish_polygon(resolution: float, n_points: int = 100):
    """Closed fish outline polygon, head at x=0, tail at x=FISH_LENGTH
    (CreatFishShape; the reference walks tail->head on the upper camber)."""
    L = FISH_LENGTH
    xs = np.linspace(L, 0.0, n_points + 1)  # t from L to 0 => x head->tail
    pts = []
    for t in xs:
        y = outline(t, FISH_THICKNESS)
        if y >= resolution:
            pts.append((L - t, y))
    upper = np.asarray(pts)
    lower = upper[::-1].copy()
    lower[:, 1] *= -1.0
    verts = np.concatenate([upper, lower], axis=0)
    return G.Polygon(vertices=tuple(map(tuple, verts)))


class SimState(NamedTuple):
    fish: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class FishCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid   # stiffest: sets the time step
    rp: sd.ReferencePairs
    n_fish: int
    tail_idx: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def material_regions(pos: np.ndarray, origin=(0.0, 0.0)):
    """MaterialID per particle (FishMaterialInitialization,
    2d_flow_stream_around_fish.h:134-162): 0 muscle flanks, 1 passive
    body, 2 head + spine.  `origin` is the fish nose position (cx, cy)."""
    x, y = pos[:, 0] - origin[0], pos[:, 1] - origin[1]
    y_muscle = outline(x, MUSCLE_THICKNESS)
    in_tail = x <= (FISH_LENGTH - HEAD_LENGTH)
    upper = in_tail & (y > y_muscle - 0.004) & (y > BONE_THICKNESS / 2)
    lower = in_tail & (y < -y_muscle + 0.004) & (y < -BONE_THICKNESS / 2)
    head_or_bone = (~in_tail) | (np.abs(y) < BONE_THICKNESS / 2)
    mat = np.ones(len(pos), np.int32)
    mat[head_or_bone] = 2
    mat[upper | lower] = 0
    return mat


def build_case(dx: float = 0.0025, dtype=jnp.float32, k_inner: int = 48):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    shape = fish_polygon(dx * 0.5)
    lo, hi = (-0.02, -0.05), (FISH_LENGTH + 0.02, 0.05)
    pos, vol = generate_lattice(shape, lo, hi, dx)
    pos = np.asarray(pos)

    stiff = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=E_HEAD,
                                      poisson_ratio=POISSON)
    fish = dict(sd.make_elastic_solid_state(pos, vol, stiff, dtype=dtype))
    n = len(pos)

    mat = material_regions(pos)
    youngs = np.choose(mat, [E_MUSCLE, E_BODY, E_HEAD])
    lam = youngs * POISSON / ((1 + POISSON) * (1 - 2 * POISSON))
    G0 = youngs / (2 * (1 + POISSON))
    fish["MaterialID"] = jnp.asarray(mat)
    fish["Lambda0"] = jnp.asarray(lam, dtype)
    fish["ShearModulus"] = jnp.asarray(G0, dtype)
    fish["ActiveStrain"] = jnp.zeros((n, 2, 2), dtype)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = jax.jit(partial(build_cell_table, grid=grid, cap=24))(
        fish["Position"], fish["NReal"])
    nl = jax.jit(partial(build_neighbor_list, grid=grid,
                         cutoff=adaptation.cutoff, k_max=k_inner,
                         include_self=False))(
        fish["Position"], fish["NReal"], fish["Position"], fish["NReal"],
        table)
    rp = sd.freeze_reference_pairs(fish["Position"], nl, adaptation.kernel, 2)
    fish["LinearGradientCorrectionMatrix"] = sd.linear_gradient_correction_matrix(
        rp, fish["VolumetricMeasure"])

    tail_idx = int(np.argmax(pos[:, 0]))
    case = FishCase(dx=dx, adaptation=adaptation, material=stiff, rp=rp,
                    n_fish=n, tail_idx=tail_idx)
    sim = SimState(fish=fish, time=jnp.zeros((), dtype),
                   n_steps=jnp.zeros((), jnp.int32),
                   dt=jnp.zeros((), dtype))
    return case, sim


def impose_active_strain(fish: State, t, origin=(0.0, 0.0)) -> State:
    """Traveling-wave muscle activation (ImposingActiveStrain)."""
    out = dict(fish)
    pos0 = fish["InitialPosition"]
    x = pos0[:, 0] - origin[0]
    y = pos0[:, 1] - origin[1]
    hx = -(x ** 2 - FISH_LENGTH ** 2) / FISH_LENGTH ** 2
    w = 2.0 * math.pi * FREQUENCY
    k = 2.0 * math.pi / WAVELENGTH
    strength = 1.0 - jnp.exp(-t / START_TIME)
    phase = jnp.where(y > BONE_THICKNESS / 2, 0.0, math.pi / 2)
    ea00 = -AM * hx * strength * jnp.sin(w * t / 2 + k * x / 2 + phase) ** 2
    ea00 = jnp.where(fish["MaterialID"] == 0, ea00, 0.0)
    out["ActiveStrain"] = fish["ActiveStrain"].at[:, 0, 0].set(
        ea00.astype(fish["ActiveStrain"].dtype))
    return out


def _pk1(fish: State, F):
    return sd.active_model_pk1(F, fish["ActiveStrain"], fish["Lambda0"],
                               fish["ShearModulus"])


def _step(case: FishCase, s: SimState) -> SimState:
    h = case.adaptation.h
    fish = impose_active_strain(s.fish, s.time)
    fish = sd.integration_1st_half_pk2(fish, case.rp, case.material, s.dt, h,
                                       case.kernel.w0(2), pk1_fn=_pk1)
    fish = sd.integration_2nd_half(fish, case.rp, s.dt)
    dt_next = sd.solid_acoustic_time_step(fish, case.material.sound_speed, h,
                                          cfl=0.45)
    return SimState(fish=fish, time=s.time + dt_next,
                    n_steps=s.n_steps + 1, dt=dt_next)


def make_run_chunk(case: FishCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def tail_lateral_displacement(case: FishCase, s: SimState) -> float:
    i = case.tail_idx
    return float(s.fish["Position"][i, 1] - s.fish["InitialPosition"][i, 1])


def center_of_mass(s: SimState) -> np.ndarray:
    m = np.asarray(s.fish["Mass"])
    p = np.asarray(s.fish["Position"])
    return (m[:, None] * p).sum(0) / m.sum()
