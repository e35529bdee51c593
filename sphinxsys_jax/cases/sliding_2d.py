"""2D elastic cube sliding down a frictionless rigid 30-degree slope.

Counterpart of /root/reference/tests/2d_examples/test_2d_sliding/sliding.cpp:
a SaintVenantKirchhoff cube (L=1, E=5e5, nu=0.45) rests on the top surface
of a rigid wall; both bodies are rotated by -0.5235 rad about the origin
(TranslationAndRotation, sliding.cpp:104-106) so the surface becomes a
30-degree incline, and the cube slides under gravity with frictionless
penalty contact (ContactFactorSummation + ContactForceFromWall,
sliding.cpp:110-111) and strong internal pairwise damping
(DampingWithRandomChoice eta=1e6, sliding.cpp:112).

Analytic oracle: frictionless rigid-body slide, s(t) = 1/2 g sin(theta) t^2
along the incline; the reference's own ensemble DB final displacement
(13.26, -7.67) matches this to <0.2%.

Deviations from the reference, by design:
  * the wall triangle is generated only as a 4*dx-deep band under its top
    surface — contact only ever sees particles within the kernel cutoff of
    the surface, the deep interior is inert ballast;
  * DampingWithRandomChoice(0.5, eta) is applied every step at the same
    eta via the Jacobi pairwise form (dissipation.py) — the random 50%
    skip is a load-balancing trick, not physics.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.state import State, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import contact as ct
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import solid as sd

DL = 20.0
SLOPE_H = 11.55          # top surface height before rotation
L = 1.0                  # cube edge
THETA = 0.5235           # rotation angle (30 degrees)
RHO0 = 1.0e3
YOUNGS = 5.0e5
POISSON = 0.45
GRAVITY_G = 9.8
PHYSICAL_VISCOSITY = 1.0e6
OBSERVER = (7.2, 9.8)    # sliding.cpp:22 (world frame, post-rotation)


class SimState(NamedTuple):
    cube: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class SlidingCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: SaintVenantKirchhoffSolid
    wall: State
    wall_table: Any
    rp: sd.ReferencePairs
    nl_inner: Any
    n_cube: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _rotate(pos: np.ndarray, theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    rot = np.asarray([[c, -s], [s, c]])
    return pos @ rot.T


def build_case(dx: float = L / 10.0, dtype=jnp.float32, cell_cap: int = 16,
               k_inner: int = 32, k_contact: int = 24):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    bw = 4 * dx

    # wall: 4*dx-deep band under the top surface y = SLOPE_H (see module
    # docstring), lattice-centred like generate_lattice
    nx, ny = int(round(DL / dx)), 4
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    wall_pos = np.stack([(ix.ravel() + 0.5) * dx,
                         SLOPE_H - (iy.ravel() + 0.5) * dx], axis=1)
    wall_pos = _rotate(wall_pos, -THETA)
    wall = dict(make_solid_state(wall_pos, dx * dx, RHO0, dtype=dtype))

    # cube: [bw, bw+L] x [SLOPE_H+dx, SLOPE_H+L+dx] (sliding.cpp:50-56)
    ncx = int(round(L / dx))
    jx, jy = np.meshgrid(np.arange(ncx), np.arange(ncx), indexing="ij")
    cube_pos = np.stack([bw + (jx.ravel() + 0.5) * dx,
                         SLOPE_H + dx + (jy.ravel() + 0.5) * dx], axis=1)
    cube_pos = _rotate(cube_pos, -THETA)

    cube = dict(sd.make_elastic_solid_state(cube_pos, dx * dx, material,
                                            dtype=dtype))
    n = len(cube_pos)
    cube.update({
        "RepulsionForce": jnp.zeros((n, 2), dtype),
        "PreviousRepulsionForce": jnp.zeros((n, 2), dtype),
    })
    cube = gd.gravity_force(cube, gd.Gravity(acceleration=(0.0, -GRAVITY_G)))

    all_pos = np.concatenate([wall_pos, cube_pos])
    lo = all_pos.min(axis=0) - 4 * dx
    # the cube travels ~16 units down-slope by t=2.5: extend the bounds
    hi = all_pos.max(axis=0) + 4 * dx
    grid = grid_from_bounds(tuple(lo), tuple(hi), adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    cube_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        cube["Position"], cube["NReal"])
    nl_inner = jax.jit(partial(
        build_neighbor_list, grid=grid, cutoff=adaptation.cutoff,
        k_max=k_inner, include_self=False))(
        cube["Position"], cube["NReal"], cube["Position"], cube["NReal"],
        cube_table)
    rp = sd.freeze_reference_pairs(cube["Position"], nl_inner,
                                   adaptation.kernel, 2)
    cube["LinearGradientCorrectionMatrix"] = sd.linear_gradient_correction_matrix(
        rp, cube["VolumetricMeasure"])

    case = SlidingCase(dx=dx, adaptation=adaptation, grid=grid,
                       material=material, wall=wall, wall_table=wall_table,
                       rp=rp, nl_inner=nl_inner, n_cube=n,
                       k_contact=k_contact)
    return case, cube


def init_sim(case: SlidingCase, cube: State) -> SimState:
    dtype = cube["Position"].dtype
    return SimState(cube=cube, time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _step(case: SlidingCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    cube = s.cube

    nl = build_neighbor_list(cube["Position"], cube["NReal"],
                             case.wall["Position"], case.wall["NReal"],
                             case.wall_table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_contact,
                             include_self=True)
    factor = ct.repulsion_factor_contact(cube, case.wall, nl, kernel, dim)
    stiffness = ct.contact_stiffness(case.material)
    cube = ct.repulsion_force_wall(cube, case.wall, nl, kernel, dim,
                                   factor, stiffness)

    dt = sd.solid_acoustic_time_step(cube, case.material.sound_speed, h,
                                     cfl=0.45)
    cube = sd.integration_1st_half_pk2(cube, case.rp, case.material, dt, h,
                                       kernel.w0(dim))
    cube = dp.damping_pairwise(cube, "Velocity", case.nl_inner, kernel, dim,
                               PHYSICAL_VISCOSITY, dt)
    cube = sd.integration_2nd_half(cube, case.rp, dt)

    return SimState(cube=cube, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: SlidingCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def cube_observer(case: SlidingCase, cube: State):
    """Frozen-topology material observer at OBSERVER (sliding.cpp:22):
    interpolation weights W(r0)*Vol are built once against the initial
    configuration and never updated (the observer contact relation is not
    in the update loop, sliding.cpp:155-181), so reading Position through
    them tracks the cube material point."""
    pos0 = np.asarray(cube["InitialPosition"])
    r = np.linalg.norm(pos0 - np.asarray(OBSERVER), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    kernel = case.kernel
    w = np.asarray([float(kernel.W(jnp.asarray(ri, pos0.dtype), 2))
                    for ri in r[idx]])
    w = w * np.asarray(cube["VolumetricMeasure"])[idx]
    return jnp.asarray(idx), jnp.asarray(w / (w.sum() + 1e-15), pos0.dtype)


def observe_position(s: SimState, idx, weights) -> np.ndarray:
    return np.asarray(jnp.sum(s.cube["Position"][idx] * weights[:, None],
                              axis=0))


def slide_distance(s: SimState, pos_start: np.ndarray) -> float:
    """Mean displacement magnitude along the incline."""
    d = np.asarray(jnp.mean(s.cube["Position"], axis=0)) - pos_start
    return float(np.linalg.norm(d))
