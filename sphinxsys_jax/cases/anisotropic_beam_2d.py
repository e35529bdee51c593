"""2D oscillating beam on an ANISOTROPIC particle lattice (dp_x = 4 dp_y).

Counterpart of /root/reference/tests/2d_examples/test_2d_anisotropic_beam/
test_2d_anisotropic_beam.cpp: the canonical clamped oscillating beam
(same material/IC as cases/oscillating_beam_2d.py), but discretized with
4x coarser spacing along the beam axis and the AnisotropicKernel
(anisotropic_kernel.{h,hpp}, scaling vector (4, 1) * dp_y) restoring the
kernel consistency — 4x fewer particles reproduce the isotropic physics.

XLA-native formulation: the anisotropic kernel gradient is a full VECTOR
(not dW * e_ij), so the frozen reference pairs encode it losslessly as
e := -grad_W/|grad_W|, dW := -|grad_W| (then dW * e == grad_W and every
total-Lagrangian op runs unchanged); the corrected configuration
(AnisotropicCorrectConfiguration, cpp:132-186) is built from the true
pair displacement against that vector gradient.

Oracle (tests/test_anisotropic_beam.py): tip trajectory matches the
validated ISOTROPIC oscillating_beam_2d run — period and amplitude — at
1/4 the x-resolution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.kernels import AnisotropicKernel, WendlandC2
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.physics.pair import gather

PL = 0.2
PH = 0.02
SL = 0.02                    # constrained length (cpp:14)
RATIO = 4.0                  # dp_x / dp_y (cpp:16)
RHO0_S = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975

KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.05


class BeamSim(NamedTuple):
    solid: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class AnisoBeamCase:
    dx: float                 # dp_y
    kernel: AnisotropicKernel
    h: float                  # base smoothing length (y direction)
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: jnp.ndarray
    n_solid: int


def freeze_anisotropic_pairs(pos0, nl, kernel: AnisotropicKernel, dim: int
                             ) -> sd.ReferencePairs:
    """Frozen pairs with the anisotropic VECTOR gradient packed into
    (dW, e) so dW * e reproduces grad_W exactly."""
    pos_j, mask = gather(pos0, nl.idx)
    disp = pos0[:, None, :] - pos_j
    inside = kernel.within_cutoff(disp) & mask
    W = kernel.W_disp(disp, dim)
    gvec = kernel.grad_W(disp, dim)
    gnorm = jnp.linalg.norm(gvec, axis=-1)
    e = -gvec / (gnorm[..., None] + 1e-30)
    dW = -gnorm
    r = jnp.linalg.norm(disp, axis=-1)
    fm = inside.astype(pos0.dtype)
    return sd.ReferencePairs(idx=nl.idx, W=W * fm, dW=dW * fm, r=r,
                             e=e * fm[..., None], mask=fm)


def build_case(dy: float = PH / 10.0, dtype=jnp.float32, k_inner: int = 128):
    dx_big = RATIO * dy
    base = SPHAdaptation(spacing=dy, dim=2)
    kernel = AnisotropicKernel(base.kernel, (RATIO, 1.0))
    material = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)

    # anisotropic lattice (cpp ParticleGenerator<BaseParticles, Beam>)
    xs = np.arange(-SL + dx_big / 2, PL, dx_big)
    ys = np.arange(-PH / 2 + dy / 2, PH / 2, dy)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    vol = dx_big * dy

    solid = dict(sd.make_elastic_solid_state(pos, vol, material, dtype=dtype))

    # isotropic search with the anisotropic support's LONG radius, then
    # mask by the elliptical support inside freeze_anisotropic_pairs
    cutoff = kernel.kernel_size * base.h * RATIO
    lo = (-SL - 2 * dx_big, -PL / 2)
    hi = (PL + 2 * dx_big, PL / 2)
    grid = grid_from_bounds(lo, hi, cutoff)
    table = build_cell_table(solid["Position"], solid["NReal"], grid, cap=64)
    nl = build_neighbor_list(solid["Position"], solid["NReal"],
                             solid["Position"], solid["NReal"], table, grid,
                             cutoff, k_max=k_inner, include_self=False)
    assert not bool(nl.overflow), "raise k_inner: frozen pairs must be exact"
    rp = freeze_anisotropic_pairs(solid["Position"], nl, kernel, 2)

    # AnisotropicCorrectConfiguration (cpp:132-186): B = inv(-sum
    # (x_i - x_j) outer grad_W V_j), from the true displacements
    pos_j, _ = gather(solid["Position"], nl.idx)
    disp = solid["Position"][:, None, :] - pos_j
    gvec = (rp.dW * rp.mask)[..., None] * rp.e     # = grad_W, masked
    vol_j, _ = gather(solid["VolumetricMeasure"], nl.idx)
    A = -jnp.einsum("nki,nkj->nij", disp, gvec * vol_j[..., None])
    solid["LinearGradientCorrectionMatrix"] = jnp.linalg.inv(
        A + 1e-6 * jnp.eye(2, dtype=A.dtype))

    base_mask = jnp.asarray(pos[:, 0] <= 0.0)

    # first-mode initial velocity (cpp:96-115), beam part only
    x = pos[:, 0] / PL
    c0 = material.sound_speed
    vy = np.where(
        x > 0.0,
        VF * c0 * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                   - _N * (np.sin(KL * x) - np.sinh(KL * x))) / _Q,
        0.0)
    vel = np.zeros_like(pos)
    vel[:, 1] = vy
    solid["Velocity"] = jnp.asarray(vel, dtype)

    case = AnisoBeamCase(dx=dy, kernel=kernel, h=base.h, material=material,
                         rp=rp, base_mask=base_mask, n_solid=len(pos))
    sim = BeamSim(solid=solid, time=jnp.zeros((), dtype),
                  n_steps=jnp.zeros((), jnp.int32), dt=jnp.zeros((), dtype))
    return case, sim


def _step(case: AnisoBeamCase, s: BeamSim) -> BeamSim:
    w0 = case.kernel.W_disp(jnp.zeros((2,), jnp.float32), 2)
    solid = sd.integration_1st_half_pk2(s.solid, case.rp, case.material,
                                        s.dt, case.h, w0)
    solid = sd.fix_constraint(solid, case.base_mask)
    solid = sd.integration_2nd_half(solid, case.rp, s.dt)
    # time step from the SHORT axis spacing (scaling_factor, cpp:23)
    dt_next = sd.solid_acoustic_time_step(solid, case.material.sound_speed,
                                          case.h)
    return BeamSim(solid=solid, time=s.time + dt_next, n_steps=s.n_steps + 1,
                   dt=dt_next)


def make_run_chunk(case: AnisoBeamCase):
    @jax.jit
    def run_chunk(s: BeamSim, t_target) -> BeamSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def tip_displacement(case: AnisoBeamCase, s: BeamSim):
    pos0 = np.asarray(s.solid["InitialPosition"])[: case.n_solid]
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([PL, 0.0]), axis=1)))
    return float(s.solid["Position"][i, 1] - s.solid["InitialPosition"][i, 1])
