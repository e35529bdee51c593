"""3D Taylor bar impact — updated-Lagrangian J2 plasticity with
hourglass control.

Counterpart of /root/reference/tests/3d_examples/test_3d_taylor_bar_UL/
(taylor_bar_UL.h / .cpp): an aluminium cylinder (J2Plasticity, yield
0.29 GPa) hits a rigid holder wall at 373 m/s.  Loop structure
(taylor_bar_UL.cpp:125-157): outer advection step (volume update + cell
lists + current-configuration correction matrix), inner acoustic loop of
  wall contact force -> pressure relaxation (UL 1st half) ->
  J2 shear stress (hourglass 1st half) -> shear acceleration
  (hourglass 2nd half) -> density relaxation (dissipative Riemann).

Reference deviations (documented):
  * the reference's DynamicContactForceWithWall accumulates into
    ForcePrior raw each acoustic step (no previous-force subtraction,
    taylor_bar_UL.h:131) — mirrored exactly;
  * the reference freezes contact r_ij/dW at the advection-step build;
    we recompute them from current positions (strictly more accurate,
    second-order at these step sizes);
  * the reference default reloads relaxed particles
    (setReloadParticles(true)); we lattice-start.

Regression target: Column_TotalKineticEnergy DTW database
(regression_test_tool/, 60 snapshots over 6e-5 s, KE_0 = 209.6 J).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import contact as ct
from sphinxsys_jax.physics import continuum as cn
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs

PL = 0.00391                 # column radius
PW = 0.02346                 # column height
DX_REF = PL / 12.0
SL = 4.0 * DX_REF            # holder thickness
RHO0 = 2700.0
POISSON = 0.3
YOUNGS = 78.2e9
YIELD = 0.29e9
VEL0 = 373.0
C0 = math.sqrt(YOUNGS / (3.0 * (1.0 - 2.0 * POISSON) * RHO0))


class SimState(NamedTuple):
    column: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TaylorBarCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: cn.J2Plasticity
    eos: WeaklyCompressibleFluid
    riemann_p: Any
    riemann_rho: Any
    wall: Any
    wall_table: Any
    n: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX_REF, dtype=jnp.float32, cell_cap: int = 40,
               k_inner: int = 96, k_wall: int = 40):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = cn.J2Plasticity(rho0=RHO0, c0=C0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON, yield_stress=YIELD)
    eos = WeaklyCompressibleFluid(rho0=RHO0, c0=C0)

    # column lattice: cylinder axis z, z in [dx, PW + dx]
    # (TriangleMeshShapeCylinder halflength 0.5 PW at z = 0.5 PW + dx)
    xs = np.arange(-PL + dx / 2, PL, dx)
    zs = np.arange(dx + dx / 2, PW + dx, dx)
    gx, gy, gz = np.meshgrid(xs, xs, zs, indexing="ij")
    pos = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    pos = pos[np.hypot(pos[:, 0], pos[:, 1]) < PL]
    n = len(pos)

    column = cn.make_ul_solid_state(pos, dx ** 3, material, dtype=dtype)
    column["InitialPosition"] = column["Position"]
    column["HardeningFactor"] = jnp.zeros((n,), dtype)
    # registered up-front (continuum_integration.cpp:73); overwritten by the
    # J2 1st half each acoustic step before the 2nd half reads it
    column["ScalePenaltyForce"] = jnp.zeros((n,), dtype)
    vel = np.zeros_like(pos)
    vel[:, 2] = -VEL0
    column["Velocity"] = jnp.asarray(vel, dtype)

    # holder wall: brick x,y in [-3PL, 3PL], z in [-SL, 0]; static, with
    # outward surface normals from the nearest face (contact only ever
    # sees the top face, n = +z, unless the mushroom overruns 3 PL)
    xw = np.arange(-3 * PL + dx / 2, 3 * PL, dx)
    zw = np.arange(-SL + dx / 2, 0.0, dx)
    gx, gy, gz = np.meshgrid(xw, xw, zw, indexing="ij")
    pw = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    wall = {
        "Position": jnp.asarray(pw, dtype),
        "Velocity": jnp.zeros((len(pw), 3), dtype),
        "VolumetricMeasure": jnp.full((len(pw),), dx ** 3, dtype),
        "NReal": jnp.int32(len(pw)),
    }
    d_top = -pw[:, 2]
    d_side = 3 * PL - np.maximum(np.abs(pw[:, 0]), np.abs(pw[:, 1]))
    nrm = np.zeros_like(pw)
    side = d_side < d_top
    nrm[~side, 2] = 1.0
    sx = np.abs(pw[:, 0]) >= np.abs(pw[:, 1])
    nrm[side & sx, 0] = np.sign(pw[side & sx, 0])
    nrm[side & ~sx, 1] = np.sign(pw[side & ~sx, 1])
    wall["NormalDirection"] = jnp.asarray(nrm, dtype)

    lo = (-4.0 * PL, -4.0 * PL, -SL - 2 * dx)
    hi = (4.0 * PL, 4.0 * PL, 1.2 * PW)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    wall_table = jax.jit(lambda p: build_cell_table(
        p, jnp.int32(len(pw)), grid, cap=cell_cap))(wall["Position"])

    case = TaylorBarCase(dx=dx, adaptation=adaptation, grid=grid,
                         material=material, eos=eos,
                         riemann_p=rs.no_riemann(eos),
                         riemann_rho=rs.dissipative_riemann(eos),
                         wall=wall, wall_table=wall_table, n=n,
                         cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, column


def init_sim(case: TaylorBarCase, column: State) -> SimState:
    return SimState(column=column,
                    time=jnp.zeros((), column["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _acoustic_step(case: TaylorBarCase, col: State, nl, nl_cw, dt) -> State:
    kernel, dim = case.kernel, 3
    # contact first (taylor_bar_UL.cpp:146) — raw ForcePrior accumulation
    col = ct.dynamic_contact_force_with_wall(col, case.wall, nl_cw, kernel,
                                             dim, case.material,
                                             spacing_solid=case.dx,
                                             spacing_wall=case.dx)
    col = fd.acoustic_step_1st_half(col, nl, kernel, dim, case.eos,
                                    case.riemann_p, dt,
                                    extra_force=cn.ul_shear_force(col))
    col = cn.shear_stress_hourglass_1st_half(col, nl, kernel, dim,
                                             case.material, dt,
                                             plasticity=case.material)
    col = cn.shear_acceleration_hourglass_2nd_half(col, nl, kernel, dim,
                                                   case.material, dt)
    col = fd.acoustic_step_2nd_half(col, nl, kernel, dim, case.riemann_rho,
                                    dt)
    return col


def _advection_step(case: TaylorBarCase, s: SimState) -> SimState:
    col = cn.volume_update(s.column)
    table = build_cell_table(col["Position"], col["NReal"], case.grid,
                             cap=case.cell_cap)
    nl = build_neighbor_list(col["Position"], col["NReal"],
                             col["Position"], col["NReal"], table,
                             case.grid, case.adaptation.cutoff,
                             k_max=case.k_inner, include_self=False)
    nl_cw = build_neighbor_list(col["Position"], col["NReal"],
                                case.wall["Position"],
                                jnp.int32(len(case.wall["Position"])),
                                case.wall_table, case.grid,
                                case.adaptation.cutoff, k_max=case.k_wall,
                                include_self=True)
    col = cn.correction_matrix_current(col, nl, case.kernel, 3, alpha=0.0)

    adv_dt = fd.advection_time_step(col, case.adaptation.h, VEL0, cfl=0.2)

    def cond(carry):
        _, t_rel = carry
        return t_rel < adv_dt

    def body(carry):
        c, t_rel = carry
        dt = jnp.minimum(
            fd.acoustic_time_step(c, case.eos, case.adaptation.h, cfl=0.4),
            adv_dt - t_rel)
        c = _acoustic_step(case, c, nl, nl_cw, dt)
        return (c, t_rel + dt)

    col, t_rel = jax.lax.while_loop(cond, body, (col, jnp.zeros_like(adv_dt)))
    return SimState(column=col, time=s.time + t_rel, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow | nl_cw.overflow)


def make_run_chunk(case: TaylorBarCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def kinetic_energy(s: SimState) -> float:
    """Column_TotalKineticEnergy (general_reduce.h TotalKineticEnergy)."""
    c = s.column
    n = c["Position"].shape[0]
    valid = jnp.arange(n) < c["NReal"]
    ke = 0.5 * c["Mass"] * jnp.sum(c["Velocity"] ** 2, axis=-1)
    return float(jnp.sum(jnp.where(valid, ke, 0.0)))


def mushroom_radius(case: TaylorBarCase, s: SimState) -> float:
    """Max radial extent of the bottom layers (the plastic mushroom)."""
    c = s.column
    near_base = c["Position"][:, 2] < 2.5 * case.dx + 0.05 * PW
    r = jnp.hypot(c["Position"][:, 0], c["Position"][:, 1])
    return float(jnp.max(jnp.where(near_base, r, 0.0)))


def build_case_ci(dx: float = PL / 6.0, **kw):
    """Coarse CI resolution (≈ 6.7k particles incl. the holder)."""
    return build_case(dx=dx, **kw)
