"""Double Mach reflection of a Mach-10 shock (compressible FVM, HLLC).

Counterpart of tests/2d_examples/test_2d_FVM_double_mach_reflection/
2d_FVM_double_mach_reflection.{h,cpp}: domain [0,4]x[0,1], gamma = 1.4,
a Mach-10 shock inclined 60 degrees starting at x = 1/6 on the floor.
Pre-shock state (rho, u, v, p) = (1.4, 0, 0, 1); post-shock state
(8, 8.25 sin60, -8.25 cos60, 140.2/1.2) (h:23-30).  Boundary conditions
(DMFBoundaryConditionSetup, h:104-180):
  left           post-shock inflow (given value)
  right          zero-gradient outflow
  bottom x<1/6   post-shock inflow;  bottom x>=1/6  reflective wall
  top            exact traveling-shock state: post-shock where
                 y > tan60 (x - x_s(t)), x_s = 1/6 + 10 t / sin60
Run to end_time = 0.2 (cpp:64).

The reference runs this on a shipped triangular Fluent mesh with its
1st-order HLLC; here the structured quad strip + MUSCL second order.
Oracle: the self-similar reflection pattern — shock-position at the wall,
density bounds (max compression < gamma+1/gamma-1 * post-shock ~ limited),
and the characteristic density peak under the Mach stem.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.materials import CompressibleFluid
from sphinxsys_jax.fvm import dynamics as fv
from sphinxsys_jax.fvm.mesh import compile_mesh
from sphinxsys_jax.fvm.meshgen import rect_grid

DL, DH = 4.0, 1.0
GAMMA = 1.4
RHO_PRE, P_PRE = 1.4, 1.0
RHO_POST = 8.0
U_POST = 8.25 * math.sin(math.pi / 3.0)
V_POST = -8.25 * math.cos(math.pi / 3.0)
P_POST = 140.2 / 1.2
X0 = 1.0 / 6.0
TAN60 = math.tan(math.pi / 3.0)
SHOCK_SPEED_X = 10.0 / math.sin(math.pi / 3.0)
E_PRE = P_PRE / (GAMMA - 1.0)
E_POST = P_POST / (GAMMA - 1.0) + 0.5 * RHO_POST * (U_POST ** 2 + V_POST ** 2)


class SimState(NamedTuple):
    fluid: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DMRCase:
    dm: fv.DeviceMesh
    gas: CompressibleFluid
    mesh: Any
    muscl: bool

    def __hash__(self):
        return hash((self.dm, self.muscl))

    def __eq__(self, other):
        return self is other


def _ghosts(l, r, dm, t):
    """DMFBoundaryConditionSetup: per-boundary-face ghost states selected
    by face-midpoint position (the mesh tags all boundaries alike)."""
    rho_l, vel_l, p_l, E_l = l
    rho_r, vel_r, p_r, E_r = r
    x, y = dm.midpoint[:, 0], dm.midpoint[:, 1]
    b = ~dm.interior
    eps = 1e-6

    post_vel = jnp.asarray([U_POST, V_POST], vel_l.dtype)

    def set_state(sel, rho_v, vel_v, p_v, E_v, cur):
        rho_c, vel_c, p_c, E_c = cur
        return (jnp.where(sel, rho_v, rho_c),
                jnp.where(sel[:, None], vel_v, vel_c),
                jnp.where(sel, p_v, p_c),
                jnp.where(sel, E_v, E_c))

    cur = (rho_r, vel_r, p_r, E_r)
    # left + bottom x < 1/6: post-shock inflow
    inflow = b & ((x < eps) | ((y < eps) & (x < X0)))
    cur = set_state(inflow, RHO_POST, post_vel[None, :], P_POST, E_POST, cur)
    # right: outflow copy
    out = b & (x > DL - eps)
    cur = set_state(out, rho_l, vel_l, p_l, E_l, cur)
    # bottom x >= 1/6: reflective wall (mirror normal velocity)
    wall = b & (y < eps) & (x >= X0)
    vn = jnp.sum(vel_l * dm.normal, axis=-1, keepdims=True)
    cur = set_state(wall, rho_l, vel_l - 2.0 * vn * dm.normal, p_l, E_l, cur)
    # top: exact traveling shock
    top = b & (y > DH - eps)
    x_s = X0 + t * SHOCK_SPEED_X
    post_side = y > TAN60 * (x - x_s)
    cur = set_state(top & post_side, RHO_POST, post_vel[None, :], P_POST,
                    E_POST, cur)
    pre_vel = jnp.zeros_like(vel_l)
    cur = set_state(top & ~post_side, RHO_PRE, pre_vel, P_PRE, E_PRE, cur)
    return cur


def build_case(nx: int = 480, ny: int = 120, dtype=jnp.float32,
               muscl: bool = True):
    mesh = compile_mesh(rect_grid(nx, ny, DL, DH, btype_x=9, btype_y=9))
    dm = fv.to_device(mesh, dtype)
    gas = CompressibleFluid(gamma=GAMMA)
    case = DMRCase(dm=dm, gas=gas, mesh=mesh, muscl=muscl)

    # initial condition: post-shock above the inclined front (h:62-99)
    c = mesh.centroids
    post = c[:, 1] > TAN60 * (c[:, 0] - X0)
    rho = np.where(post, RHO_POST, RHO_PRE)
    p = np.where(post, P_POST, P_PRE)
    vel = np.where(post[:, None], np.asarray([U_POST, V_POST]), 0.0)
    E = p / (GAMMA - 1.0) + 0.5 * rho * np.sum(vel ** 2, -1)
    fluid = {"Density": jnp.asarray(rho, dtype),
             "Velocity": jnp.asarray(vel, dtype),
             "Pressure": jnp.asarray(p, dtype),
             "TotalEnergyDensity": jnp.asarray(E, dtype)}
    return case, fluid


def init_sim(case: DMRCase, fluid) -> SimState:
    dtype = fluid["Density"].dtype
    return SimState(fluid=fluid, time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32))


def make_run_chunk(case: DMRCase):
    step = fv.compressible_step_muscl if case.muscl else fv.compressible_step
    far = fv.FarField(rho=RHO_PRE, vel=(0.0, 0.0), p=P_PRE)  # unused default

    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        def body(st):
            dt = fv.compressible_time_step_fvm(st.fluid, case.gas, case.dm,
                                               cfl=0.25)
            f = step(st.fluid, case.dm, case.gas, far, dt,
                     ghost_override=_ghosts, t=st.time)
            return SimState(fluid=f, time=st.time + dt,
                            n_steps=st.n_steps + 1)

        return jax.lax.while_loop(lambda st: st.time < t_target, body, s)

    return run_chunk


def wall_shock_position(case: DMRCase, s: SimState) -> float:
    """x where the density first rises above 2x pre-shock along the
    bottom row (the Mach stem foot)."""
    c = case.mesh.centroids
    y_min = c[:, 1].min()
    bottom = c[:, 1] < y_min * 1.5 + 1e-12   # first cell row
    x = c[bottom, 0]
    rho = np.asarray(s.fluid["Density"])[bottom]
    order = np.argsort(x)
    x, rho = x[order], rho[order]
    above = rho > 2.0 * RHO_PRE
    if not above.any():
        return 0.0
    return float(x[np.nonzero(above)[0][-1]])
