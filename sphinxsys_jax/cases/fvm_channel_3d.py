"""3D FVM inviscid channel flow over a bump (ICEM tetrahedral mesh).

Mirrors /root/reference/tests/3d_examples/test_3d_FVM_incompressible_
channel_flow/ : a weakly-compressible inviscid flow through a channel
with a lower-wall bump, driven by a velocity inlet (bc 10, u = 1) against
a pressure outlet (bc 5, p = 100/117.6655), slip (reflective) walls
(bc 3) and symmetry faces (bc 7) — the ghost-state policy of
InvCFBoundaryConditionSetup (test_3d_FVM_incompressible_channel_flow.h:
85-121).  The mesh is the reference's shipped Channel_ICEM.msh (5143
tets), exercising the 3D face compilation (fvm/mesh.py).

The shipped reference DB for this case holds two inconsistent snapshots
(WaveBody_MaximumSpeed mean 8.25/13.3 with U = 1, c = 10 — physically
impossible for this flow), so validation is physics-based: steady mass
conservation through the bump section and the area-ratio speedup.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.fvm import dynamics as fv
from sphinxsys_jax.fvm.mesh import compile_mesh, read_fluent_msh
from sphinxsys_jax.physics import riemann as rs

RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
P0 = 50.0 / 117.6655
P_OUT = 100.0 / 117.6655

MESH_PATH = os.environ.get(
    "FVM3D_MESH",
    "/root/reference/tests/3d_examples/test_3d_FVM_incompressible_channel_flow"
    "/data/Channel_ICEM.msh")


class FVMSim(NamedTuple):
    state: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class Channel3DCase:
    dm: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    bc: fv.BCSpec
    far: fv.FarField


def build_case(mesh_path: str = MESH_PATH, dtype=jnp.float32):
    raw = read_fluent_msh(mesh_path)
    dm = fv.to_device(compile_mesh(raw), dtype=dtype)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    bc = fv.BCSpec(wall_slip=True, inlet_vel=(U_F, 0.0, 0.0), outlet_p=P_OUT)
    far = fv.FarField(rho=RHO0_F, vel=(U_F, 0.0, 0.0), p=P0)
    case = Channel3DCase(dm=dm, eos=eos, riemann=rs.acoustic_riemann(eos),
                         bc=bc, far=far)
    state = fv.make_fvm_state(dm, RHO0_F, (U_F, 0.0, 0.0), P0, dtype=dtype)
    return case, state


def init_sim(case: Channel3DCase, state) -> FVMSim:
    dtype = state["Pressure"].dtype
    return FVMSim(state=state, time=jnp.zeros((), dtype),
                  n_steps=jnp.zeros((), jnp.int32))


def make_run_chunk(case: Channel3DCase):
    @jax.jit
    def run_chunk(s: FVMSim, t_target) -> FVMSim:
        def body(c):
            st, t, k = c
            dt = fv.wc_acoustic_dt(st, case.eos, case.dm)
            st = fv.wc_integration_step(st, case.dm, case.eos, case.riemann,
                                        case.far, dt, bc=case.bc)
            return (st, t + dt, k + 1)

        st, t, k = jax.lax.while_loop(lambda c: c[1] < t_target, body,
                                      (s.state, s.time, s.n_steps))
        return FVMSim(state=st, time=t, n_steps=k)

    return run_chunk


def max_speed(s: FVMSim) -> float:
    return float(jnp.max(jnp.linalg.norm(s.state["Velocity"], axis=-1)))


def boundary_flux(case: Channel3DCase, s: FVMSim, btype: int) -> float:
    """Outward mass flux through one boundary type (inlet 10 / outlet 5)."""
    dm = case.dm
    (rho_l, vel_l, p_l), (rho_r, vel_r, p_r) = fv.face_states(
        s.state, dm, case.far, case.bc)
    from sphinxsys_jax.physics.eulerian import interface_state

    rho_s, vel_s, p_s = interface_state(case.riemann, rho_l, vel_l, p_l,
                                        rho_r, vel_r, p_r, -dm.normal)
    sel = ((dm.btype == btype) & ~dm.interior).astype(p_s.dtype)
    vn = jnp.sum(vel_s * dm.normal, axis=-1)
    return float(jnp.sum(sel * rho_s * vn * dm.area))
