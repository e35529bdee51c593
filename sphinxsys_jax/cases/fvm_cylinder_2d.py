"""FVM flow around a cylinder (weakly-compressible, unstructured mesh).

Counterpart of tests/2d_examples/test_2d_FVM_flow_around_cylinder/
2d_FVM_flow_around_cylinder.cpp: rho0 = 1, U = 1, c = 10 U, Re = 100
(mu = rho U 2R / Re), acoustic Riemann fluxes with limiter 200, non-slip
cylinder wall (Fluent bc 3) + far-field boundary (bc 9); the regression
quantity is the total (viscous + pressure) force on the cylinder.

Mesh deviation: the reference loads a shipped Fluent channel mesh
(data/fluent_0.3.msh); we generate a cylinder O-grid, WRITE it in the same
Fluent format and parse it back through the front end — same pipeline a
user's own ANSYS mesh takes (fvm/mesh.py).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.fvm import (compile_mesh, cylinder_ogrid, read_fluent_msh,
                               write_fluent_msh)
from sphinxsys_jax.fvm import dynamics as fv
from sphinxsys_jax.physics import riemann as rs

RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
R_CYL = 1.0
MU_F = RHO0_F * U_F * (2.0 * R_CYL) / RE


class SimState(NamedTuple):
    fluid: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class FVMCylinderCase:
    dm: fv.DeviceMesh
    eos: WeaklyCompressibleFluid
    riemann: Any
    far: fv.FarField
    mesh: Any

    def __hash__(self):
        return hash(self.dm)

    def __eq__(self, other):
        return self is other


def build_case(nr: int = 48, nt: int = 96, r_far: float = 25.0,
               dtype=jnp.float32, via_msh_file: bool = True):
    raw = cylinder_ogrid(r0=R_CYL, r1=r_far, nr=nr, nt=nt)
    if via_msh_file:   # exercise the Fluent writer + parser round trip
        path = os.path.join(tempfile.mkdtemp(), "cylinder_ogrid.msh")
        write_fluent_msh(path, raw)
        raw = read_fluent_msh(path)
    mesh = compile_mesh(raw)
    dm = fv.to_device(mesh, dtype)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    p_far = float(eos.pressure(jnp.asarray(RHO0_F)))
    far = fv.FarField(rho=RHO0_F, vel=(U_F, 0.0), p=p_far)
    case = FVMCylinderCase(dm=dm, eos=eos,
                           riemann=rs.acoustic_riemann(eos, limiter_coeff=200.0),
                           far=far, mesh=mesh)
    fluid = fv.make_fvm_state(dm, RHO0_F, (U_F, 0.0), p_far, dtype)
    return case, fluid


def init_sim(case: FVMCylinderCase, fluid) -> SimState:
    dtype = fluid["Density"].dtype
    return SimState(fluid=fluid, time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32))


def make_run_chunk(case: FVMCylinderCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        def body(st):
            dt = fv.wc_acoustic_dt(st.fluid, case.eos, case.dm)
            f = fv.wc_integration_step(st.fluid, case.dm, case.eos,
                                       case.riemann, case.far, dt, mu=MU_F)
            return SimState(fluid=f, time=st.time + dt,
                            n_steps=st.n_steps + 1)

        return jax.lax.while_loop(lambda st: st.time < t_target, body, s)

    return run_chunk


def cylinder_force(case: FVMCylinderCase, s: SimState):
    """Total (pressure + viscous) force on the cylinder; drag coefficient
    Cd = Fx / (0.5 rho U^2 D)."""
    fp, fvisc = fv.force_on_boundary(s.fluid, case.dm, case.riemann,
                                     case.far, MU_F, boundary=3)
    return fp + fvisc


def drag_coefficient(case: FVMCylinderCase, s: SimState) -> float:
    f = cylinder_force(case, s)
    return float(f[0] / (0.5 * RHO0_F * U_F ** 2 * 2.0 * R_CYL))


def cells_as_body(case: FVMCylinderCase, s: SimState) -> dict:
    """Cell-centered fields as a pseudo-particle body for VTP output (the
    reference writes FVM results through BodyStatesRecordingInMeshToVtu;
    cell centroids as points is the particle-writer equivalent)."""
    return {"Position": jnp.asarray(case.mesh.centroids,
                                    s.fluid["Density"].dtype),
            "VolumetricMeasure": jnp.asarray(case.mesh.volumes,
                                             s.fluid["Density"].dtype),
            "Density": s.fluid["Density"],
            "Velocity": s.fluid["Velocity"],
            "Pressure": s.fluid["Pressure"],
            "NReal": jnp.asarray(case.dm.n_cells, jnp.int32)}
