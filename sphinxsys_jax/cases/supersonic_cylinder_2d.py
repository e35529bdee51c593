"""Mach-2 supersonic flow around a cylinder (compressible Eulerian, HLLC).

Counterpart of tests/2d_examples/test_2d_eulerian_supersonic_flow_new_BC/
2d_eulerian_supersonic_flow_around_cylinder.{h,cpp}: ideal gas gamma = 1.4,
rho_farfield = 1, p_farfield = 1/gamma (so c = 1), Mach 2 freestream,
reflective (slip) cylinder wall, characteristic far-field boundary
(supersonic inflow imposes the freestream, outflow copies), HLLC fluxes
(EulerianCompressibleIntegration1st/2ndHalfHLLCWithLimiterRiemann).

Runs on the FVM O-grid front end (the reference uses body-fitted Eulerian
SPH particles on a half annulus; the conservative face-flux form on the
same geometry is the FVM-native equivalent — fvm/dynamics.py
compressible_step).

Physics oracle: the steady bow shock.  Normal-shock + isentropic
stagnation relations at M = 2, gamma = 1.4 give density ratio 2.667 across
the shock and a stagnation density of ~3.1 rho_inf at the cylinder nose.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.materials import CompressibleFluid
from sphinxsys_jax.fvm import compile_mesh, cylinder_ogrid
from sphinxsys_jax.fvm import dynamics as fv

GAMMA = 1.4
RHO_FAR = 1.0
P_FAR = 1.0 / GAMMA          # c_far = sqrt(gamma p / rho) = 1
MACH = 2.0
R_CYL = 1.0
R_FAR = 11.0                 # calculation_circle_radius (h:14)


class SimState(NamedTuple):
    fluid: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class SupersonicCase:
    dm: fv.DeviceMesh
    gas: CompressibleFluid
    far: fv.FarField
    mesh: Any

    def __hash__(self):
        return hash(self.dm)

    def __eq__(self, other):
        return self is other


def build_case(nr: int = 40, nt: int = 120, dtype=jnp.float32):
    raw = cylinder_ogrid(r0=R_CYL, r1=R_FAR, nr=nr, nt=nt)
    mesh = compile_mesh(raw)
    dm = fv.to_device(mesh, dtype)
    gas = CompressibleFluid(gamma=GAMMA)
    far = fv.FarField(rho=RHO_FAR, vel=(MACH * 1.0, 0.0), p=P_FAR)
    case = SupersonicCase(dm=dm, gas=gas, far=far, mesh=mesh)
    fluid = fv.make_compressible_fvm_state(dm, gas, RHO_FAR,
                                           (MACH * 1.0, 0.0), P_FAR, dtype)
    return case, fluid


def init_sim(case: SupersonicCase, fluid) -> SimState:
    dtype = fluid["Density"].dtype
    return SimState(fluid=fluid, time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32))


def make_run_chunk(case: SupersonicCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        def body(st):
            dt = fv.compressible_time_step_fvm(st.fluid, case.gas, case.dm)
            f = fv.compressible_step(st.fluid, case.dm, case.gas, case.far, dt)
            return SimState(fluid=f, time=st.time + dt,
                            n_steps=st.n_steps + 1)

        return jax.lax.while_loop(lambda st: st.time < t_target, body, s)

    return run_chunk


def stagnation_state(case: SupersonicCase, s: SimState):
    """Density/pressure at the windward nose cell (x ~ -R, y ~ 0)."""
    c = case.mesh.centroids
    nose = int(np.argmin(np.linalg.norm(c - np.asarray([-R_CYL - 0.05, 0.0]),
                                        axis=1)))
    return (float(s.fluid["Density"][nose]),
            float(s.fluid["Pressure"][nose]))


def cells_as_body(case: SupersonicCase, s: SimState) -> dict:
    return {"Position": jnp.asarray(case.mesh.centroids,
                                    s.fluid["Density"].dtype),
            "Density": s.fluid["Density"],
            "Velocity": s.fluid["Velocity"],
            "Pressure": s.fluid["Pressure"],
            "NReal": jnp.asarray(case.dm.n_cells, jnp.int32)}
