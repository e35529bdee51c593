"""Half-sphere shell stability under tangential gravity.

Counterpart of /root/reference/tests/3d_examples/
test_3d_shell_stability_half_sphere/test_3d_shell_stability_half_sphere.cpp:
a hemispherical shell (R = 50 mm, thickness 1 mm, SaintVenantKirchhoff
rho = 1e3 kg/m^3, E = 5e7 Pa, nu = 0.3 — mm-unit scaled rho = 1e-6,
E = 50), equator edge clamped (ConstrainShellBodyRegion on z < 0.67 dp),
loaded by gravity g = -9.8066/1e-3 along X, with velocity + rotation
projection damping.  The test is a STABILITY gate: the curved-surface
shell (full double curvature, unlike roof_3d's cylinder sector) must run
to t = 0.5 with bounded displacement, no NaN, and no runaway time-step
collapse (dt never below max_dt/1e3), cpp:262-286.

The reference reads pre-relaxed CVT vertex files
(input/shell_sphere_half_*.txt); here the distribution is generated
in-framework: Fibonacci hemisphere seeding + tangential CVT relaxation
(core/surface_cvt.py), which reproduces the reference's initialization
gates (min pair distance > dp/2; total volume = total area, cpp:196-226).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.surface_cvt import (cvt_relax_on_surface,
                                            fibonacci_sphere,
                                            sphere_projector)
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import dissipation as dpp
from sphinxsys_jax.physics import shell as sh
from sphinxsys_jax.physics import solid as sd

UNIT_MM = 1e-3
RADIUS = 50.0
THICKNESS = 1.0
RHO0 = 1.0e3 * UNIT_MM ** 3
YOUNGS = 5.0e7 * UNIT_MM ** 2
POISSON = 0.3
GRAVITY_X = -9.8066 / UNIT_MM
END_TIME = 0.5


def physical_viscosity(shape_constant: float = 0.4) -> float:
    """get_physical_viscosity_general (cpp:96-103): beta/4 sqrt(rho E) L."""
    return shape_constant / 4.0 * math.sqrt(RHO0 * YOUNGS) * THICKNESS


class SphereSim(NamedTuple):
    shell: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray
    max_dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class SphereCase:
    dp: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl: Any
    edge_mask: jnp.ndarray
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dp_ratio: float = 2.0, dtype=jnp.float64,
               cvt_iters: int = 200):
    dp = dp_ratio * THICKNESS
    total_area = 0.5 * 4.0 * math.pi * RADIUS * RADIUS
    n = int(round(total_area / dp ** 2))

    seeds = fibonacci_sphere(n, RADIUS, hemisphere=True)
    pos, normals = cvt_relax_on_surface(
        seeds, sphere_projector(RADIUS, hemisphere=True), dp,
        n_iter=cvt_iters)
    particle_area = total_area / n

    adaptation = SPHAdaptation(spacing=dp, dim=3)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    shell = sh.make_shell_state(pos, normals, dp, THICKNESS, material,
                                dtype=dtype, volume=particle_area)

    cutoff = adaptation.cutoff
    pad = 5 * dp
    grid = grid_from_bounds((-RADIUS - pad,) * 3,
                            (RADIUS + pad, RADIUS + pad, RADIUS + pad),
                            cutoff)
    table = build_cell_table(shell["Position"], jnp.int32(n), grid, cap=32)
    nl = build_neighbor_list(shell["Position"], jnp.int32(n),
                             shell["Position"], jnp.int32(n), table, grid,
                             cutoff, k_max=48, include_self=False)
    assert not bool(nl.overflow)
    rp = sd.freeze_reference_pairs(shell["Position"], nl,
                                   sh.ReducedKernel(adaptation.kernel), 3)
    shell = sh.shell_correct_configuration(shell, rp)

    # constrained equator edge: z < 0.67 dp (cpp:166-173)
    edge_mask = jnp.asarray(pos[:, 2] < 0.67 * dp)

    case = SphereCase(dp=dp, adaptation=adaptation, material=material,
                      rp=rp, nl=nl, edge_mask=edge_mask, n_shell=n)
    sim = SphereSim(shell=shell, time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    dt=jnp.asarray(1e-6, dtype),
                    max_dt=jnp.asarray(0.0, dtype))
    return case, sim


def _constrain(shell, mask):
    """ConstrainShellBodyRegion: zero velocity AND angular velocity."""
    out = dict(shell)
    out["Velocity"] = jnp.where(mask[:, None], 0.0, shell["Velocity"])
    out["AngularVelocity"] = jnp.where(mask[:, None], 0.0,
                                       shell["AngularVelocity"])
    return out


def _step(case: SphereCase, s: SphereSim) -> SphereSim:
    h = case.adaptation.h
    dt = s.dt
    shell = dict(s.shell)

    grav = jnp.zeros_like(shell["Velocity"])
    grav = grav.at[:, 0].set(shell["Mass"] * GRAVITY_X)
    shell["ForcePrior"] = grav

    shell = sh.shell_stress_relaxation_1st_half(shell, case.rp,
                                                case.material, dt, h)
    shell = _constrain(shell, case.edge_mask)
    eta = physical_viscosity() / 0.2   # DampingWithRandomChoice(0.2)
    shell = dpp.damping_projection(shell, "Velocity", case.nl, case.kernel,
                                   3, eta, dt)
    shell = dpp.damping_projection(shell, "AngularVelocity", case.nl,
                                   case.kernel, 3, eta, dt)
    shell = _constrain(shell, case.edge_mask)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp, dt)

    dt_next = sh.shell_acoustic_time_step(shell, case.material, h)
    return SphereSim(shell=shell, time=s.time + dt, n_steps=s.n_steps + 1,
                     dt=dt_next, max_dt=jnp.maximum(s.max_dt, dt_next))


def make_run_chunk(case: SphereCase):
    @jax.jit
    def run_chunk(s: SphereSim, t_target) -> SphereSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def max_displacement(s: SphereSim) -> float:
    """VariableNorm<Vecd, ReduceMax> on Displacement (cpp:185)."""
    d = np.asarray(s.shell["Position"]) - np.asarray(
        s.shell["InitialPosition"])
    return float(np.linalg.norm(d, axis=1).max())
