"""Non-Newtonian lid-driven cavity case test
(test_2d_lid_driven_cavity_non_newtonian counterpart)."""

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import lid_driven_cavity_2d as cav
from sphinxsys_jax.physics import viscosity as vc


def test_cavity_shear_thinning_flow_develops():
    case, fluid = cav.build_case(dx=0.05)
    s = cav.init_sim(case, fluid)
    run = cav.make_run_chunk(case)
    s = run(s, jnp.asarray(1.5, s.time.dtype))
    assert not bool(s.overflow)

    f = s.fluid
    pos = np.asarray(f["Position"])
    vel = np.asarray(f["Velocity"])
    speed = np.linalg.norm(vel, axis=1)
    # fluid just under the lid is dragged in +x, nothing exceeds lid speed
    top = pos[:, 1] > 0.93
    assert vel[top, 0].mean() > 0.08
    assert speed.max() < 1.2 * cav.U_LID
    # weakly compressible: density stays near rho0
    rho = np.asarray(f["Density"])
    assert abs(rho / cav.RHO0 - 1.0).max() < 0.05

    # the viscosity field spans shear-thinned values under the lid up to
    # the low-shear clamp in stagnant regions, within the model's bounds
    out = vc.update_variable_viscosity(f, s.nl_inner, case.kernel, 2,
                                       case.model)
    mu = np.asarray(out["VariableViscosity"])
    m = case.model
    mu_lo = float(m.viscosity(jnp.asarray(m.max_shear_rate)))
    mu_hi = float(m.viscosity(jnp.asarray(m.min_shear_rate)))
    assert mu.min() >= mu_lo - 1e-6 and mu.max() <= mu_hi + 1e-6
    assert mu.max() / mu.min() > 2.0  # genuinely non-Newtonian distribution
