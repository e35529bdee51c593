"""Solid<->shell tie coupling (physics/solid_shell.py) vs
/root/reference/src/shared/particle_dynamics/solid_dynamics/
solid_to_shell_coupling.{h,hpp} and test_3d_solid_to_shell_coupling.

The full dp_1 case settles at center deflection -0.452 by t = 40 (umax
3.8e-3 and falling) vs the reference oracle -0.46 +- 10%
(test_3d_solid_to_shell_coupling.cpp:255) — run via
benchmarks/run_solid_shell_validation.py; CI keeps a short-horizon
dynamics check plus exact mapping-property tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import solid_shell_coupling_3d as ssc
from sphinxsys_jax.physics import solid_shell as ss


@pytest.fixture(scope="module")
def built():
    return ssc.build_case()


def test_total_weight_positive_in_tied_region(built):
    """Shell particles under the cube footprint must have kernel support in
    the cube (tw > 0); the far shell wings must have none."""
    case, s = built
    tw = np.asarray(case.cp_shell.total_weight)
    x = np.asarray(s.shell["Position"][:, 0])
    under = np.abs(x) < 0.4 * ssc.CUBE_L
    far = np.abs(x) > 0.5 * ssc.CUBE_L + case.adaptation.cutoff
    assert (tw[under] > 1e-3).all()
    assert (tw[far] == 0.0).all()


def test_consistent_mapping_reproduces_constant_field(built):
    """Shepard interpolation (ConsistentMapping) is exact on constants:
    a uniform cube velocity maps to exactly that velocity on every tied
    shell particle; untied particles keep their current value."""
    case, s = built
    v = jnp.tile(jnp.asarray([0.3, -1.2, 0.7]), (case.n_cube, 1))
    cur = jnp.full((case.n_shell, 3), 9.9)
    out = np.asarray(ss.consistent_mapping(case.cp_shell, v, cur,
                                           part_mask=case.shell_tied_part))
    tied = np.asarray((case.cp_shell.total_weight > ss.TINY)
                      & case.shell_tied_part)
    np.testing.assert_allclose(out[tied],
                               np.tile([0.3, -1.2, 0.7], (tied.sum(), 1)),
                               rtol=1e-12)
    np.testing.assert_allclose(out[~tied], 9.9)


def test_conservative_mapping_conserves_total_force(built):
    """ConservativeMapping distributes each tied shell particle's force
    over the cube in proportion to Shepard weight shares: the cube-side
    total equals the total force on shell particles WITH tie support
    (Newton's third law of the tie)."""
    case, s = built
    rng = np.random.default_rng(0)
    f_shell = jnp.asarray(rng.normal(size=(case.n_shell, 3)))
    f_cube = ss.conservative_mapping(case.cp_cube,
                                     s.cube["VolumetricMeasure"],
                                     case.cp_shell.total_weight, f_shell)
    # shell particles whose force is reachable from the cube: tw > tiny
    tied = case.cp_shell.total_weight > ss.TINY
    total_shell = jnp.sum(jnp.where(tied[:, None], f_shell, 0.0), axis=0)
    # the cube side recovers that total as long as every tied shell
    # particle's support is fully covered by cube particles (interior tie)
    np.testing.assert_allclose(np.asarray(jnp.sum(f_cube, axis=0)),
                               np.asarray(total_shell), rtol=2e-2)


def test_coupled_dynamics_short_horizon(built):
    """dp_1 dynamics to t=2: the cube loads the shell downward, the clamped
    ends hold, and the first-swing deflection is on the reference scale
    (the full settle to -0.452 vs ref -0.46 runs in
    benchmarks/run_solid_shell_validation.py)."""
    case, s0 = built
    run = ssc.make_run_chunk(case)
    s = run(s0, 2.0)
    assert np.isfinite(np.asarray(s.cube["Velocity"])).all()
    assert np.isfinite(np.asarray(s.shell["Position"])).all()
    defl = ssc.center_deflection(case, s)
    assert -1.0 < defl < -0.1          # downward, bounded first swing
    # clamped shell ends have not moved
    fixed = np.asarray(case.shell_fixed)
    dp = np.asarray(s.shell["Position"] - s.shell["InitialPosition"])
    assert np.abs(dp[fixed]).max() < 1e-12
    # the cube rides the shell: its base stays near the deflected
    # mid-surface, not fallen through (tie, not contact)
    base_y = float(np.asarray(s.cube["Position"])[:, 1].min())
    assert base_y > -1.0
    assert ssc.u_max(s) < 3.0
