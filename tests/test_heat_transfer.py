"""Thermal channel flow (cases/heat_transfer_2d.py) vs
/root/reference/tests/2d_examples/test_2d_heat_transfer.

CI runs the short horizon; the full-horizon observer curve vs the
reference's ensemble DB lives in tests/test_refdb_parity.py (committed
curve from benchmarks/run_refdb_parity.py heat_transfer)."""

import pytest

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import heat_transfer_2d as ht

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_thermal_boundary_layer_grows_from_hot_wall():
    case, fluid = ht.build_case()
    s = ht.init_sim(case, fluid)
    run = ht.make_run_chunk(case)
    s = run(s, jnp.asarray(0.75, s.time.dtype))
    assert not bool(s.overflow)
    f = s.fluid
    valid = np.arange(f["Position"].shape[0]) < int(f["NReal"])
    phi = np.asarray(f["Phi"])[valid]
    # bounded by the wall temperatures
    assert phi.min() >= ht.PHI_UPPER_WALL - 1e-3
    assert phi.max() <= ht.PHI_LOWER_WALL + 1e-3

    ys, prof = ht.phi_profile(case, s)
    # monotone decreasing mean profile (hot wall below, cold above)
    assert np.all(np.diff(prof) < 1e-6)
    # conduction layer has entered the first rows but not the centerline
    assert prof[0] > 30.0
    assert abs(prof[len(prof) // 2] - ht.PHI_FLUID_INITIAL) < 0.05
    # the reference observer at (0, DH/2) is still at ~20 this early
    # (its DB: 20.0000013 at t=0.75)
    assert abs(ht.observe_phi(case, s) - 20.0) < 0.01

    # ramped parabolic inflow: max streamwise velocity in the sponge is
    # 1.5 * u_ave(t) at the centerline
    pos = np.asarray(f["Position"])[valid]
    u = np.asarray(f["Velocity"])[valid]
    in_buf = pos[:, 0] < 0.0
    u_ave = 0.5 * ht.U_F * (1.0 - np.cos(np.pi * 0.75 / ht.T_RAMP))
    center = in_buf & (np.abs(pos[:, 1] - 0.2) < 2 * case.dx)
    np.testing.assert_allclose(u[center, 0].max(), 1.5 * u_ave, rtol=0.15)
