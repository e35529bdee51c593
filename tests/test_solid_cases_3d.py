"""3D solid case-family tests: NeoHookean gravity cantilever (vs the
reference's committed Observer DB) and prescribed muscle activation.

References:
  /root/reference/tests/3d_examples/test_3d_passive_cantilever_neohookean/
  /root/reference/tests/3d_examples/test_3d_muscle_activation/
"""

import pytest

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.io.regression import read_result_xml

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

REF_NEO_DB = ("/root/reference/tests/3d_examples/"
              "test_3d_passive_cantilever_neohookean/regression_test_tool/"
              "CantileverObserver_Position_Run_0_result.xml")


def test_neohookean_cantilever_tracks_reference_db():
    """Gravity droop of the corner observer: first minimum and settled
    value vs the reference DB (101 snapshots over t=1)."""
    from sphinxsys_jax.cases import passive_cantilever_neohookean_3d as nc

    ref = np.asarray(read_result_xml(REF_NEO_DB))[0]  # (101, 3)
    ref_y = ref[:, 1]
    ref_min = ref_y.min()              # ~ -0.00117 around t ~ 0.17
    ref_settled = ref_y[-1]            # ~ 0.00382

    case, body = nc.build_case(dtype=jnp.float64)
    s = nc.init_sim(case, body)
    run = nc.make_run_chunk(case)
    idx, w = nc.corner_observer(case, body)

    ys = [nc.observe_corner(s, idx, w)[1]]
    for i in range(1, 51):
        s = run(s, jnp.asarray(i * 0.02, s.time.dtype))
        ys.append(nc.observe_corner(s, idx, w)[1])
    ys = np.asarray(ys)
    assert np.isfinite(ys).all()

    droop0 = ref_y[0] - ref_min
    # overshoot minimum within 15% of the total droop
    assert abs(ys.min() - ref_min) < 0.15 * droop0, (ys.min(), ref_min)
    # settled (t=1) within 10% of the droop of the reference settled point
    assert abs(ys[-1] - ref_settled) < 0.10 * droop0, (ys[-1], ref_settled)
    # damping actually settles the oscillation: late window nearly constant
    assert np.ptp(ys[40:]) < 0.1 * droop0


def test_muscle_activation_pushes_fiber():
    """Negative fiber Ta ramp (compressive active stress): free face
    displaces in +x, y/z symmetric, displacement grows during the ramp
    (muscle_activation.cpp oracle)."""
    from sphinxsys_jax.cases import muscle_activation_3d as ma

    case, body = ma.build_case(dx=1.0 / 12.0)
    s = ma.init_sim(case, body)
    run = ma.make_run_chunk(case)
    x0 = ma.free_end_x(s)

    s = run(s, jnp.asarray(0.6, s.time.dtype))
    x_mid = ma.free_end_x(s)
    s = run(s, jnp.asarray(1.2, s.time.dtype))
    x_end = ma.free_end_x(s)

    assert np.isfinite(np.asarray(s.body["Position"])).all()
    # elongation: free end pushed away from the holder, growing with the ramp
    assert x_mid > x0 + 0.005, (x0, x_mid)
    assert x_end > x_mid + 0.005, (x_mid, x_end)
    # transverse symmetry: mean y/z of the free face stays centered
    pos = np.asarray(s.body["Position"])
    face = np.asarray(s.body["InitialPosition"][:, 0]) > 1.0 - case.dx
    assert abs(pos[face, 1].mean() - 0.5) < 0.02
    assert abs(pos[face, 2].mean() - 0.5) < 0.02
    # holder fixed in x: holder particles did not translate along fiber
    hm = np.asarray(case.holder_mask)
    dx_holder = pos[hm, 0] - np.asarray(s.body["InitialPosition"])[hm, 0]
    assert np.abs(dx_holder).max() < 1e-6
