"""3D passive cantilever (test_3d_passive_cantilever): anisotropic Muscle
whip vs the reference DB's first full swing (its committed Run_0 peaks at
(3.87, 4.155, 2.794) at t=0.42 and returns to (6.028, 0.011, 0.310) at
t=1.0)."""

import pytest

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import passive_cantilever_3d as pc

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_passive_cantilever_first_swing_matches_reference_db():
    case, body = pc.build_case()
    s = pc.init_sim(case, body)
    idx, w = pc.corner_observer(case, body)
    run = pc.make_run_chunk(case)

    obs0 = pc.observe_corner(s, idx, w)
    assert np.allclose(obs0, [5.9498, 0.9498, 0.9498], atol=0.005), obs0

    peak_y = -1.0
    peak = None
    for i in range(1, 21):
        s = run(s, jnp.asarray(i * 0.05, s.time.dtype))
        assert not bool(s.overflow)
        tip = pc.observe_corner(s, idx, w)
        assert np.all(np.isfinite(np.asarray(s.body["Position"])))
        if tip[1] > peak_y:
            peak_y, peak = tip[1], tip

    # first-swing apex (DB: y=4.155, z=2.794 at t=0.42)
    assert abs(peak[1] - 4.155) < 0.15, peak
    assert abs(peak[2] - 2.794) < 0.15, peak

    # return swing at t=1.0 (DB: (6.028, 0.011, 0.310))
    tip = pc.observe_corner(s, idx, w)
    assert np.allclose(tip, [6.028, 0.011, 0.310], atol=0.12), tip
