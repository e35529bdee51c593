"""3D twisting column (test_3d_twisting_column): the Kirchhoff-decomposed
integrator survives a violent initial twist and reproduces the reference
DB's axial tip oscillation envelope (x swings 3.21..9.64 from 5.94)."""

import pytest

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import twisting_column_3d as tw

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_twisting_column_tip_oscillation_envelope():
    case, column = tw.build_case()
    s = tw.init_sim(case, column)
    idx, w = tw.tip_observer(case, column)
    run = tw.make_run_chunk(case)

    x0 = tw.observe_tip(s, idx, w)[0]
    assert abs(x0 - 5.9397) < 0.05, x0   # DB snapshot 0

    xs = []
    for i in range(1, 26):
        s = run(s, jnp.asarray(i * 0.02, s.time.dtype))
        assert not bool(s.overflow)
        tip = tw.observe_tip(s, idx, w)
        xs.append(tip[0])
        assert np.all(np.isfinite(s.column["Position"]))

    # reference DB envelope over t=0..0.5: max 9.638, min 3.210
    assert 9.0 < max(xs) < 10.2, max(xs)
    assert 2.8 < min(xs) < 3.8, min(xs)
    # the holder holds: clamped end stays put
    holder = np.asarray(s.column["Position"])[np.asarray(case.holder_mask)]
    assert np.abs(holder[:, 0] + case.dx / 2).max() < 1e-3
