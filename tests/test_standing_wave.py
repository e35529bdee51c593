"""Standing wave (test_2d_standing_wave): first-mode period vs the
finite-depth dispersion relation + wave-gauge machinery."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_standing_wave_period_matches_dispersion():
    """The gauge at the cos(pi x) antinode oscillates at
    T = 2 pi / sqrt(g k tanh(k h)) (measured 1.152 vs analytic 1.134 at
    dx=0.05 — 1.6%); amplitude stays bounded by the initial 0.1."""
    from sphinxsys_jax.cases import standing_wave_2d as sw

    case, fluid = sw.build_case(dx=0.05)
    s = sw.init_sim(case, fluid)
    run = sw.make_run_chunk(case)
    hs, ts = [], []
    for i in range(1, 31):
        s = run(s, jnp.asarray(i * 0.05, s.time.dtype))
        hs.append(float(sw.free_surface_height(case, s.fluid)))
        ts.append(float(s.time))
    assert not bool(s.overflow)
    hs = np.asarray(hs)
    ts = np.asarray(ts)
    assert np.isfinite(hs).all()
    # starts at the trough; first max ~ T/2, second min ~ T
    i_max = int(np.argmax(hs[: len(hs) // 2]))
    i_min2 = int(np.argmin(hs[i_max:])) + i_max
    period = ts[i_min2]
    assert abs(period - sw.T1) < 0.06 * sw.T1, (period, sw.T1)
    # bounded oscillation around the mean depth
    assert 0.85 < hs.min() < 0.95
    assert 1.02 < hs.max() < 1.15
