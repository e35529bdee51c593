"""Multi-resolution Taylor-Green (cases/taylor_green_mr_2d.py): the
adaptive-h DYNAMIC fluid loop — multi-level neighbor rebuild every step,
all ops at per-particle smoothing lengths."""

import pytest

import math

import jax
import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_mr_taylor_green_decay():
    from sphinxsys_jax.cases import taylor_green_mr_2d as tg

    case, fluid = tg.build_case()
    hr = np.asarray(fluid["SmoothingLengthRatio"])
    assert hr.max() == 2.0 and hr.min() == 1.0       # mixed resolutions
    assert ((hr > 1.0) & (hr < 2.0)).any()           # smooth transition band
    vols = np.asarray(fluid["VolumetricMeasure"])
    assert vols.min() < 0.3 * vols.max()             # refined volumes

    s = tg.init_sim(case, fluid)
    run = tg.make_run_chunk(case)
    v0 = tg.max_speed(s)
    for i in range(1, 5):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        v = tg.max_speed(s)
        exact = v0 * math.exp(-8 * math.pi ** 2 * tg.MU_F * float(s.time))
        # the mixed-resolution field must follow the analytic viscous
        # decay — interface inconsistencies show up as growth or spurious
        # damping (measured ratios 0.93-1.03)
        assert 0.82 < v / exact < 1.12, f"t={float(s.time)}: {v} vs {exact}"
    assert not bool(s.overflow)
    assert np.isfinite(np.asarray(s.fluid["Pressure"])).all()
