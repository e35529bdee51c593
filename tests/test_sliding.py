"""2D sliding cube (test_2d_sliding): frictionless incline kinematics vs
the analytic slide law and the reference's committed ensemble DB endpoint."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import sliding_2d as sl

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

REF_DB = ("/root/reference/tests/2d_examples/test_2d_sliding/"
          "regression_test_tool")


def test_sliding_matches_analytic_and_reference_db():
    case, cube = sl.build_case()
    s = sl.init_sim(case, cube)
    idx, w = sl.cube_observer(case, cube)
    run = sl.make_run_chunk(case)
    start = np.asarray(jnp.mean(cube["Position"], axis=0))

    for t_target in (0.5, 1.0, 1.5, 2.0, 2.5):
        s = run(s, jnp.asarray(t_target, s.time.dtype))
        assert not bool(s.overflow)
        t = float(s.time)
        analytic = 0.5 * sl.GRAVITY_G * math.sin(sl.THETA) * t * t
        slide = sl.slide_distance(s, start)
        assert slide == pytest.approx(analytic, rel=5e-3), t_target

    # endpoint vs the reference ensemble DB (mean of 4+ reference runs);
    # gate = 2 sigma of their own ensemble + one particle spacing
    from sphinxsys_jax.io.regression import EnsembleAverageRegressionTest

    db = EnsembleAverageRegressionTest(REF_DB, "CubeObserver", "Position")
    mean, var = db.read_db()
    final = sl.observe_position(s, idx, w)
    gate = 2.0 * np.sqrt(var[-1, 0]) + case.dx
    err = np.abs(final - mean[-1, 0])
    assert np.all(err < gate), (final, mean[-1, 0], gate)
