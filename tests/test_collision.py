"""2D two-ball collision (test_2d_collision): free-fall kinematics, bounce
persistence of the free ball, and the damped ball settling at the
reference's own resting height (0.4907 from its committed Run_0 curve)."""

import pytest

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import collision_2d as co

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_collision_free_fall_bounce_and_damped_settling():
    case, balls = co.build_case()
    s = co.init_sim(case, balls)
    run = co.make_run_chunk(case)

    # free-fall phase: both centers track y(t) = 2 - t^2/2
    free_peaks = []
    damp_final = None
    min_free_y = 2.0
    for i in range(1, 41):
        s = run(s, jnp.asarray(i * 0.25, s.time.dtype))
        assert not bool(s.overflow)
        t = float(s.time)
        y1 = co.ball_center(s.free_ball)[1]
        y2 = co.ball_center(s.damping_ball)[1]
        min_free_y = min(min_free_y, y1)
        if t < 1.6:
            analytic = 2.0 - 0.5 * t * t
            assert abs(y1 - analytic) < 0.02, (t, y1, analytic)
            assert abs(y2 - analytic) < 0.02, (t, y2, analytic)
        free_peaks.append((t, y1))
        damp_final = y2

    # free ball: bounces (first rebound peak within a sane window of the
    # reference's 1.29) and is STILL bouncing at t=10
    peak1 = max(y for t, y in free_peaks if 2.0 < t < 4.5)
    assert 1.1 < peak1 < 1.6, peak1
    late = [y for t, y in free_peaks if t > 8.0]
    assert max(late) - min(late) > 0.3, late

    # no penetration: the soft ball squishes at impact (the reference's own
    # observer minimum is 0.375) but the center must stay above the squish
    # band — anything lower means it passed through the floor
    assert min_free_y > 0.35, min_free_y

    # damping ball: at rest on the floor at the reference's resting height
    # (DampingBallObserver Run_0 final y = 0.4907)
    assert abs(damp_final - 0.4907) < 2 * case.dx, damp_final
