"""MR free-stream cylinder (test_2d_free_stream_around_cylinder_mr):
composed adaptive-h fluid + open boundaries + fine-grid cylinder contact."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_mr_cylinder_startup_physics():
    """Through the ramp (t = 3): no capacity overflow, the flow core near
    the cylinder stays at O(U) (the MR interface injects no spurious
    velocity there), drag is downstream-positive and lift ~ 0, and the
    refinement strip keeps its per-particle smoothing lengths through the
    emitter/disposer recycling."""
    from sphinxsys_jax.cases import mr_cylinder_2d as mc

    case, fluid = mc.build_case()
    s = mc.init_sim(case, fluid)
    assert not bool(s.overflow)
    run = mc.make_run_chunk(case)
    s = run(s, jnp.asarray(3.0, s.time.dtype))
    assert not bool(s.overflow)

    al = np.asarray(s.fluid["Alive"])
    pos = np.asarray(s.fluid["Position"])[al]
    v = np.asarray(s.fluid["Velocity"])[al]
    hr = np.asarray(s.fluid["SmoothingLengthRatio"])[al]
    assert not np.isnan(v).any()

    # flow core: near the cylinder the speed stays O(U) — interface noise
    # or contact errors would spike it (measured 1.08 at t=3)
    sp = np.linalg.norm(v, axis=1)
    near_cyl = np.hypot(pos[:, 0] - mc.CX, pos[:, 1] - mc.CY) < 2.0
    assert sp[near_cyl].max() < 1.6

    # viscous drag downstream-positive, lift two orders smaller
    fv, fp = mc.cylinder_forces(case, s)
    assert float(fv[0]) > 0.05
    assert abs(float(fv[1])) < 0.2 * float(fv[0])

    # strip integrity under recycling: fine particles deep in the strip
    # keep hr = 2, coarse ones hr = 1
    deep = (pos[:, 1] > 6.0) & (pos[:, 1] < 10.0)
    assert np.all(np.abs(hr[deep] - 2.0) < 1e-6)
    outside = (pos[:, 1] < 4.0) | (pos[:, 1] > 12.0)
    assert np.all(np.abs(hr[outside] - 1.0) < 1e-6)


def test_mr_cylinder_drag_vs_reference_band():
    """The committed production run (benchmarks/
    run_mr_cylinder_validation.py, t = 0..30, relaxed IC) must sit inside
    the reference's Cylinder_TotalViscousForceFromFluid DTW band: all three
    committed reference runs settle in 0.30-0.38 after the wake develops
    (regression_test_tool/Cylinder_TotalViscousForceFromFluid_Run_*.xml,
    snapshots 2-42: min 0.2965, max 0.3807).  Root cause of the round-3
    2x miss: the case's startup body force OVERWROTE ForcePrior each
    advection step, cancelling the viscous prior force down to its
    per-step delta (see cases/mr_cylinder_2d.py _startup_force) — with the
    BaseForcePrior delta convention restored the measured tail is
    0.308 +- 0.014.  This gate catches drift in the committed artifact."""
    hist = np.load("tests/golden/mr_cylinder/drag_r4.npy")
    t, fx, fy = hist[:, 0], hist[:, 1], hist[:, 2]
    assert t[-1] >= 29.0
    tail = fx[t > 12.0]
    # every post-development snapshot inside a slightly padded band (the
    # reference runs' own snapshot extremes are 0.2965/0.3807)
    assert tail.min() > 0.27 and tail.max() < 0.41
    assert 0.30 <= tail.mean() <= 0.38
    # lift stays two orders below drag (the reference's stated property)
    assert np.abs(fy[t > 12.0]).mean() < 0.1 * tail.mean()
