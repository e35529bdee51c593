"""Plane-strain necking bar (cases/stretching_2d.py, test_2d_stretching).

Oracles chosen against the Simo necking benchmark physics rather than the
reference's BeamObserver DB (whose sampling is keyed to raw iteration
counts, not physical time, stretching.cpp:341): elastic below yield,
radial-return stress consistency at the flowing neck, and plastic-strain
localization at the notch.
"""

import pytest

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import stretching_2d as st

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def _section_kappa(case, bar, x_center, half_width):
    pos0 = np.asarray(bar["InitialPosition"])
    kappa = np.asarray(bar["HardeningParameter"])
    sel = np.abs(pos0[:, 0] - x_center) < half_width
    return kappa[sel]


def test_stretching_necks_plastically():
    case, bar = st.build_case()
    s = st.init_sim(case, bar)
    run = st.make_run_chunk(case)

    # t=1.0 s: total strain 2*PULL_RATE*t/PL = 0.19% < yield strain
    # sigma_y/E = 0.216% -> essentially elastic (only incipient flow at
    # the notch / band-corner stress concentrators is allowed)
    s = run(s, jnp.asarray(1.0, bar["Position"].dtype))
    assert not bool(s.overflow)
    kappa_early = float(jnp.max(s.bar["HardeningParameter"]))
    assert kappa_early < 1.0e-3

    # t=10 s: 1.9% strain, ~1.6% of it plastic
    s = run(s, jnp.asarray(10.0, bar["Position"].dtype))
    assert not bool(s.overflow)
    assert np.all(np.isfinite(np.asarray(s.bar["Position"])))

    kappa = np.asarray(s.bar["HardeningParameter"])
    assert kappa.max() > 0.008, "plastic flow must have started"

    # magnitude: at this pre-necking strain the flow is near-uniform and
    # the equivalent plastic strain follows the plane-strain estimate
    # 2/sqrt(3) * (eps_total - sigma_flow/E) ~ 1.9e-2 (necking proper only
    # develops near the reference's full 19% strain at t=100 s, outside
    # the CI budget)
    k_notch = _section_kappa(case, s.bar, st.PL / 2, 2 * case.dx).mean()
    k_quarter = 0.5 * (
        _section_kappa(case, s.bar, st.PL / 4, 2 * case.dx).mean()
        + _section_kappa(case, s.bar, 3 * st.PL / 4, 2 * case.dx).mean())
    assert 0.014 < k_notch < 0.026
    assert abs(k_notch - k_quarter) < 0.15 * k_notch, "pre-necking flow is uniform"

    # radial-return consistency: in the flowing neck the von Mises
    # Kirchhoff stress sits at the current flow stress
    vm = np.asarray(st.von_mises_kirchhoff(case, s.bar))
    pos0 = np.asarray(s.bar["InitialPosition"])
    neck = (np.abs(pos0[:, 0] - st.PL / 2) < 2 * case.dx)
    flow = np.asarray(case.material._flow_stress(
        s.bar["HardeningParameter"]))
    ratio = vm[neck] / flow[neck]
    assert 0.8 < np.median(ratio) < 1.1

    # the bar actually stretched: ends moved apart by 2*PULL_RATE*10
    x = np.asarray(s.bar["Position"])[:, 0]
    stretch = (x.max() - x.min()) - (pos0[:, 0].max() - pos0[:, 0].min())
    np.testing.assert_allclose(stretch, 2 * st.PULL_RATE * 10.0, rtol=0.05)
