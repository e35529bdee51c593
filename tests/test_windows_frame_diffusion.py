"""Windows-frame heat diffusion (ISO 10077-2 D4) vs the shipped reference
ensemble DB.

Reference: /root/reference/tests/2d_examples/test_2d_windows_frame_diffusion_D4/
regression_test_tool/TemperatureObserver_Phi_ensemble_averaged_mean_variance.xml
(5 observers at x = 0.028, 11 snapshots over t = 0..0.02).
"""

import pytest

import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

REF_DB = ("/root/reference/tests/2d_examples/test_2d_windows_frame_diffusion_D4/"
          "regression_test_tool/"
          "TemperatureObserver_Phi_ensemble_averaged_mean_variance.xml")


def _read_mean():
    root = ET.parse(REF_DB).getroot()
    mean = root.find("Mean_Element")
    rows = []
    for snap in mean:
        step = int(snap.tag.split("_")[1])
        vals = [float(snap.attrib[f"Phi_{i}"]) for i in range(5)]
        rows.append((step, vals))
    rows.sort()
    return np.asarray([v for _, v in rows])  # (11, 5)


def test_windows_frame_tracks_reference_ensemble_mean():
    """Full 11-snapshot trajectory of the 5 observer temperatures within
    0.25 C of the reference ensemble mean (initial spread is 20 C)."""
    from sphinxsys_jax.cases import windows_frame_diffusion_2d as wf

    ref = _read_mean()
    case = wf.build_case()
    s = wf.init_sim(case)
    run = wf.make_run_chunk(case)

    ours = [np.asarray(wf.observe_phi(case, s))]
    for i in range(1, 11):
        s = run(s, jnp.asarray(i * 0.002, s.time.dtype))
        ours.append(np.asarray(wf.observe_phi(case, s)))
    ours = np.asarray(ours)

    assert np.isfinite(ours).all()
    err = np.abs(ours - ref)
    assert err.max() < 0.25, (err.max(), ours[-1], ref[-1])
    # steady state (t = 0.02): even tighter
    assert np.abs(ours[-1] - ref[-1]).max() < 0.1, (ours[-1], ref[-1])
