"""3D cubic droplet (cases/cubic_droplet_3d.py = test_3d_cubic_droplet):
surface tension rounds the cube toward the equal-volume sphere."""

import glob

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.io import regression as rg

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

REF_DB = ("/root/reference/tests/3d_examples/test_3d_cubic_droplet/"
          "regression_test_tool")


@pytest.mark.slow
def test_cubic_droplet_rounds_and_tracks_reference_ke():
    """Run the early rounding transient (t = 0..0.3, 6 reference-cadence
    snapshots at 0.05) at dx = 2/20 (reference: 2/30) and gate:
      * the corner radius decays from sqrt(3)/2 ~ 0.87 toward the
        equal-volume sphere radius 0.62 and oscillates about it;
      * the KE series tracks the reference DB prefix (measured: ours
        0.735 vs ref 0.768 at snap 1 despite the coarser dx); DTW on the
        6-snapshot prefix < 0.35 (ref runs' own full-series pairwise
        spread is ~0.3-0.9 — capillary oscillations decorrelate)."""
    from sphinxsys_jax.cases import cubic_droplet_3d as cd

    case, water, air = cd.build_case(dx=2.0 / 20)
    s = cd.init_sim(case, water, air)
    run = cd.make_run_chunk(case)
    series = []
    for i in range(1, 7):
        s = run(s, jnp.asarray(i * 0.05, s.time.dtype))
        assert not bool(s.overflow)
        series.append(cd.water_kinetic_energy(s))
    rmax = cd.water_max_radius(s)
    assert 0.55 < rmax < 0.70, rmax

    runs = sorted(glob.glob(REF_DB + "/WaterBody_TotalKineticEnergy_Run_"
                            "*_result.xml"))
    dists = [float(rg.dtw_distance(np.asarray(series),
                                   rg.read_result_xml(f)[0][1:7]))
             for f in runs]
    assert min(dists) < 0.35, dists
