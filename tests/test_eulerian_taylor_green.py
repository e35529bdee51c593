"""Eulerian Taylor-Green with the Laguerre-Gauss kernel
(cases/eulerian_taylor_green_2d.py, test_2d_eulerian_taylor_green_LG).

Gate: the reference's OWN ensemble-averaged WaterBody_TotalKineticEnergy
DB, snapshot every 0.1 s at the same dx = 1/50.  The reference curve
itself decays ~4% faster than the analytic exp(-16 pi^2 nu t) by t=1
(numerical dissipation of the limited-HLLC flux at this resolution);
this framework tracks the DB to ~3% pointwise, which the 6% gate holds
with margin while still catching a broken limiter (unlimited HLLC sits
at -75% by t=1).
"""

import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import eulerian_taylor_green_2d as tg

DB = ("/root/reference/tests/2d_examples/test_2d_eulerian_taylor_green_LG/"
      "regression_test_tool/"
      "WaterBody_TotalKineticEnergy_ensemble_averaged_mean_variance.xml")


def _db_mean(n_snapshots: int):
    root = ET.parse(DB).getroot()
    mean = root[0]
    out = {}
    for el in mean:
        k = int(el.tag.split("_")[1])
        out[k] = float(el.attrib["TotalKineticEnergy_0"])
    return [out[k] for k in sorted(out)][:n_snapshots]


def test_eulerian_tg_tracks_reference_ensemble_db():
    case, fluid = tg.build_case()
    s = tg.init_sim(case, fluid)
    np.testing.assert_allclose(tg.kinetic_energy(s), 0.25, rtol=1e-5)

    run = tg.make_run_chunk(case)
    ours = [tg.kinetic_energy(s)]
    for i in range(1, 11):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        ours.append(tg.kinetic_energy(s))
    assert not bool(s.overflow)
    assert np.all(np.isfinite(np.asarray(s.fluid["Velocity"])))

    ref = _db_mean(11)
    np.testing.assert_allclose(ours, ref, rtol=0.06)

    # the flow stays effectively incompressible: density within 1% of 1
    rho = np.asarray(s.fluid["Density"])
    assert abs(rho - 1.0).max() < 0.01
