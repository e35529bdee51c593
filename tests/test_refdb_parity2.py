"""Reference-database parity, round-5 widening (VERDICT r4 item 4):
live-run DTW/ensemble gates against the reference's committed regression
databases for the solid / granular / contact families.  Complements
tests/test_refdb_parity.py (fluid cases with committed curves).

Every gate is set from measured evidence (benchmarks/calib_refdb2.py),
recorded per test next to the reference runs' own pairwise spread —
the honest envelope, since several reference DBs are near-bit-identical
reruns whose stored thresholds no cross-implementation can meet.
"""

import glob
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.io import regression as rg

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

REF2 = "/root/reference/tests/2d_examples"
REF3 = "/root/reference/tests/3d_examples"


def _dtw_to_runs(base, case, body, q, series):
    d = os.path.join(base, case, "regression_test_tool")
    runs = sorted(glob.glob(os.path.join(d, f"{body}_{q}_Run_*_result.xml")))
    assert runs, f"no DTW runs for {case}"
    rr = [rg.read_result_xml(f)[0] for f in runs]
    series = np.asarray(series, np.float64)
    return sorted(float(rg.dtw_distance(series, r)) for r in rr)


def _dtw_to_ensemble_mean(base, case, body, q, series):
    d = os.path.join(base, case, "regression_test_tool")
    t = rg.EnsembleAverageRegressionTest(d, body, q)
    mean, _ = t.read_db()
    return float(rg.dtw_distance(np.asarray(series, np.float64), mean[:, 0]))


@pytest.mark.slow
@pytest.mark.parametrize("integrator,ref_case,gate", [
    ("pk2", "test_2d_oscillating_beam", 0.8),
    ("cauchy", "test_2d_oscillating_beam_cauchy", 0.8),
])
def test_oscillating_beam_tip_vs_reference_db(integrator, ref_case, gate):
    """Tip Position (100-snapshot ensemble DB over T0 = 1).  Measured
    DTW-to-ensemble-mean 0.496 (pk2) / 0.499 (cauchy) on a 0.2-signal —
    ~0.005/snapshot, 7% of the 0.07 tip amplitude.  Gate 0.8."""
    from sphinxsys_jax.cases import oscillating_beam_2d as ob

    case, s = ob.build_case(integrator=integrator)
    run = ob.make_run_chunk(case)
    pos0 = np.asarray(s.solid["InitialPosition"])[: case.n_solid]
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([ob.PL, 0.0]),
                                     axis=1)))
    out = [np.asarray(s.solid["Position"][i])]
    for k in range(1, 100):
        s = run(s, jnp.asarray(k * 0.01, s.time.dtype))
        out.append(np.asarray(s.solid["Position"][i]))
    d = _dtw_to_ensemble_mean(REF2, ref_case, "BeamObserver", "Position",
                              out)
    assert d < gate, d


@pytest.mark.slow
def test_oscillating_beam_ul_ke_vs_reference_db():
    """UL beam TotalKineticEnergy (6 committed runs, bit-identical:
    pairwise spread 0).  Our initial KE matches to 5 digits (4.0648) and
    the first 8 snapshots track within 1%; accumulated phase drift over
    100 snapshots gives DTW 8.94 (2%/snapshot of the 4.06 scale).
    Gate 15 + the exact-KE0 and first-minimum checks below."""
    from sphinxsys_jax.cases import oscillating_beam_ul_2d as obul

    case, beam = obul.build_case()
    s = obul.init_sim(case, beam)
    run = obul.make_run_chunk(case)
    out = [obul.kinetic_energy(s)]
    for k in range(1, 100):
        s = run(s, jnp.asarray(k * 0.01, s.time.dtype))
        out.append(obul.kinetic_energy(s))
    dists = _dtw_to_runs(REF2, "test_2d_oscillating_beam_UL", "BeamBody",
                         "TotalKineticEnergy", out)
    assert max(dists) < 15.0, dists
    ref0 = rg.read_result_xml(sorted(glob.glob(os.path.join(
        REF2, "test_2d_oscillating_beam_UL", "regression_test_tool",
        "BeamBody_TotalKineticEnergy_Run_*_result.xml")))[0])[0]
    assert abs(out[0] - ref0[0]) < 0.01 * ref0[0]
    # first KE minimum (quarter period) within 2 snapshots of the DB's
    assert abs(int(np.argmin(out[:20])) - int(np.argmin(ref0[:20]))) <= 2


@pytest.mark.slow
def test_anisotropic_beam_tip_vs_reference_db():
    """Anisotropic-kernel beam tip Position (ensemble DB).  Measured
    DTW-to-mean 3.06: amplitude agrees (ours ymax 0.11 vs DB 0.099) but
    the oscillation period differs by ~10% (coarse 4x-anisotropic axial
    sampling), which DTW cannot fully absorb on 100 snapshots.  Gate 4
    plus the amplitude check."""
    from sphinxsys_jax.cases import anisotropic_beam_2d as ab

    case, s = ab.build_case()
    run = ab.make_run_chunk(case)
    pos0 = np.asarray(s.solid["InitialPosition"])
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([ab.PL, 0.0]),
                                     axis=1)))
    out = [np.asarray(s.solid["Position"][i])]
    for k in range(1, 100):
        s = run(s, jnp.asarray(k * 0.01, s.time.dtype))
        out.append(np.asarray(s.solid["Position"][i]))
    d = _dtw_to_ensemble_mean(REF2, "test_2d_anisotropic_beam",
                              "BeamObserver", "Position", out)
    assert d < 4.0, d
    ymax = float(np.abs(np.asarray(out)[:, 1]).max())
    assert abs(ymax - 0.0993) < 0.025, ymax


@pytest.mark.slow
def test_muscle_solid_contact_ke_vs_reference_db():
    """Deformable-rigid contact KE (6-snapshot DTW DB, every 100
    iterations to t = 0.1).  Measured DTW 0.0067-0.0122 vs the reference
    runs' own spread 0.0022-0.0055 (the KE impact spike lands between
    iteration-cadenced snapshots differently per run).  Gate 0.02."""
    from sphinxsys_jax.cases import muscle_solid_contact_3d as mc

    case, s = mc.build_case()
    run = mc.make_run_chunk(case)
    out = [mc.kinetic_energy(s)]
    while float(s.time) < 0.1:
        target = int(s.n_steps) + 100
        while int(s.n_steps) < target and float(s.time) < 0.1:
            s = run(s, jnp.asarray(min(float(s.time) + 0.002, 0.1),
                                   jnp.float64))
        out.append(mc.kinetic_energy(s))
    assert not bool(s.overflow)
    dists = _dtw_to_runs(REF3, "test_3d_muscle_solid_contact",
                         "MyocardiumBody", "TotalKineticEnergy", out)
    assert max(dists) < 0.02, dists


@pytest.mark.slow
def test_twisting_rigid_elastic_bar_vs_febio():
    """Steady-state interface displacements vs the FEBio reference
    (reference_data/displacement; the reference's own gtest gate is 15%).
    Measured 3.6-7.9% at res_factor 2; gate 12%."""
    from sphinxsys_jax.cases import twisting_rigid_elastic_bar_3d as bar

    case, s = bar.build_case()
    run = bar.make_run_chunk(case)
    hist = []
    for i in range(1, 26):
        s = run(s, jnp.asarray(i * 0.2, jnp.float64))
        hist.append(bar.observer_displacements(case, s))
        if len(hist) >= 6 and all(
                np.linalg.norm(hist[-k] - hist[-k - 1], axis=1).max() < 1e-2
                for k in range(1, 6)):
            break
    ref = np.asarray([bar.FEBIO_DISP[tuple(p)] for p in bar.OBSERVERS])
    d = hist[-1]
    err = np.linalg.norm(d - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert (err < 0.12).all(), err


@pytest.mark.slow
def test_repose_angle_energy_vs_reference_db():
    """3D repose angle GranularBody_TotalMechanicalEnergy (5 snapshots to
    t=0.5; the reference's 6 committed runs are bit-identical, spread
    ~1e-4, stored threshold 0.15).  Measured DTW 1.64 on the 1.5-4.0
    signal (settling sequence 3.99/3.05/1.90/1.55/1.52) — a few-% energy
    family offset per snapshot.  Gate 2.5 + settled-endpoint check."""
    from sphinxsys_jax.cases import repose_angle_3d as ra

    case, soil = ra.build_case()
    s = ra.init_sim(case, soil)
    run = ra.make_run_chunk(case)
    out = []
    for k in range(5):
        s = run(s, jnp.asarray((k + 1) * 0.1, s.time.dtype))
        assert not bool(s.overflow)
        out.append(ra.mechanical_energy(case, s))
    dists = _dtw_to_runs(REF3, "test_3d_repose_angle", "GranularBody",
                         "TotalMechanicalEnergy", out)
    assert max(dists) < 2.5, dists
    # the settled plateau within 8% of the reference's 1.517
    assert abs(out[-1] - 1.5172) < 0.08 * 1.5172, out[-1]
