"""Calibration sweep for the round-5 reference-DB parity widening:
run each solid/granular case at (or near) the reference resolution on
CPU, sample the DB quantity at the DB cadence, and print DTW distances
to every committed reference run (or to the ensemble mean) next to the
reference runs' own pairwise spread.  The measured numbers set the
evidence-based gates in tests/test_refdb_parity2.py."""

import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import glob

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.io import regression as rg

REF2 = "/root/reference/tests/2d_examples"
REF3 = "/root/reference/tests/3d_examples"


def dtw_report(name, base, case, body, q, series):
    d = os.path.join(base, case, "regression_test_tool")
    series = np.asarray(series, np.float64)
    runs = sorted(glob.glob(os.path.join(d, f"{body}_{q}_Run_*_result.xml")))
    if runs:
        rr = [rg.read_result_xml(f)[0] for f in runs]
        spread = sorted(float(rg.dtw_distance(a, b))
                        for a, b in itertools.combinations(rr[:6], 2))
        dists = sorted(float(rg.dtw_distance(series, r)) for r in rr)
        print(f"[{name}] OURS dtw {np.round(dists, 4)}  "
              f"ref spread {np.round(spread, 4)}")
    else:
        t = rg.EnsembleAverageRegressionTest(d, body, q)
        mean, var = t.read_db()
        mean = mean[:, 0]
        dist = float(rg.dtw_distance(series, mean))
        scale = float(np.abs(mean).max())
        print(f"[{name}] OURS dtw-to-ENSEMBLE-mean {dist:.4f} "
              f"(signal scale {scale:.4f}, sigma_max "
              f"{float(np.sqrt(var.max())):.4g})")
    return series


def run_beam(integrator="pk2"):
    from sphinxsys_jax.cases import oscillating_beam_2d as ob

    case, s = ob.build_case(integrator=integrator)
    run = ob.make_run_chunk(case)
    pos0 = np.asarray(s.solid["InitialPosition"])[: case.n_solid]
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([ob.PL, 0.0]), axis=1)))
    out = [np.asarray(s.solid["Position"][i])]
    for k in range(1, 100):
        s = run(s, jnp.asarray(k * 0.01, s.time.dtype))
        out.append(np.asarray(s.solid["Position"][i]))
    ref = "test_2d_oscillating_beam" + ("_cauchy" if integrator == "cauchy"
                                        else "")
    dtw_report(f"beam-{integrator}", REF2, ref, "BeamObserver", "Position",
               out)


def run_beam_ul():
    from sphinxsys_jax.cases import oscillating_beam_ul_2d as obul

    case, beam = obul.build_case()
    s = obul.init_sim(case, beam)
    run = obul.make_run_chunk(case)
    out = [obul.kinetic_energy(s)]
    for k in range(1, 100):
        s = run(s, jnp.asarray(k * 0.01, s.time.dtype))
        out.append(obul.kinetic_energy(s))
    dtw_report("beam-UL", REF2, "test_2d_oscillating_beam_UL", "BeamBody",
               "TotalKineticEnergy", out)


def run_aniso():
    from sphinxsys_jax.cases import anisotropic_beam_2d as ab

    case, s = ab.build_case()
    run = ab.make_run_chunk(case)
    pos0 = np.asarray(s.solid["InitialPosition"])
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([ab.PL, 0.0]), axis=1)))
    out = [np.asarray(s.solid["Position"][i])]
    for k in range(1, 100):
        s = run(s, jnp.asarray(k * 0.01, s.time.dtype))
        out.append(np.asarray(s.solid["Position"][i]))
    dtw_report("aniso-beam", REF2, "test_2d_anisotropic_beam", "BeamObserver",
               "Position", out)


def run_three_ring():
    from sphinxsys_jax.cases import three_ring_impact_2d as tri

    case, s = tri.build_case()
    run = tri.make_run_chunk(case)
    t_end = 1.0                       # reference end_time (100 snaps)
    p0 = tri.observer_point(case, s)
    out = [np.zeros(2)]               # the DB records DISPLACEMENT
    for k in range(1, 100):
        s = run(s, jnp.asarray(k * t_end / 100, s.time.dtype))
        out.append(np.asarray(tri.observer_point(case, s)) - np.asarray(p0))
    dtw_report("three-ring", REF2, "test_2d_three_ring_impact", "Observer",
               "Position", out)


def run_taylor_bar():
    from sphinxsys_jax.cases import taylor_bar_ul_3d as tb

    case, col = tb.build_case()
    s = tb.init_sim(case, col)
    run = tb.make_run_chunk(case)
    out = []
    for k in range(60):
        s = run(s, jnp.asarray((k + 1) * 6.0e-5 / 60, s.time.dtype))
        out.append(tb.kinetic_energy(s))
    dtw_report("taylor-bar-UL", REF3, "test_3d_taylor_bar_UL", "Column",
               "TotalKineticEnergy", out)


def run_repose():
    from sphinxsys_jax.cases import repose_angle_3d as ra

    case, soil = ra.build_case()
    s = ra.init_sim(case, soil)
    run = ra.make_run_chunk(case)
    out = []
    for k in range(5):
        s = run(s, jnp.asarray((k + 1) * 0.1, s.time.dtype))
        out.append(ra.mechanical_energy(case, s))
    dtw_report("repose", REF3, "test_3d_repose_angle", "GranularBody",
               "TotalMechanicalEnergy", out)


def run_cantilever():
    from sphinxsys_jax.cases import passive_cantilever_3d as pc

    case, body = pc.build_case()
    s = pc.init_sim(case, body)
    run = pc.make_run_chunk(case)
    idx, w = pc.corner_observer(case, body)
    out = [pc.observe_corner(s, idx, w)]
    for k in range(1, 101):
        s = run(s, jnp.asarray(k * 3.0 / 101, s.time.dtype))
        out.append(pc.observe_corner(s, idx, w))
    dtw_report("cantilever", REF3, "test_3d_passive_cantilever",
               "CantileverObserver", "Position", out)


ALL = {
    "beam": lambda: run_beam("pk2"),
    "beam_cauchy": lambda: run_beam("cauchy"),
    "beam_ul": run_beam_ul,
    "aniso": run_aniso,
    "three_ring": run_three_ring,
    "taylor_bar": run_taylor_bar,
    "repose": run_repose,
    "cantilever": run_cantilever,
}

if __name__ == "__main__":
    which = sys.argv[1:] or list(ALL)
    for w in which:
        try:
            ALL[w]()
        except Exception as e:
            print(f"[{w}] FAILED: {e!r}")
