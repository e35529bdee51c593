"""IO tests: DTW regression machinery (against the reference's committed
golden databases), VTP writer, restart round-trip."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from sphinxsys_jax.io import regression as rg
from sphinxsys_jax.io.vtk import write_vtp
from sphinxsys_jax.io import restart as rst

REF_DB = "/root/reference/tests/2d_examples/test_2d_dambreak/regression_test_tool"


def test_dtw_identical_series_is_zero():
    a = np.sin(np.linspace(0, 3, 40))
    assert rg.dtw_distance(a, a) == 0.0


def test_dtw_shifted_series_small():
    t = np.linspace(0, 3, 40)
    a, b = np.sin(t), np.sin(t - 0.08)
    d_shift = rg.dtw_distance(a, b)
    d_noise = rg.dtw_distance(a, a + 0.5)
    assert d_shift < d_noise


def test_dtw_window_matches_reference_convention():
    """Window = max(5, |la-lb|); lengths differing by < 20% allowed."""
    a = np.linspace(0, 1, 23)
    b = np.linspace(0, 1, 26)
    d = rg.dtw_distance(a, b)
    assert d < 0.5


@pytest.mark.skipif(not os.path.isdir(REF_DB), reason="reference DB not mounted")
def test_read_reference_golden_database():
    """The reference's committed dambreak energy DB must parse, and its own
    stored runs must pass its own DTW test (self-consistency)."""
    test = rg.DTWRegressionTest(REF_DB, "WaterBody", "TotalMechanicalEnergy")
    assert len(test.run_files) == 3
    assert test.threshold.shape == (1,)
    assert test.threshold[0] == 0.2
    stored = rg.read_result_xml(test.run_files[0])
    assert stored.shape[0] == 1 and stored.shape[1] == 23
    ok, report = test.test(stored)
    assert ok, report


@pytest.mark.skipif(not os.path.isdir(REF_DB), reason="reference DB not mounted")
def test_reference_db_rejects_garbage():
    test = rg.DTWRegressionTest(REF_DB, "WaterBody", "TotalMechanicalEnergy")
    stored = rg.read_result_xml(test.run_files[0])
    ok, _ = test.test(stored + 0.5)
    assert not ok


def test_result_xml_roundtrip(tmp_path):
    data = np.random.default_rng(0).uniform(size=(2, 17))
    p = str(tmp_path / "X_Run_0_result.xml")
    rg.write_result_xml(p, data)
    back = rg.read_result_xml(p)
    np.testing.assert_allclose(back, data, rtol=0, atol=0)


def test_vtp_writer(tmp_path):
    state = {
        "NReal": jnp.asarray(3, jnp.int32),
        "Position": jnp.asarray([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [9e9, 9e9]]),
        "Pressure": jnp.asarray([1.0, 2.0, 3.0, 0.0]),
        "Velocity": jnp.asarray([[1.0, 0.0]] * 4),
    }
    p = str(tmp_path / "body.vtp")
    write_vtp(p, state, ["Pressure", "Velocity"])
    text = open(p).read()
    assert 'NumberOfPoints="3"' in text
    assert 'Name="Pressure"' in text and 'Name="Velocity"' in text
    assert "9e+09" not in text  # padding rows excluded


def test_restart_roundtrip(tmp_path):
    from sphinxsys_jax.core.state import make_fluid_state

    rng = np.random.default_rng(1)
    fluid = make_fluid_state(rng.uniform(size=(10, 2)), 0.01, 1.0)
    fluid = dict(fluid)
    fluid["Velocity"] = jnp.asarray(rng.normal(size=(10, 2)), jnp.float32)
    rst.write_restart(str(tmp_path), 5, {"water": fluid}, physical_time=1.25)
    loaded, meta = rst.read_restart(str(tmp_path), 5, {"water": fluid})
    assert meta["physical_time"] == 1.25
    np.testing.assert_array_equal(np.asarray(loaded["water"]["Velocity"]),
                                  np.asarray(fluid["Velocity"]))


def test_reload_roundtrip(tmp_path):
    from sphinxsys_jax.core.state import make_fluid_state

    fluid = make_fluid_state(np.random.default_rng(2).uniform(size=(7, 2)), 0.01, 1.0)
    rst.write_reload(str(tmp_path), "body", fluid)
    pos, vol = rst.read_reload(str(tmp_path), "body")
    assert pos.shape == (7, 2) and vol.shape == (7,)


def test_restart_continue_matches_uninterrupted():
    """Tier-3 restart test (reference registers a second --restart_step=N run
    per case, test_2d_dambreak/CMakeLists.txt:25-26): run dambreak to step
    k1, checkpoint, resume, continue to k2 — the resumed trajectory must be
    bit-exact vs an uninterrupted run on CPU."""
    import tempfile

    import jax
    from sphinxsys_jax.cases import dambreak_2d as db

    case, fluid = db.build_case(dx=0.1)
    step = db.make_advection_step(case)
    s = db.init_sim(case, fluid)

    # straight run: 6 advection steps
    s_ref = s
    for _ in range(6):
        s_ref = step(s_ref)

    # interrupted run: 3 steps -> checkpoint -> restore -> 3 more
    s_a = s
    for _ in range(3):
        s_a = step(s_a)
    with tempfile.TemporaryDirectory() as d:
        rst.write_restart(d, 3, {"WaterBody": s_a.fluid},
                          physical_time=float(s_a.time),
                          n_adv=int(s_a.n_adv), n_ac=int(s_a.n_ac))
        loaded, meta = rst.read_restart(d, 3, {"WaterBody": s_a.fluid})
    fluid_b = loaded["WaterBody"]
    # exactness of the snapshot itself
    np.testing.assert_array_equal(np.asarray(fluid_b["Position"]),
                                  np.asarray(s_a.fluid["Position"]))
    # resume: rebuild relations from the snapshot (reference contract,
    # Dambreak.cpp:131-138) and restore counters/physical time
    nl_inner, nl_wall = jax.jit(lambda f: db.rebuild_relations(case, f))(fluid_b)
    s_b = db.SimState(
        fluid=fluid_b, nl_inner=nl_inner, nl_wall=nl_wall,
        time=jnp.asarray(meta["physical_time"], s_a.time.dtype),
        n_adv=jnp.asarray(meta["n_adv"], jnp.int32),
        n_ac=jnp.asarray(meta["n_ac"], jnp.int32),
        overflow=jnp.zeros((), bool))
    for _ in range(3):
        s_b = step(s_b)

    assert int(s_b.n_adv) == int(s_ref.n_adv) == 6
    assert int(s_b.n_ac) == int(s_ref.n_ac)
    np.testing.assert_array_equal(np.asarray(s_b.fluid["Position"]),
                                  np.asarray(s_ref.fluid["Position"]))
    np.testing.assert_array_equal(np.asarray(s_b.fluid["Velocity"]),
                                  np.asarray(s_ref.fluid["Velocity"]))
    np.testing.assert_array_equal(np.asarray(s_b.fluid["Density"]),
                                  np.asarray(s_ref.fluid["Density"]))


# ---------------------------------------------------------------------------
# time-averaged + ensemble-averaged regression methods (VERDICT r1 item 9;
# reference: src/shared/regression_test/time_average_method.h,
# ensemble_average_method.h)
# ---------------------------------------------------------------------------

FSI2_DB = "/root/reference/tests/2d_examples/test_2d_fsi2/regression_test_tool"
HEAT_DB = "/root/reference/tests/2d_examples/test_2d_heat_transfer/regression_test_tool"


@pytest.mark.skipif(not os.path.isdir(FSI2_DB), reason="reference DB not mounted")
def test_time_average_reads_reference_db_and_accepts_consistent_series():
    t = rg.TimeAverageRegressionTest(FSI2_DB, "InsertedBody",
                                     "TotalViscousForceFromFluid")
    mean, var = t.read_db()
    np.testing.assert_allclose(mean, [[0.451157, 0.00157671]], rtol=1e-5)
    # a synthetic steady series fluctuating inside the stored envelope passes
    rng = np.random.default_rng(0)
    n = 200
    series = mean[None, :, :] + rng.normal(size=(n, 1, 2)) * np.sqrt(var) * 0.3
    ok, report = t.test(series)
    assert ok, report
    # a series with a 20% off mean fails
    ok_bad, _ = t.test(series * 1.2)
    assert not ok_bad


def test_time_average_roundtrip_and_generate(tmp_path):
    t = rg.TimeAverageRegressionTest(str(tmp_path), "Body", "Drag")
    rng = np.random.default_rng(3)
    run1 = 2.0 + 0.01 * rng.normal(size=(100, 1))
    t.update_db(run1, n_runs_so_far=0)
    run2 = 2.001 + 0.01 * rng.normal(size=(100, 1))
    t.update_db(run2, n_runs_so_far=1)
    ok, report = t.test(2.0 + 0.01 * rng.normal(size=(100, 1)))
    assert ok, report
    ok_bad, _ = t.test(2.5 + 0.01 * rng.normal(size=(100, 1)))
    assert not ok_bad


def test_search_steady_start_finds_transient():
    # ramp for the first half, steady after
    n = 100
    x = np.concatenate([np.linspace(0, 1, 50), np.ones(50)])
    start = rg.search_steady_start(x[:, None])
    assert 40 <= start <= 60


@pytest.mark.skipif(not os.path.isdir(HEAT_DB), reason="reference DB not mounted")
def test_ensemble_average_reads_reference_db():
    e = rg.EnsembleAverageRegressionTest(HEAT_DB, "FluidObserver", "Phi")
    mean, var = e.read_db()
    assert mean.shape == var.shape and mean.shape[0] > 50
    # the stored mean curve itself passes its own envelope
    ok, report = e.test(mean)
    assert ok, report
    # a curve far outside fails
    ok_bad, _ = e.test(mean * 1.5)
    assert not ok_bad


def test_ensemble_average_roundtrip(tmp_path):
    e = rg.EnsembleAverageRegressionTest(str(tmp_path), "Obs", "Pressure")
    rng = np.random.default_rng(5)
    base = 2.0 + np.sin(np.linspace(0, 3, 60))[:, None]
    e.update_db(base + 0.01 * rng.normal(size=base.shape), 0)
    e.update_db(base + 0.01 * rng.normal(size=base.shape), 1)
    e.update_db(base + 0.01 * rng.normal(size=base.shape), 2)
    ok, report = e.test(base + 0.005 * rng.normal(size=base.shape))
    assert ok, report
    ok_bad, _ = e.test(base + 0.3)
    assert not ok_bad


def test_vector_result_xml_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "v.xml")
    data = np.random.default_rng(7).normal(size=(2, 5, 3))
    rg.write_result_xml(path, data)
    back = rg.read_result_xml(path)
    np.testing.assert_allclose(back, data, rtol=0, atol=0)


def test_velocity_out_of_bound_dump(tmp_path):
    """WriteToVtpIfVelocityOutOfBound (io_vtk.h:116-134): no dump within
    bound; dump every body on first violation."""
    import jax.numpy as jnp
    import numpy as np

    from sphinxsys_jax.io.failure import WriteToVtpIfVelocityOutOfBound

    body = {"Position": jnp.zeros((4, 2)), "Velocity": jnp.zeros((4, 2)),
            "NReal": jnp.asarray(4)}
    check = WriteToVtpIfVelocityOutOfBound(str(tmp_path), bound=5.0,
                                           variables=("Velocity",))
    assert not check({"WaterBody": body}, time=0.1)
    bad = dict(body)
    bad["Velocity"] = jnp.asarray(np.array([[0, 0], [6.0, 0], [0, 0], [0, 0]]))
    assert check({"WaterBody": bad}, time=0.2)
    dumps = list(tmp_path.glob("WaterBody_velocity_out_of_bound_*.vtp"))
    assert len(dumps) == 1
    # idempotent after failure: no second dump
    assert check({"WaterBody": bad}, time=0.3)
    assert len(list(tmp_path.glob("*.vtp"))) == 1
