"""Tier-2 regression tests against this framework's own committed golden
databases (tests/golden/, generated by benchmarks/generate_golden.py) —
the same discipline as the reference's regression_test_tool XMLs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.io.regression import DTWRegressionTest

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "dambreak_2d")),
                    reason="golden DB not generated")
def test_dambreak_energy_regression():
    from sphinxsys_jax.cases import dambreak_2d as db
    from sphinxsys_jax.physics import general as gd

    case, fluid = db.build_case(dx=0.05)
    s = db.init_sim(case, fluid)
    run = db.make_run_chunk(case)
    energies = [float(gd.total_mechanical_energy(s.fluid, case.gravity))]
    for i in range(1, 26):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        energies.append(float(gd.total_mechanical_energy(s.fluid, case.gravity)))
    test = DTWRegressionTest(os.path.join(GOLDEN, "dambreak_2d"),
                             "WaterBody", "TotalMechanicalEnergy")
    ok, report = test.test(np.asarray(energies))
    assert ok, report


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "oscillating_beam_2d")),
                    reason="golden DB not generated")
def test_beam_tip_regression():
    from sphinxsys_jax.cases import oscillating_beam_2d as ob

    case, s = ob.build_case()
    run = ob.make_run_chunk(case)
    tips = [0.0]
    for i in range(1, 21):
        s = run(s, jnp.asarray(i * 0.05, s.time.dtype))
        tips.append(ob.tip_displacement(case, s))
    test = DTWRegressionTest(os.path.join(GOLDEN, "oscillating_beam_2d"),
                             "BeamObserver", "TipDisplacementY")
    ok, report = test.test(np.asarray(tips))
    assert ok, report


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "taylor_green_2d")),
                    reason="golden DB not generated")
def test_taylor_green_ke_regression():
    from sphinxsys_jax.cases import taylor_green_2d as tg
    from sphinxsys_jax.physics import general as gd

    case, fluid = tg.build_case(dx=0.02)
    s = tg.init_sim(case, fluid)
    run = tg.make_run_chunk(case)
    kes = [float(gd.total_kinetic_energy(s.fluid))]
    for i in range(1, 21):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        kes.append(float(gd.total_kinetic_energy(s.fluid)))
    test = DTWRegressionTest(os.path.join(GOLDEN, "taylor_green_2d"),
                             "WaterBody", "TotalKineticEnergy")
    ok, report = test.test(np.asarray(kes))
    assert ok, report


def test_taylor_green_relaxed_ic_matches_analytic_decay():
    """With RELAXED initial particle positions (the reference's --relax
    path) the Taylor-Green velocity decay matches the analytic
    exp(-8 pi^2 nu t) to ~2%, where the raw lattice start over-dissipates
    by ~35% (lattice-anisotropy error) — measured 0.4625 vs 0.4540
    analytic at t=1, Re=100, dx=0.02."""
    import math

    from sphinxsys_jax.cases import taylor_green_2d as tg
    from sphinxsys_jax.physics import general as gd

    case, fluid = tg.build_case(dx=0.02, relax_ic=200)
    s = tg.init_sim(case, fluid)
    v0 = float(gd.maximum_speed(s.fluid))
    run = tg.make_run_chunk(case)
    s = run(s, jnp.asarray(1.0, s.time.dtype))
    assert not bool(s.overflow)
    v1 = float(gd.maximum_speed(s.fluid))
    analytic = math.exp(-8.0 * math.pi ** 2 * 0.01)
    np.testing.assert_allclose(v1 / v0, analytic, rtol=0.05)


@pytest.mark.skipif(not os.path.exists(os.path.join(
    GOLDEN, "dambreak_2d", "FluidObserver_Pressure_Run_0_result.xml")),
    reason="golden DB not generated")
def test_dambreak_wall_pressure_probe_regression():
    """Local observer probe at the right wall (the reference's dambreak
    FluidObserver at (DL, 0.2), Dambreak.cpp) — a sharper discriminator
    than global energy."""
    from functools import partial

    import jax
    from sphinxsys_jax.cases import dambreak_2d as db
    from sphinxsys_jax.io.observation import observe_quantity
    from sphinxsys_jax.neighbors import build_cell_table, build_neighbor_list

    case, fluid = db.build_case(dx=0.05)
    s = db.init_sim(case, fluid)
    run = db.make_run_chunk(case)
    obs = jnp.asarray([[db.DL - 0.5 * case.dx, 0.2]], jnp.float32)

    @jax.jit
    def probe(f):
        table = build_cell_table(f["Position"], f["NReal"], case.grid,
                                 cap=case.cell_cap)
        nl = build_neighbor_list(obs, jnp.asarray(1, jnp.int32), f["Position"],
                                 f["NReal"], table, case.grid,
                                 case.adaptation.cutoff, k_max=64,
                                 include_self=True)
        return observe_quantity(obs, f, "Pressure", nl, case.kernel, 2)[0]

    ps = [float(probe(s.fluid))]
    for i in range(1, 31):
        s = run(s, jnp.asarray(i * 0.12, s.time.dtype))
        ps.append(float(probe(s.fluid)))
    test = DTWRegressionTest(os.path.join(GOLDEN, "dambreak_2d"),
                             "FluidObserver", "Pressure")
    ok, report = test.test(np.asarray(ps))
    assert ok, report


def _dtw_case(subdir, body, quantity, series):
    test = DTWRegressionTest(os.path.join(GOLDEN, subdir), body, quantity)
    ok, report = test.test(np.asarray(series))
    assert ok, report


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "shell_cantilever_2d")),
                    reason="golden DB not generated")
def test_shell_cantilever_regression():
    from sphinxsys_jax.cases import shell_cantilever_2d as sc

    case, s = sc.build_case()
    run = sc.make_run_chunk(case)
    tips = [0.0]
    for i in range(1, 21):
        s = run(s, jnp.asarray(i * 0.02, s.time.dtype))
        tips.append(float(sc.tip_displacement(case, s)))
    _dtw_case("shell_cantilever_2d", "Shell", "TipDisplacementY", tips)


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "shell_plate_3d")),
                    reason="golden DB not generated")
def test_shell_plate_regression():
    from sphinxsys_jax.cases import shell_plate_3d as sp

    case, s = sp.build_case()
    run = sp.make_run_chunk(case)
    tips = [0.0]
    for i in range(1, 16):
        s = run(s, jnp.asarray(i * 0.002, s.time.dtype))
        tips.append(float(sp.tip_displacement(case, s)))
    _dtw_case("shell_plate_3d", "Plate", "CenterDeflection", tips)


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "column_collapse_2d")),
                    reason="golden DB not generated")
def test_column_collapse_runout_regression():
    from sphinxsys_jax.cases import column_collapse_2d as cc

    case, soil = cc.build_case()
    s = cc.init_sim(case, soil)
    run = cc.make_run_chunk(case)
    fronts = [float(np.asarray(s.soil["Position"])[: case.n_soil, 0].max())]
    for i in range(1, 16):
        s = run(s, jnp.asarray(i * 0.04, s.time.dtype))
        fronts.append(float(np.asarray(s.soil["Position"])[: case.n_soil, 0].max()))
    _dtw_case("column_collapse_2d", "SoilBody", "RunoutFront", fronts)


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "two_phase_dambreak_2d")),
                    reason="golden DB not generated")
def test_two_phase_ke_regression():
    from sphinxsys_jax.cases import two_phase_dambreak_2d as tp
    from sphinxsys_jax.physics import general as gd

    case, water, air = tp.build_case()
    s = tp.init_sim(case, water, air)
    run = tp.make_run_chunk(case)
    kes = [float(gd.total_kinetic_energy(s.water))]
    for i in range(1, 16):
        s = run(s, jnp.asarray(i * 0.08, s.time.dtype))
        kes.append(float(gd.total_kinetic_energy(s.water)))
    _dtw_case("two_phase_dambreak_2d", "WaterBody", "TotalKineticEnergy", kes)


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "ball_shell_collision_3d")),
                    reason="golden DB not generated")
def test_ball_shell_com_regression():
    from sphinxsys_jax.cases import ball_shell_collision_3d as bs

    case, ball = bs.build_case()
    s = bs.init_sim(case, ball)
    run = bs.make_run_chunk(case)

    def com_z(s):
        m = np.asarray(s.ball["Mass"])
        return float((m * np.asarray(s.ball["Position"])[:, 2]).sum() / m.sum())

    zs = [com_z(s)]
    for i in range(1, 21):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        zs.append(com_z(s))
    _dtw_case("ball_shell_collision_3d", "BallBody", "CenterOfMassZ", zs)


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "lid_driven_cavity_2d")),
                    reason="golden DB not generated")
def test_lid_cavity_ke_regression():
    from sphinxsys_jax.cases import lid_driven_cavity_2d as lc
    from sphinxsys_jax.physics import general as gd

    case, fluid = lc.build_case()
    s = lc.init_sim(case, fluid)
    run = lc.make_run_chunk(case)
    kes = [float(gd.total_kinetic_energy(s.fluid))]
    for i in range(1, 13):
        s = run(s, jnp.asarray(i * 0.25, s.time.dtype))
        kes.append(float(gd.total_kinetic_energy(s.fluid)))
    _dtw_case("lid_driven_cavity_2d", "FluidBody", "TotalKineticEnergy", kes)


@pytest.mark.skipif(not os.path.isdir(os.path.join(GOLDEN, "floating_body_2d")),
                    reason="golden DB not generated")
def test_floating_body_heave_regression():
    from sphinxsys_jax.cases import floating_body_2d as fb

    case, fluid = fb.build_case()
    s = fb.init_sim(case, fluid)
    run = fb.make_run_chunk(case)

    def com_y(s):
        m = np.asarray(s.block["Mass"])
        return float((m * np.asarray(s.block["Position"])[:, 1]).sum() / m.sum())

    ys = [com_y(s)]
    for i in range(1, 21):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        ys.append(com_y(s))
    _dtw_case("floating_body_2d", "FloatingBlock", "CenterOfMassY", ys)


@pytest.mark.skipif(
    not os.path.isdir(os.path.join(GOLDEN, "turbulent_channel_2d")),
    reason="golden DB not generated")
def test_turbulent_channel_viscosity_regression():
    """Centerpoint eddy-viscosity curve vs the committed run (the reference
    channel's own DTW quantity, test_2d_turbulent_channel.cpp:131)."""
    from sphinxsys_jax.cases import turbulent_channel_2d as tc

    case, fluid = tc.build_case()
    s = tc.init_sim(case, fluid)
    run = tc.make_run_chunk(case)
    series = []
    for i in range(1, 21):
        s = run(s, jnp.asarray(i * 1.0, s.time.dtype))
        pos = np.asarray(s.fluid["Position"])
        j = int(np.argmin(np.linalg.norm(
            pos - np.asarray([case.length / 2, tc.DH / 2]), axis=1)))
        series.append(float(s.fluid["TurbulentViscosity"][j]))
    test = DTWRegressionTest(os.path.join(GOLDEN, "turbulent_channel_2d"),
                             "WaterBody", "TurbulentViscosity")
    ok, report = test.test(np.asarray(series))
    assert ok, report


@pytest.mark.skipif(
    not os.path.isdir(os.path.join(GOLDEN, "fvm_cylinder_2d")),
    reason="golden DB not generated")
def test_fvm_cylinder_force_regression():
    """Streamwise force on the cylinder vs the committed run (the FVM
    case's regression quantity, 2d_FVM_flow_around_cylinder.cpp:131)."""
    from sphinxsys_jax.cases import fvm_cylinder_2d as fc

    case, fluid = fc.build_case()
    s = fc.init_sim(case, fluid)
    run = fc.make_run_chunk(case)
    series = []
    for i in range(1, 31):
        s = run(s, jnp.asarray(i * 2.0, s.time.dtype))
        series.append(float(fc.cylinder_force(case, s)[0]))
    test = DTWRegressionTest(os.path.join(GOLDEN, "fvm_cylinder_2d"),
                             "WaterBody", "ForceOnCylinderX")
    ok, report = test.test(np.asarray(series))
    assert ok, report
