"""Generate this framework's curves for the reference-database parity sweep
(VERDICT r2 item 3) and report DTW distances against the reference's own
committed regression databases.

Each case runs at the REFERENCE resolution with the reference's recording
cadence, writes our curve as a reference-format Run XML under
tests/golden/refdb/<case>/, and prints the DTW distance to every stored
reference run next to the reference runs' own pairwise spread (the honest
envelope — the stored thresholds are sometimes tighter than the stored
runs' own scatter, e.g. taylor_green KE thr=0.002 vs pairwise 0.005).

Usage (GPU preferred; CPU works but is slow), from the repository root:
  python benchmarks/run_refdb_parity.py dambreak
  ... taylor_green | column_collapse | all

Provenance: the committed curves in tests/golden/refdb/ were generated by
this script; regenerate whenever the physics ops change.
"""

import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from sphinxsys_jax.io import regression as rg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "golden", "refdb")
REF = "/root/reference/tests/2d_examples"


def report(name, body, quantity, series, ref_dir):
    os.makedirs(os.path.join(OUT, name), exist_ok=True)
    path = os.path.join(OUT, name, f"{body}_{quantity}_Run_0_result.xml")
    data = np.asarray(series, dtype=np.float64)[None, :]  # (1 obs, snaps)
    rg.write_result_xml(path, data)
    print(f"wrote {path} ({data.shape[1]} snapshots)")

    test = rg.DTWRegressionTest(os.path.join(REF, ref_dir,
                                             "regression_test_tool"),
                                body, quantity)
    runs = [rg.read_result_xml(f) for f in test.run_files]
    spread = [float(rg.dtw_distance(a[0], b[0]))
              for a, b in itertools.combinations(runs, 2)]
    dists = [float(d[0]) for d in test.distances(data)]
    print(f"  threshold={test.threshold}  ref pairwise spread="
          f"{np.round(spread, 4)}")
    print(f"  OUR dtw distances: {np.round(dists, 4)}")
    return dists, spread, test.threshold


def run_dambreak():
    """WaterBody_TotalMechanicalEnergy at dx=0.025, sampled every 200
    advection steps to t=20 (Dambreak.cpp:146,194-204)."""
    from sphinxsys_jax.cases import dambreak_2d as _db2
    from sphinxsys_jax.engine import scene as _sce

    class dbb:
        build_case = staticmethod(_db2.build_block_case)
        init_sim = staticmethod(_sce.init_sim)
        make_run_chunk = staticmethod(_sce.make_run_chunk)
        blocks_to_particles = staticmethod(_sce.blocks_to_particles)
    from sphinxsys_jax.physics import general as gd

    case, fluid = dbb.build_case(dx=0.025)
    s = dbb.init_sim(case, fluid)

    @jax.jit
    def run_until(s, n_target, t_max):
        def cond(st):
            return (st.n_adv < n_target) & (st.time < t_max)

        return jax.lax.while_loop(cond, lambda st: dbb._advection_step(case, st), s)

    def energy(s):
        p = dbb.blocks_to_particles(case, s, case.base.n_fluid)
        return float(gd.total_mechanical_energy(p, case.base.gravity))

    series = [energy(s)]
    k = 0
    while float(s.time) < 20.0:
        k += 200
        s = run_until(s, jnp.asarray(k, jnp.int32), jnp.asarray(20.0, s.time.dtype))
        assert not bool(s.overflow), "block capacity overflow"
        series.append(energy(s))
        print(f"  n_adv={int(s.n_adv)} t={float(s.time):.3f} E={series[-1]:.5f}",
              flush=True)
    return report("dambreak_2d", "WaterBody", "TotalMechanicalEnergy",
                  series, "test_2d_dambreak")


def run_taylor_green():
    """WaterBody_TotalKineticEnergy (+MaximumSpeed) at dx=0.01, output
    every 0.1 to t=5 from the reference's raw-lattice start (taylor_green.cpp
    setReloadParticles(false)); the lattice-breaking transient in the first
    ~0.5s is part of the reference curve."""
    from sphinxsys_jax.cases import taylor_green_2d as _tg2
    from sphinxsys_jax.engine import scene as _sce

    class tgb:
        build_case = staticmethod(_tg2.build_block_case)
        init_sim = staticmethod(_sce.init_sim)
        make_run_chunk = staticmethod(_sce.make_run_chunk)
        blocks_to_particles = staticmethod(_sce.blocks_to_particles)

    case, fluid = tgb.build_case(dx=0.01, relax_ic=0)
    s = tgb.init_sim(case, fluid)
    run = tgb.make_run_chunk(case)

    def measures(s):
        p = tgb.blocks_to_particles(case, s, case.base.n_fluid)
        v = p["Velocity"]
        v2 = jnp.sum(v * v, axis=-1)
        ke = 0.5 * jnp.sum(p["Mass"] * v2)
        return float(ke), float(jnp.sqrt(jnp.max(v2)))

    ke0, _ = measures(s)
    kes, speeds = [ke0], []
    for i in range(1, 51):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        assert not bool(s.overflow)
        ke, sp = measures(s)
        kes.append(ke)
        speeds.append(sp)
        print(f"  t={float(s.time):.2f} KE={ke:.6f} maxU={sp:.4f}", flush=True)
    r1 = report("taylor_green_2d", "WaterBody", "TotalKineticEnergy", kes,
                "test_2d_taylor_green")
    r2 = report("taylor_green_2d", "WaterBody", "MaximumSpeed", speeds,
                "test_2d_taylor_green")
    return r1, r2


def run_dambreak_3d():
    """3D dambreak WaterBody_TotalMechanicalEnergy at the reference
    dx=0.05 (8000 fluid particles), one snapshot per output interval
    end/20 = 1.0 to t=20 (tests/3d_examples/test_3d_dambreak/dambreak.cpp:
    142-199; 21 snapshots incl. t=0) on the 3D block engine."""
    from sphinxsys_jax.cases import dambreak_3d as _db3
    from sphinxsys_jax.engine import scene as _sce

    class dbb3:
        build_case = staticmethod(_db3.build_block_case)
        init_sim = staticmethod(_sce.init_sim)
        make_run_chunk = staticmethod(_sce.make_run_chunk)
        blocks_to_particles = staticmethod(_sce.blocks_to_particles)

    case, fluid = dbb3.build_case(dx=0.05)
    s = dbb3.init_sim(case, fluid)
    run = dbb3.make_run_chunk(case)

    def energy(s):
        p = dbb3.blocks_to_particles(case, s, case.base.n_fluid)
        pos, vel = p["Position"], p["Velocity"]
        ke = 0.5 * jnp.sum(p["Mass"] * jnp.sum(vel * vel, -1))
        pe = jnp.sum(p["Mass"] * 1.0 * pos[:, 1])   # g = 1, y up
        return float(ke + pe)

    e0 = energy(s)
    # the reference zeroes potential at the initial configuration? No —
    # their snapshot_0 = 0.5 = m g y_cm of the resting column, matching
    # the raw sum; keep the raw sum
    series = [e0]
    for i in range(1, 21):
        s = run(s, jnp.asarray(float(i), s.time.dtype))
        assert not bool(s.overflow), "block capacity overflow"
        series.append(energy(s))
        print(f"  t={float(s.time):.2f} E={series[-1]:.5f}", flush=True)
    return report("dambreak_3d", "WaterBody", "TotalMechanicalEnergy",
                  series,
                  "../3d_examples/test_3d_dambreak")


def run_standing_wave():
    """Standing wave: WaterBody_TotalMechanicalEnergy + the WaveProbe
    FreeSurfaceHeight gauge at dx=0.02, sampled every 200 advection steps
    to t=10 (standing_wave.cpp:195-199 observation_sample_interval; the
    reference DBs hold 102 snapshots; DTW absorbs the small time-base
    difference)."""
    from sphinxsys_jax.cases import standing_wave_2d as sw
    from sphinxsys_jax.physics import general as gd

    case, fluid = sw.build_case(dx=0.02)
    s = sw.init_sim(case, fluid)

    @jax.jit
    def run_until(s, n_target, t_max):
        def cond(st):
            return (st.n_adv < n_target) & (st.time < t_max)

        return jax.lax.while_loop(cond,
                                  lambda st: sw._advection_step(case, st), s)

    def measures(s):
        e = float(gd.total_mechanical_energy(s.fluid, case.gravity))
        h = float(sw.free_surface_height(case, s.fluid))
        return e, h

    e0, h0 = measures(s)
    energies, heights = [e0], [h0]
    k = 0
    while float(s.time) < 10.0:
        k += 200
        s = run_until(s, jnp.asarray(k, jnp.int32),
                      jnp.asarray(10.0, s.time.dtype))
        assert not bool(s.overflow)
        e, h = measures(s)
        energies.append(e)
        heights.append(h)
        print(f"  n_adv={int(s.n_adv)} t={float(s.time):.3f} E={e:.1f} "
              f"h={h:.4f}", flush=True)
    r1 = report("standing_wave_2d", "WaterBody", "TotalMechanicalEnergy",
                energies, "test_2d_standing_wave")
    r2 = report("standing_wave_2d", "WaveProbe", "FreeSurfaceHeight",
                heights, "test_2d_standing_wave")
    return r1, r2


def run_water_entry():
    """Water entry/exit: CylinderObserver_Position (the free rigid center)
    and WettingObserver_Phi (the bottom material point) at the reference
    dx = 2r/40, 13 snapshots over t in [0, 1] (test_2d_water_entry_exit.cpp:
    383-455 records every 200 advection iterations; DTW absorbs the
    time-base difference)."""
    from sphinxsys_jax.cases import water_entry_exit_2d as we

    case, fluid = we.build_case()          # reference dx = 2r/40
    s = we.init_sim(case, fluid)
    run = we.make_run_chunk(case)

    coms = [np.asarray(s.rb.com, np.float64)]
    phis = [float(we.bottom_wetting(case, s))]
    for i in range(1, 13):
        s = run(s, jnp.asarray(i / 12.5, s.time.dtype))
        assert not bool(s.overflow)
        coms.append(np.asarray(s.rb.com, np.float64))
        phis.append(float(we.bottom_wetting(case, s)))
        print(f"  t={float(s.time):.3f} com={np.round(coms[-1], 4)} "
              f"phi={phis[-1]:.4f}", flush=True)

    # Position is a vector observable: write + DTW on (snap, 2) rows
    os.makedirs(os.path.join(OUT, "water_entry_exit_2d"), exist_ok=True)
    path = os.path.join(OUT, "water_entry_exit_2d",
                        "CylinderObserver_Position_Run_0_result.xml")
    data = np.asarray(coms, np.float64)[None]           # (1 obs, snap, 2)
    rg.write_result_xml(path, data)
    print(f"wrote {path} ({data.shape[1]} snapshots)")
    test = rg.DTWRegressionTest(
        os.path.join(REF, "test_2d_water_entry_exit", "regression_test_tool"),
        "CylinderObserver", "Position")
    runs = [rg.read_result_xml(f) for f in test.run_files]
    spread = [float(rg.dtw_distance(a[0], b[0]))
              for a, b in itertools.combinations(runs, 2)]
    dists = [float(d[0]) for d in test.distances(data)]
    print(f"  threshold={test.threshold}  ref pairwise spread="
          f"{np.round(spread, 4)}")
    print(f"  OUR dtw distances: {np.round(dists, 4)}")

    r2 = report("water_entry_exit_2d", "WettingObserver", "Phi", phis,
                "test_2d_water_entry_exit")
    return (dists, spread, test.threshold), r2


def run_square_droplet():
    """WaterBody_TotalKineticEnergy at the reference resolution dx=DL/50,
    101 snapshots every 0.02 to t=2.0 (2d_square_droplet.cpp:188-191,
    end_time/100 output cadence)."""
    from sphinxsys_jax.cases import square_droplet_2d as sq

    case, water, air = sq.build_case()
    s = sq.init_sim(case, water, air)
    run = sq.make_run_chunk(case)

    series = [sq.water_kinetic_energy(s)]
    for i in range(1, 101):
        s = run(s, jnp.asarray(i * 0.02, s.time.dtype))
        assert not bool(s.overflow)
        series.append(sq.water_kinetic_energy(s))
        if i % 10 == 0:
            print(f"  t={float(s.time):.3f} KE={series[-1]:.4f} "
                  f"rmax={sq.water_max_radius(s):.4f}", flush=True)
    return report("square_droplet_2d", "WaterBody", "TotalKineticEnergy",
                  series, "test_2d_square_droplet")


def run_droplet_impact():
    """Droplet impact WaterBody_TotalKineticEnergy: 51 snapshots every
    0.004 to t=0.2 (2d_droplet_impact.cpp:165-166, end_time/50 cadence)."""
    from sphinxsys_jax.cases import droplet_impact_2d as di

    case, water, air = di.build_case()
    s = di.init_sim(case, water, air)
    run = di.make_run_chunk(case)
    series = [di.water_kinetic_energy(s)]
    for i in range(1, 51):
        s = run(s, jnp.asarray(i * 0.004, s.time.dtype))
        assert not bool(s.overflow)
        series.append(di.water_kinetic_energy(s))
        if i % 10 == 0:
            print(f"  t={float(s.time):.3f} KE={series[-1]:.4f}", flush=True)
    return report("droplet_impact_2d", "WaterBody", "TotalKineticEnergy",
                  series, "test_2d_droplet_impact")


def run_roof():
    """Roof CylinderObserver_Position (3-vector) trajectory, 101 snapshots
    every 0.02 to t=2.0 (3d_roof.cpp:162-163, output_period = end_time/100),
    DTW'd against the committed test_3d_roof observer DB.

    Runs in f64: the sag develops by ~1e-9 strain increments per step on a
    25-unit geometry (E = 4.32e8) — f32 position differencing rings and
    misses the endpoint by 20% (measured)."""
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)
    from sphinxsys_jax.cases import roof_3d as rf

    case, s = rf.build_case()
    run = rf.make_run_chunk(case)
    series = [rf.observer_position(case, s)]
    for i in range(1, 101):
        s = run(s, i * rf.END_TIME / 100.0)
        series.append(rf.observer_position(case, s))
        if i % 20 == 0:
            print(f"  t={float(s.time):.3f} "
                  f"displ={series[0][2]-series[-1][2]:.4f}", flush=True)
    displ = series[0][2] - series[-1][2]
    err = abs(displ - rf.DISPL_MAX_REF) / rf.DISPL_MAX_REF
    print(f"  displ_max={displ:.4f} vs oracle {rf.DISPL_MAX_REF} "
          f"({100*err:.1f}%, gate 10%)")
    data = np.asarray(series, dtype=np.float64)[None, :, :]
    os.makedirs(os.path.join(OUT, "roof_3d"), exist_ok=True)
    path = os.path.join(OUT, "roof_3d",
                        "CylinderObserver_Position_Run_0_result.xml")
    rg.write_result_xml(path, data)
    print(f"wrote {path} ({data.shape[1]} snapshots)")
    test = rg.DTWRegressionTest(
        os.path.join(REF, "../3d_examples/test_3d_roof",
                     "regression_test_tool"),
        "CylinderObserver", "Position")
    runs = [rg.read_result_xml(f) for f in test.run_files]
    spread = [float(rg.dtw_distance(a[0], b[0]))
              for a, b in itertools.combinations(runs, 2)]
    dists = [float(d[0]) for d in test.distances(data)]
    print(f"  threshold={test.threshold}  ref pairwise spread="
          f"{np.round(spread, 4)}")
    print(f"  OUR dtw distances: {np.round(dists, 4)}")
    return dists, spread, test.threshold


def run_stlw():
    """STLW FreeSurfaceGauge_FreeSurfaceHeight: 59 snapshots over the 10 s
    physical window (after the reference's 1 s discarded settling,
    stlw.cpp:88-151; our hydrostatic pre-equilibration replaces the settle
    so recording starts at t=0)."""
    from sphinxsys_jax.cases import stlw_2d as sw

    case, fluid = sw.build_case()
    s = sw.init_sim(case, fluid)
    run = sw.make_run_chunk(case)
    series = [float(sw.free_surface_height(case, s.fluid))]
    for i in range(1, 59):
        s = run(s, jnp.asarray(i * 10.0 / 58, s.time.dtype))
        assert not bool(s.overflow)
        series.append(float(sw.free_surface_height(case, s.fluid)))
        if i % 10 == 0:
            print(f"  t={float(s.time):.2f} gauge={series[-1]:.4f}", flush=True)
    return report("stlw_2d", "FreeSurfaceGauge", "FreeSurfaceHeight", series,
                  "test_2d_stlw")


def run_stfb():
    """STFB Observer_Position (rigid com material point) +
    FreeSurfaceGauge, 30 snapshots over 10 s after the 1 s frozen settle
    (stfb.cpp:183-258)."""
    from sphinxsys_jax.cases import stfb_2d as sf

    case, fluid = sf.build_case()
    s = sf.init_sim(case, fluid)       # includes the 1 s frozen settle
    run = sf.make_run_chunk(case)
    coms = [np.asarray(s.rb.com, np.float64)]
    gauges = [float(sf.free_surface_height(case, s.fluid))]
    for i in range(1, 30):
        s = run(s, jnp.asarray(i * 10.0 / 29, s.time.dtype))
        assert not bool(s.overflow)
        coms.append(np.asarray(s.rb.com, np.float64))
        gauges.append(float(sf.free_surface_height(case, s.fluid)))
        print(f"  t={float(s.time):.2f} com={np.round(coms[-1], 4)} "
              f"gauge={gauges[-1]:.4f}", flush=True)

    os.makedirs(os.path.join(OUT, "stfb_2d"), exist_ok=True)
    path = os.path.join(OUT, "stfb_2d", "Observer_Position_Run_0_result.xml")
    data = np.asarray(coms, np.float64)[None]
    rg.write_result_xml(path, data)
    print(f"wrote {path} ({data.shape[1]} snapshots)")
    test = rg.DTWRegressionTest(
        os.path.join(REF, "test_2d_stfb", "regression_test_tool"),
        "Observer", "Position")
    runs = [rg.read_result_xml(f) for f in test.run_files]
    spread = [float(rg.dtw_distance(a[0], b[0]))
              for a, b in itertools.combinations(runs, 2)]
    dists = [float(d[0]) for d in test.distances(data)]
    print(f"  threshold={test.threshold}  ref pairwise spread="
          f"{np.round(spread, 4)}")
    print(f"  OUR dtw distances: {np.round(dists, 4)}")
    r2 = report("stfb_2d", "FreeSurfaceGauge", "FreeSurfaceHeight", gauges,
                "test_2d_stfb")
    return (dists, spread, test.threshold), r2


def run_poiseuille():
    """WaterBody_TotalKineticEnergy to t=100 (poiseuille_flow.cpp:153,204;
    the DB holds 85 snapshots — recorded every 200 iterations — DTW
    absorbs the cadence difference; we sample uniformly)."""
    from sphinxsys_jax.cases import poiseuille_flow_2d as pf

    case, fluid = pf.build_case()
    s = pf.init_sim(case, fluid)
    run = pf.make_run_chunk(case)
    series = [pf.kinetic_energy(s)]       # snapshot 0 at t=0 (ref ite 0)
    for i in range(1, 85):
        s = run(s, jnp.asarray(i * 100.0 / 85, s.time.dtype))
        assert not bool(s.overflow)
        series.append(pf.kinetic_energy(s))
        if i % 10 == 0:
            print(f"  t={float(s.time):.1f} KE={series[-1]:.4f}", flush=True)
    return report("poiseuille_flow_2d", "WaterBody", "TotalKineticEnergy",
                  series, "test_2d_poiseuille_flow")


def run_rotation_patch():
    """WaterBody_TotalKineticEnergy over t=0..8, 22 snapshots at the
    reference dx=1/100 (rotation_patch.cpp:169,194)."""
    from sphinxsys_jax.cases import rotation_patch_2d as rp

    case, fluid = rp.build_case()
    s = rp.init_sim(case, fluid)
    run = rp.make_run_chunk(case)
    series = [rp.kinetic_energy(s)]
    for i in range(1, 22):
        s = run(s, jnp.asarray(i * 8.0 / 21, s.time.dtype))
        assert not bool(s.overflow)
        series.append(rp.kinetic_energy(s))
        print(f"  t={float(s.time):.2f} KE={series[-1]:.5f}", flush=True)
    return report("rotation_patch_2d", "WaterBody", "TotalKineticEnergy",
                  series, "test_2d_rotation_patch")


def run_static_confinement():
    """WaterBody_TotalMechanicalEnergy, sampled every 200 advection steps
    to t=20 (static_confinement.cpp:186,236-238) — level-set walls, no
    boundary particles."""
    from sphinxsys_jax.cases import static_confinement_2d as sc

    case, fluid = sc.build_case()
    s = sc.init_sim(case, fluid)

    @jax.jit
    def run_until(s, n_target, t_max):
        return jax.lax.while_loop(
            lambda st: (st.n_adv < n_target) & (st.time < t_max),
            lambda st: sc._advection_step(case, st), s)

    series = [sc.mechanical_energy(case, s)]
    k = 0
    while float(s.time) < 20.0:
        k += 200
        s = run_until(s, jnp.asarray(k, jnp.int32),
                      jnp.asarray(20.0, s.time.dtype))
        assert not bool(s.overflow)
        series.append(sc.mechanical_energy(case, s))
        print(f"  n_adv={int(s.n_adv)} t={float(s.time):.3f} "
              f"E={series[-1]:.5f}", flush=True)
    return report("static_confinement_2d", "WaterBody",
                  "TotalMechanicalEnergy", series,
                  "test_2d_static_confinement")


def run_throat():
    """FluidBody_TotalKineticEnergy, recorded every 20 advection steps to
    t=40 (throat.cpp:216-218,258-266) — Oldroyd-B viscoelastic flow."""
    from sphinxsys_jax.cases import throat_2d as th

    case, fluid = th.build_case()
    s = th.init_sim(case, fluid)

    @jax.jit
    def run_until(s, n_target, t_max):
        return jax.lax.while_loop(
            lambda st: (st.n_adv < n_target) & (st.time < t_max),
            lambda st: th._advection_step(case, st), s)

    series = []
    k = 0
    while float(s.time) < 40.0:
        k += 20
        s = run_until(s, jnp.asarray(k, jnp.int32),
                      jnp.asarray(40.0, s.time.dtype))
        assert not bool(s.overflow)
        series.append(th.kinetic_energy(s))
        print(f"  n_adv={int(s.n_adv)} t={float(s.time):.3f} "
              f"KE={series[-1]:.6f}", flush=True)
    return report("throat_2d", "FluidBody", "TotalKineticEnergy", series,
                  "test_2d_throat")


def run_twisting_column():
    """MyObserver_Position tip trajectory to t=0.5 (twisting_column.cpp
    records every acoustic step; we sample every 20 — DTW aligns the
    cadences).  3D DB lives under tests/3d_examples."""
    from sphinxsys_jax.cases import twisting_column_3d as tw

    case, column = tw.build_case()
    s = tw.init_sim(case, column)
    idx, w = tw.tip_observer(case, column)

    @jax.jit
    def run_until(s, n_target):
        return jax.lax.while_loop(lambda st: st.n_steps < n_target,
                                  lambda st: tw._step(case, st), s)

    series = [tw.observe_tip(s, idx, w)]
    k = 0
    while float(s.time) < 0.5:
        k += 20
        s = run_until(s, jnp.asarray(k, jnp.int32))
        series.append(tw.observe_tip(s, idx, w))
    print(f"  {len(series)} snapshots, tip x range "
          f"[{min(p[0] for p in series):.3f}, {max(p[0] for p in series):.3f}]")
    os.makedirs(os.path.join(OUT, "twisting_column_3d"), exist_ok=True)
    path = os.path.join(OUT, "twisting_column_3d",
                        "MyObserver_Position_Run_0_result.xml")
    data = np.asarray(series, dtype=np.float64)[None, :, :]
    rg.write_result_xml(path, data)
    print(f"wrote {path}")
    test = rg.DTWRegressionTest(
        "/root/reference/tests/3d_examples/test_3d_twisting_column/"
        "regression_test_tool", "MyObserver", "Position")
    dists = [float(d[0]) for d in test.distances(data)]
    print(f"  OUR dtw distances: {np.round(dists, 4)}")
    return dists


def run_self_contact():
    """BeamObserver_Position tip trajectory to t=1.0, 101 snapshots
    (self_contact.cpp:178-181, output_interval = 0.01*T0)."""
    from sphinxsys_jax.cases import self_contact_2d as sc

    case, beam = sc.build_case()
    s = sc.init_sim(case, beam)
    run = sc.make_run_chunk(case)
    idx, w = sc.tip_observer(case, beam)
    series = [sc.observe_tip(s, idx, w)]
    for i in range(1, 101):
        s = run(s, jnp.asarray(i * 0.01, s.time.dtype))
        assert not bool(s.overflow)
        series.append(sc.observe_tip(s, idx, w))
        if i % 10 == 0:
            print(f"  t={float(s.time):.2f} tip={np.round(series[-1], 4)}",
                  flush=True)

    os.makedirs(os.path.join(OUT, "self_contact_2d"), exist_ok=True)
    path = os.path.join(OUT, "self_contact_2d",
                        "BeamObserver_Position_Run_0_result.xml")
    data = np.asarray(series, dtype=np.float64)[None, :, :]
    rg.write_result_xml(path, data)
    print(f"wrote {path} ({data.shape[1]} snapshots)")
    test = rg.DTWRegressionTest(
        os.path.join(REF, "test_2d_self_contact", "regression_test_tool"),
        "BeamObserver", "Position")
    runs = [rg.read_result_xml(f) for f in test.run_files]
    spread = [float(rg.dtw_distance(a[0], b[0]))
              for a, b in itertools.combinations(runs, 2)]
    dists = [float(d[0]) for d in test.distances(data)]
    print(f"  threshold={test.threshold}  ref pairwise spread="
          f"{np.round(spread, 4)}")
    print(f"  OUR dtw distances: {np.round(dists, 4)}")
    return dists, spread


def run_heat_transfer():
    """FluidObserver Phi at (0, DH/2), 100 snapshots to t=10
    (heat_transfer.cpp:284-286) vs the reference's ENSEMBLE-averaged DB
    (RegressionTestEnsembleAverage, cpp:253)."""
    from sphinxsys_jax.cases import heat_transfer_2d as ht

    case, fluid = ht.build_case()
    s = ht.init_sim(case, fluid)
    run = ht.make_run_chunk(case)
    series = [ht.observe_phi(case, s)]
    for i in range(1, 101):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        assert not bool(s.overflow)
        series.append(ht.observe_phi(case, s))
        if i % 10 == 0:
            print(f"  t={float(s.time):.2f} phi_obs={series[-1]:.5f}",
                  flush=True)

    os.makedirs(os.path.join(OUT, "heat_transfer_2d"), exist_ok=True)
    path = os.path.join(OUT, "heat_transfer_2d",
                        "FluidObserver_Phi_Run_0_result.xml")
    # the reference discards its first snapshot (writeToFile before the
    # loop is Snapshot_0, DB starts at Snapshot_17); align on the 100
    # in-loop outputs
    data = np.asarray(series[1:], dtype=np.float64)[:, None]  # (snaps, 1 obs)
    rg.write_result_xml(path, data[:, 0][None, :])
    print(f"wrote {path} ({data.shape[0]} snapshots)")

    ens = rg.EnsembleAverageRegressionTest(
        os.path.join(REF, "test_2d_heat_transfer", "regression_test_tool"),
        "FluidObserver", "Phi")
    mean, var = ens.read_db()
    n = min(len(data), len(mean))
    ok, msg = ens.test(data[:n])
    dev = np.abs(data[:n, 0] - mean[:n].reshape(n))
    excursion = float(mean.max() - mean.min())
    print(f"  ensemble test: {ok} ({msg})")
    print(f"  max |ours-mean| = {dev.max():.4f}, excursion {excursion:.3f}, "
          f"ratio {dev.max() / excursion:.3f}")
    return dev.max(), excursion


def run_column_collapse():
    """GranularBody_TotalMechanicalEnergy at dx=LH/50, sampled every 1000
    acoustic steps to t=0.8 (column_collapse.cpp:131-188)."""
    from sphinxsys_jax.cases import column_collapse_2d as cc
    from sphinxsys_jax.physics import general as gd

    case, soil = cc.build_case()
    s = cc.init_sim(case, soil)

    @jax.jit
    def run_until(s, n_target, t_max):
        def cond(st):
            return (st.n_ac < n_target) & (st.time < t_max)

        return jax.lax.while_loop(cond, lambda st: cc._advection_step(case, st), s)

    def energy(s):
        return float(gd.total_mechanical_energy(s.soil, case.gravity))

    series = [energy(s)]
    k = 0
    while float(s.time) < 0.8:
        k += 1000
        s = run_until(s, jnp.asarray(k, jnp.int32), jnp.asarray(0.8, s.time.dtype))
        assert not bool(s.overflow)
        series.append(energy(s))
        print(f"  n_ac={int(s.n_ac)} t={float(s.time):.4f} E={series[-1]:.4f}",
              flush=True)
    return report("column_collapse_2d", "GranularBody",
                  "TotalMechanicalEnergy", series, "test_2d_column_collapse")





def _pressure_probe(case, obs):
    import jax as _jax
    from sphinxsys_jax.io.observation import observe_quantity
    from sphinxsys_jax.neighbors import build_cell_table, build_neighbor_list

    @_jax.jit
    def probe(f):
        valid = f.get("Alive", None)
        n = f["NReal"] if valid is None else valid
        table = build_cell_table(f["Position"], n, case.grid,
                                 cap=case.cell_cap)
        nl = build_neighbor_list(obs, jnp.asarray(1, jnp.int32),
                                 f["Position"], n, table, case.grid,
                                 case.adaptation.cutoff, k_max=64,
                                 include_self=True)
        return observe_quantity(obs, f, "Pressure", nl, case.kernel, 2)[0]

    return probe


def run_t_pipe():
    """WaterBody_TotalKineticEnergy to t=100 (T_shaped_pipe end_time=100;
    the DB holds 33 snapshots — DTW absorbs cadence)."""
    from sphinxsys_jax.cases import t_pipe_2d as tp

    case, fluid = tp.build_case()
    s = tp.init_sim(case, fluid)
    run = tp.make_run_chunk(case)
    series = []
    for i in range(1, 34):
        s = run(s, jnp.asarray(i * 100.0 / 33, s.time.dtype))
        assert not bool(s.overflow)
        series.append(tp.kinetic_energy(s))
        if i % 5 == 0:
            print(f"  t={float(s.time):.1f} KE={series[-1]:.4f}", flush=True)
    return report("t_pipe_2d", "WaterBody", "TotalKineticEnergy",
                  series, "test_2d_T_shaped_pipe")


def run_two_phase():
    """FluidObserver_Pressure at the reference probe (DL, 0.01?) — the
    two-phase dambreak observer (two_phase_dambreak.cpp:33-35), sampled
    every 200 iterations to t=10 (14 DB snapshots)."""
    from sphinxsys_jax.cases import two_phase_dambreak_2d as tpd

    case, water, air = tpd.build_case()
    s = tpd.init_sim(case, water, air)
    run = tpd.make_run_chunk(case)
    import numpy as _np
    obs = jnp.asarray([[tpd.DL, 0.2]], water["Position"].dtype)
    probe = _pressure_probe(case, obs)
    series = []
    for i in range(1, 15):
        s = run(s, jnp.asarray(i * 10.0 / 14, s.time.dtype))
        assert not bool(s.overflow)
        series.append(float(probe(s.water)))
        print(f"  t={float(s.time):.2f} p={series[-1]:.4f}", flush=True)
    return report("two_phase_dambreak_2d", "FluidObserver", "Pressure",
                  series, "test_2d_two_phase_dambreak")


def run_filling_tank():
    """FluidObserver_Pressure at (DL, 0.2), 294 DB snapshots to t=30
    (filling_tank.cpp:25,167-169)."""
    from sphinxsys_jax.cases import filling_tank_2d as ft

    case, fluid = ft.build_case()
    s = ft.init_sim(case, fluid)
    run = ft.make_run_chunk(case)
    import numpy as _np
    obs = jnp.asarray([[ft.DL, 0.2]], fluid["Position"].dtype)
    probe = _pressure_probe(case, obs)
    series = []
    for i in range(1, 295):
        s = run(s, jnp.asarray(i * 30.0 / 294, s.time.dtype))
        assert not bool(s.overflow)
        series.append(float(probe(s.fluid)))
        if i % 30 == 0:
            print(f"  t={float(s.time):.2f} p={series[-1]:.4f}", flush=True)
    return report("filling_tank_2d", "FluidObserver", "Pressure",
                  series, "test_2d_filling_tank")


def run_hydrostatic_fsi():
    """Gate mid-point Position (ensemble DB, 913 snapshots over t=0.5,
    hydrostatic_fsi.cpp:48,311-313).  We sample 200 uniform snapshots and
    compare DTW-to-ensemble-mean."""
    from sphinxsys_jax.cases import hydrostatic_fsi_2d as hf

    case, fluid, gate = hf.build_case()
    s = hf.init_sim(case, fluid, gate)
    run = hf.make_run_chunk(case)
    import numpy as _np
    p0 = _np.asarray([0.5 * hf.DL, -0.5 * hf.GATE_T])
    g0 = _np.asarray(gate["Position"])
    i_obs = int(_np.argmin(_np.linalg.norm(g0 - p0, axis=1)))
    series = []
    for i in range(1, 201):
        s = run(s, jnp.asarray(i * 0.5 / 200, s.time.dtype))
        assert not bool(s.overflow)
        series.append(_np.asarray(s.gate["Position"][i_obs]))
        if i % 20 == 0:
            print(f"  t={float(s.time):.3f} pos={series[-1]}", flush=True)
    # ensemble DB: compare DTW to the mean curve
    import itertools as _it
    t = rg.EnsembleAverageRegressionTest(
        os.path.join(REF, "test_2d_hydrostatic_fsi", "regression_test_tool"),
        "Observer", "Position")
    mean, var = t.read_db()
    d = float(rg.dtw_distance(np.asarray(series, np.float64), mean[:, 0]))
    os.makedirs(os.path.join(OUT, "hydrostatic_fsi_2d"), exist_ok=True)
    rg.write_result_xml(os.path.join(OUT, "hydrostatic_fsi_2d",
                                     "Observer_Position_Run_0_result.xml"),
                        np.asarray(series, np.float64)[None])
    print(f"  DTW to ensemble mean: {d:.4f} (signal scale "
          f"{float(np.abs(mean).max()):.4f})")
    return d


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    print("backend:", jax.default_backend())
    if which in ("dambreak", "all"):
        run_dambreak()
    if which in ("taylor_green", "all"):
        run_taylor_green()
    if which in ("column_collapse", "all"):
        run_column_collapse()
    if which in ("dambreak_3d", "all"):
        run_dambreak_3d()
    if which in ("standing_wave", "all"):
        run_standing_wave()
    if which in ("water_entry", "all"):
        run_water_entry()
    if which in ("square_droplet", "all"):
        run_square_droplet()
    if which in ("droplet_impact", "all"):
        run_droplet_impact()
    if which in ("t_pipe", "all"):
        run_t_pipe()
    if which in ("two_phase", "all"):
        run_two_phase()
    if which in ("filling_tank", "all"):
        run_filling_tank()
    if which in ("hydrostatic_fsi", "all"):
        run_hydrostatic_fsi()
    if which in ("roof", "all"):
        run_roof()
    if which in ("stlw", "all"):
        run_stlw()
    if which in ("stfb", "all"):
        run_stfb()
    if which in ("heat_transfer", "all"):
        run_heat_transfer()
    if which in ("poiseuille", "all"):
        run_poiseuille()
    if which in ("rotation_patch", "all"):
        run_rotation_patch()
    if which in ("static_confinement", "all"):
        run_static_confinement()
    if which in ("throat", "all"):
        run_throat()
    if which in ("twisting_column", "all"):
        run_twisting_column()
    if which in ("self_contact", "all"):
        run_self_contact()
