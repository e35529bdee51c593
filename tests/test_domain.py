"""Generic slab-decomposition tests (parallel/domain.py + halo_cases.py) on
the 8-device virtual CPU mesh: two different cases through one API, with a
matched-step parity bound (VERDICT r1 weak #6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import dambreak_2d as db
from sphinxsys_jax.cases import taylor_green_2d as tg
from sphinxsys_jax.parallel import halo_cases as hc
from sphinxsys_jax.parallel.mesh import make_particle_mesh

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def _gather_by_id(shard_fluid, n_real):
    """Order a distributed state by OriginalID for comparison."""
    ids = np.asarray(shard_fluid["OriginalID"])
    alive = np.asarray(shard_fluid["Alive"])
    out = {}
    for k in ("Position", "Velocity", "Density"):
        v = np.asarray(shard_fluid[k])
        arr = np.zeros((n_real,) + v.shape[1:], v.dtype)
        arr[ids[alive]] = v[alive]
        out[k] = arr
    return out


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_particle_mesh(8)


def test_dambreak_matched_step_parity(mesh8):
    """Distributed and single-device dambreak take IDENTICAL time steps
    (global pmax reduces match the single-device max exactly), so after a
    fixed number of advection steps the trajectories must agree to float
    accumulation error — a far tighter bound than energy comparison."""
    case, fluid = db.build_case(dx=0.12, cell_cap=16, k_inner=48, k_wall=32)
    n_real = int(fluid["NReal"])
    fluid = dict(fluid)
    fluid["OriginalID"] = jnp.arange(fluid["Position"].shape[0], dtype=jnp.int32)

    sim_d = hc.distribute_dambreak(case, fluid, mesh8)
    step_d = hc.make_halo_dambreak_step(case, mesh8, halo_cap=96,
                                        migrate_cap=48)

    sim_s = db.init_sim(case, {k: v for k, v in fluid.items()
                               if k != "OriginalID"})
    step_s = db.make_advection_step(case)

    n_steps = 6
    for _ in range(n_steps):
        sim_d = step_d(sim_d)
        sim_s = step_s(sim_s)

    assert not bool(sim_d.overflow)
    assert int(sim_d.n_adv) == int(sim_s.n_adv) == n_steps
    # identical step counts at identical dt
    assert int(sim_d.n_ac) == int(sim_s.n_ac)
    np.testing.assert_allclose(float(sim_d.time), float(sim_s.time),
                               rtol=1e-6)

    got = _gather_by_id(sim_d.fluid, n_real)
    # single-device case never reorders IDs mid-run until a Morton resort;
    # with 6 steps < sort_every the prefix order is the ID order
    want_pos = np.asarray(sim_s.fluid["Position"])[:n_real]
    want_vel = np.asarray(sim_s.fluid["Velocity"])[:n_real]
    scale = np.abs(want_pos).max()
    np.testing.assert_allclose(got["Position"], want_pos, atol=1e-3 * scale)
    np.testing.assert_allclose(got["Velocity"], want_vel, atol=2e-3)


def test_taylor_green_distributed(mesh8):
    """Second case through the same API: periodic ring decomposition.
    Particles conserved, no overflow, kinetic energy decays toward the
    viscous rate as in the single-device run."""
    case, fluid = tg.build_case(dx=0.05)
    n_real = int(fluid["NReal"])
    fluid = dict(fluid)
    fluid["OriginalID"] = jnp.arange(fluid["Position"].shape[0], dtype=jnp.int32)

    sim_d = hc.distribute_taylor_green(case, fluid, mesh8)
    step_d = hc.make_halo_taylor_green_step(case, mesh8, halo_cap=128,
                                            migrate_cap=64)
    import functools

    sim_s = tg.init_sim(case, {k: v for k, v in fluid.items()
                               if k != "OriginalID"})
    step_s = jax.jit(functools.partial(tg._advection_step, case))

    n0 = int(jnp.sum(sim_d.fluid["Alive"]))
    for _ in range(4):
        sim_d = step_d(sim_d)
        sim_s = step_s(sim_s)

    assert not bool(sim_d.overflow)
    assert int(jnp.sum(sim_d.fluid["Alive"])) == n0 == n_real
    assert int(sim_d.n_ac) == int(sim_s.n_ac)

    # kinetic energy parity at matched steps
    m = np.asarray(sim_d.fluid["Alive"])
    ke_d = float(np.sum(0.5 * np.asarray(sim_d.fluid["Mass"])[m]
                        * np.sum(np.asarray(sim_d.fluid["Velocity"])[m] ** 2, -1)))
    nr = int(sim_s.fluid["NReal"])
    ke_s = float(np.sum(0.5 * np.asarray(sim_s.fluid["Mass"])[:nr]
                        * np.sum(np.asarray(sim_s.fluid["Velocity"])[:nr] ** 2, -1)))
    assert abs(ke_d - ke_s) / ke_s < 1e-3

    got = _gather_by_id(sim_d.fluid, n_real)
    want = np.asarray(sim_s.fluid["Position"])[:n_real]
    # circular distance: a crosser's coordinate differs by exactly one
    # period (the single-device case wraps at step end, the distributed one
    # wraps at the next step's migration)
    L = np.asarray(case.box)
    d = np.abs(got["Position"] - want)
    d = np.minimum(d, L - d)
    assert d.max() < 1e-3 * L.max(), f"max circular position error {d.max()}"



def test_beam_distributed_matched_step_parity(mesh8):
    """Third physics family through the same API: total-Lagrangian solid.

    The beam decomposes over the REFERENCE configuration (migrate=False,
    band_coord="InitialPosition"): owners and halo bands are static, the
    only per-step communication is the halo value refresh plus the global
    pmin for the elastic acoustic dt (carried in the replicated aux, as
    the reference computes dt AFTER each step — oscillating_beam.cpp loop).
    Matched steps => trajectories agree to float accumulation error."""
    from sphinxsys_jax.cases import oscillating_beam_2d as ob

    case, sim_s = ob.build_case()
    n = case.n_solid
    solid = dict(sim_s.solid)
    solid["OriginalID"] = jnp.arange(solid["Position"].shape[0],
                                     dtype=jnp.int32)

    sim_d = hc.distribute_beam(case, solid, mesh8)
    step_d = hc.make_halo_beam_step(case, mesh8)
    step_s = jax.jit(lambda s: ob._step(case, s))

    for _ in range(8):
        sim_d = step_d(sim_d)
        sim_s = step_s(sim_s)

    assert not bool(sim_d.overflow)
    assert int(jnp.sum(sim_d.fluid["Alive"])) == n
    np.testing.assert_allclose(float(sim_d.time), float(sim_s.time),
                               rtol=1e-6)

    got = _gather_by_id(sim_d.fluid, n)
    want_pos = np.asarray(sim_s.solid["Position"])[:n]
    want_vel = np.asarray(sim_s.solid["Velocity"])[:n]
    np.testing.assert_allclose(got["Position"], want_pos, atol=1e-6)
    np.testing.assert_allclose(got["Velocity"], want_vel, atol=1e-4)


def test_fsi2_distributed_matched_step_parity(mesh8):
    """Distributed fsi2 (VERDICT r2 item 5): x-periodic fluid slabs + a
    REPLICATED elastic insert whose fluid forces are psum'd over the ring.
    Same-dt matched-step parity against the single-device case."""
    from sphinxsys_jax.cases import fsi2

    case, fluid, solid = fsi2.build_case(dx=0.1)
    n_real = int(fluid["NReal"])
    fluid = dict(fluid)
    fluid["OriginalID"] = jnp.arange(fluid["Position"].shape[0],
                                     dtype=jnp.int32)

    sim_d = hc.distribute_fsi2(case, fluid, solid, mesh8)
    step_d = hc.make_halo_fsi2_step(case, mesh8, halo_cap=128,
                                    migrate_cap=64)

    sim_s = fsi2.init_sim(case, {k: v for k, v in fluid.items()
                                 if k != "OriginalID"}, solid)
    step_s = jax.jit(lambda s: fsi2._advection_step(case, s))

    n_steps = 4
    for _ in range(n_steps):
        sim_d = step_d(sim_d)
        sim_s = step_s(sim_s)

    assert not bool(sim_d.overflow)
    assert int(sim_d.n_adv) == int(sim_s.n_adv) == n_steps
    assert int(sim_d.n_ac) == int(sim_s.n_ac)

    got = _gather_by_id(sim_d.fluid, n_real)
    n_f = int(sim_s.fluid["NReal"])
    np.testing.assert_allclose(got["Velocity"][:n_f],
                               np.asarray(sim_s.fluid["Velocity"])[:n_f],
                               atol=2e-3)
    # the replicated solid matches the single-device solid
    solid_d = sim_d.aux[0]
    np.testing.assert_allclose(np.asarray(solid_d["Position"]),
                               np.asarray(sim_s.solid["Position"]),
                               atol=1e-4)
    assert int(sim_d.aux[1]) == int(sim_s.n_s)
    np.testing.assert_allclose(float(sim_d.aux[2]), float(sim_s.time),
                               rtol=1e-5)


def test_block_engine_generic_distributed_3d(mesh8):
    """VERDICT r3 item 7: the case-agnostic BlockEngine routed through ONE
    generic distributed wrapper (parallel/block_domain.py
    make_distributed_engine_step) — the 3D dambreak runs distributed with
    ZERO case-specific distribution code, matched-step parity vs the
    single-device block engine."""
    from sphinxsys_jax.cases import dambreak_3d as db3
    from sphinxsys_jax.engine import scene as sc
    from sphinxsys_jax.parallel import block_domain as bdm

    case, fluid = db3.build_block_case(dx=0.1)
    n_real = int(fluid["NReal"])

    sim_s = sc.init_sim(case, fluid)
    step_s = sc.make_advection_step(case)

    sim_d = bdm.distribute_block_engine(case.eng, fluid, mesh8)
    step_d = bdm.make_distributed_engine_step(
        case.eng, mesh8, wall_b=case.wall_b, bm_wall=case.bm_wall,
        wall_dense_map=case.wall_dense_map, halo_cap=160, migrate_cap=64)

    n_steps = 5
    for _ in range(n_steps):
        sim_d = step_d(sim_d)
        sim_s = step_s(sim_s)

    assert not bool(sim_d.overflow)
    assert int(sim_d.n_adv) == n_steps
    assert int(sim_d.n_ac) == int(sim_s.n_ac)
    np.testing.assert_allclose(float(sim_d.time), float(sim_s.time),
                               rtol=1e-6)

    got = _gather_by_id(sim_d.fluid, n_real)
    ps = sc.blocks_to_particles(case, sim_s, n_real)
    want_pos = np.asarray(ps["Position"])[:n_real]
    want_vel = np.asarray(ps["Velocity"])[:n_real]
    scale = np.abs(want_pos).max()
    np.testing.assert_allclose(got["Position"], want_pos, atol=1e-3 * scale)
    np.testing.assert_allclose(got["Velocity"], want_vel, atol=2e-3)
