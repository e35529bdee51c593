"""Distributed block engine (parallel/block_domain.py): matched-step
parity vs the single-device block engine on the 8-virtual-device mesh.

Both runs take IDENTICAL time steps (the distributed dt reduces exclude
ghost slots, so local-max + pmax equals the global masked max exactly),
so after k advection steps every particle (matched by OriginalID) must
sit at the same position up to halo-staleness differences — the frozen
ghost-band model refreshes values, not membership, within a step."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import dambreak_2d as db
from sphinxsys_jax.engine import scene as sc
from sphinxsys_jax.parallel import block_domain as bd
from sphinxsys_jax.parallel.mesh import make_particle_mesh

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

N_DEV = 8


def _final_positions_single(scene, fluid, n_steps):
    s = sc.init_sim(scene, fluid)
    step = sc.make_advection_step(scene)
    for _ in range(n_steps):
        s = step(s)
    assert not bool(s.overflow)
    n = fluid["Position"].shape[0]
    flat = sc.blocks_to_particles(scene, s, n)
    return np.asarray(flat["Position"]), float(s.time), int(s.n_ac)


def test_block_domain_matches_single_device():
    if len(jax.devices()) < N_DEV:
        import pytest
        pytest.skip("needs 8 virtual devices")
    mesh = make_particle_mesh(N_DEV)
    scene, fluid = db.build_block_case(dx=0.05, cap=12)

    pos_ref, t_ref, nac_ref = _final_positions_single(scene, fluid, 4)

    hsim = bd.distribute_block_engine(scene.eng, fluid, mesh)
    step = bd.make_distributed_engine_step(
        scene.eng, mesh, wall_b=scene.wall_b, bm_wall=scene.bm_wall,
        wall_dense_map=scene.wall_dense_map, halo_cap=128, migrate_cap=64)
    n0 = int(jnp.sum(hsim.fluid["Alive"]))
    for _ in range(4):
        hsim = step(hsim)
    jax.block_until_ready(hsim.fluid["Position"])
    assert not bool(hsim.overflow)
    assert int(jnp.sum(hsim.fluid["Alive"])) == n0

    # identical step counts and times (dt parity is exact)
    assert int(hsim.n_ac) == nac_ref, (int(hsim.n_ac), nac_ref)
    np.testing.assert_allclose(float(hsim.time), t_ref, rtol=1e-12)

    # gather distributed positions by OriginalID
    alive = np.asarray(hsim.fluid["Alive"])
    ids = np.asarray(hsim.fluid["OriginalID"])[alive]
    pos = np.asarray(hsim.fluid["Position"])[alive]
    n = int(fluid["NReal"])
    assert sorted(ids.tolist()) == list(range(n))
    pos_by_id = np.zeros((n, 2))
    pos_by_id[ids] = pos

    scale = scene.grid.spacing[0] * scene.grid.shape[0]
    err = np.abs(pos_by_id - pos_ref[:n]).max()
    assert err < 1e-3 * scale, f"max position error {err} vs scale {scale}"


def test_block_domain_conserves_and_stays_bounded_longer():
    """12 advection steps through the surge: particles conserved, no
    overflow, front advances monotonically."""
    if len(jax.devices()) < N_DEV:
        import pytest
        pytest.skip("needs 8 virtual devices")
    mesh = make_particle_mesh(N_DEV)
    scene, fluid = db.build_block_case(dx=0.05, cap=12)
    hsim = bd.distribute_block_engine(scene.eng, fluid, mesh)
    step = bd.make_distributed_engine_step(
        scene.eng, mesh, wall_b=scene.wall_b, bm_wall=scene.bm_wall,
        wall_dense_map=scene.wall_dense_map, halo_cap=128, migrate_cap=64)
    n0 = int(jnp.sum(hsim.fluid["Alive"]))
    fronts = []
    for _ in range(12):
        hsim = step(hsim)
        alive = np.asarray(hsim.fluid["Alive"])
        fronts.append(np.asarray(hsim.fluid["Position"])[alive, 0].max())
    assert not bool(hsim.overflow)
    assert int(jnp.sum(hsim.fluid["Alive"])) == n0
    assert fronts[-1] >= fronts[0]
    assert fronts[-1] < 5.4   # inside the tank
