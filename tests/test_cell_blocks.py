"""Cell-block engine tests: slotting correctness and physics parity with
the gather-based neighbor-list engine."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sphinxsys_jax.neighbors import grid_from_bounds
from sphinxsys_jax.neighbors.cell_blocks import (
    build_block_map, cross_neighbor_blocks, to_blocks, from_blocks,
)

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def random_cloud(n, dim, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n, dim))


def test_block_map_slots_every_particle():
    n = 500
    pos = jnp.asarray(random_cloud(n, 2, 1), jnp.float32)
    grid = grid_from_bounds([0, 0], [1, 1], 0.11)
    bm = build_block_map(pos, jnp.int32(n), grid, cap=16, c_max=256)
    assert not bool(bm.overflow)
    sp = np.asarray(bm.slot_particle)
    filled = sp[sp < n]
    assert len(filled) == n and len(set(filled)) == n  # every particle exactly once
    # inverse map consistency
    ps = np.asarray(bm.particle_slot)
    for i in range(0, n, 37):
        assert sp[ps[i]] == i


def test_block_map_occ_cells_sorted_and_correct():
    n = 300
    pos = jnp.asarray(random_cloud(n, 2, 2), jnp.float32)
    grid = grid_from_bounds([0, 0], [1, 1], 0.2)
    bm = build_block_map(pos, jnp.int32(n), grid, cap=32, c_max=128)
    occ = np.asarray(bm.occ_cells)
    n_occ = int(bm.n_occ)
    real = occ[:n_occ]
    assert (np.diff(real) > 0).all()  # strictly sorted, unique
    expected = np.unique(np.asarray(grid.cell_id(pos)))
    np.testing.assert_array_equal(real, expected)


def test_block_pairs_match_brute_force():
    """All pairs recovered by the window sweep == brute force."""
    n = 400
    cutoff = 0.15
    pos_np = random_cloud(n, 2, 3)
    pos = jnp.asarray(pos_np, jnp.float32)
    grid = grid_from_bounds([0, 0], [1, 1], cutoff)
    bm = build_block_map(pos, jnp.int32(n), grid, cap=24, c_max=256)
    assert not bool(bm.overflow)
    pos_b = to_blocks(bm, pos, fill=1e16)
    sp = np.asarray(bm.slot_particle).reshape(256, 24)
    nbr = np.asarray(bm.nbr_block)
    pairs = set()
    pb = np.asarray(pos_b)
    for c in range(int(bm.n_occ)):
        for w in range(9):
            jblk = nbr[c, w]
            for a in range(24):
                i = sp[c, a]
                if i >= n:
                    continue
                for b in range(24):
                    jp = sp[jblk, b] if jblk < 256 else n
                    if jp >= n or jp == i:
                        continue
                    if np.linalg.norm(pos_np[i] - pos_np[jp]) < cutoff:
                        pairs.add((i, jp))
    from sphinxsys_jax.neighbors import brute_force_neighbors
    expected = brute_force_neighbors(pos_np, n, pos_np, n, cutoff, include_self=False)
    assert pairs == expected


def test_to_from_blocks_roundtrip():
    n = 200
    pos = jnp.asarray(random_cloud(n, 2, 4), jnp.float32)
    grid = grid_from_bounds([0, 0], [1, 1], 0.13)
    bm = build_block_map(pos, jnp.int32(n), grid, cap=16, c_max=256)
    vals = jnp.asarray(np.random.default_rng(5).normal(size=(n, 2)), jnp.float32)
    blocks = to_blocks(bm, vals)
    back = from_blocks(bm, blocks, n)
    np.testing.assert_allclose(np.asarray(back), np.asarray(vals), rtol=0, atol=0)


def test_block_overflow_detection():
    pos = jnp.asarray(np.zeros((40, 2)), jnp.float32)  # one cell
    grid = grid_from_bounds([0, 0], [1, 1], 0.5)
    bm = build_block_map(pos, jnp.int32(40), grid, cap=8, c_max=64)
    assert bool(bm.overflow)
    # c_max overflow
    pos2 = jnp.asarray(random_cloud(300, 2, 6), jnp.float32)
    grid2 = grid_from_bounds([0, 0], [1, 1], 0.05)
    bm2 = build_block_map(pos2, jnp.int32(300), grid2, cap=8, c_max=16)
    assert bool(bm2.overflow)


def test_dambreak_block_matches_gather_engine():
    """The block engine must reproduce the gather engine to fp32 roundoff
    (same math, different summation layout)."""
    from sphinxsys_jax.cases import dambreak_2d as db
    from sphinxsys_jax.engine import scene as sc
    from sphinxsys_jax.physics import general as gd

    case_g, fluid_g = db.build_case(dx=0.1)
    sg = db.init_sim(case_g, fluid_g)
    sg = db.make_run_chunk(case_g)(sg, jnp.asarray(0.5, sg.time.dtype))

    scene, fluid_b0 = db.build_block_case(dx=0.1)
    sb = sc.init_sim(scene, fluid_b0)
    sb = sc.make_run_chunk(scene)(sb, jnp.asarray(0.5, sb.time.dtype))
    assert not bool(sb.overflow)
    assert int(sg.n_ac) == int(sb.n_ac)

    pg = sc.blocks_to_particles(scene, sb)
    eg = float(gd.total_mechanical_energy(sg.fluid, case_g.gravity))
    eb = float(gd.total_mechanical_energy(pg, scene.base.gravity))
    assert abs(eb - eg) / abs(eg) < 1e-5
    xg = np.sort(np.asarray(sg.fluid["Position"][: case_g.n_fluid, 0]))
    xb = np.sort(np.asarray(pg["Position"][:, 0]))
    assert np.abs(xg - xb).max() < 1e-4
