"""Neighbor-engine correctness: cell table + fixed-cap neighbor lists vs a
brute-force O(N^2) reference (the validation strategy SURVEY.md §7 calls
for; analog of the reference's exclusive-scan/configuration unit tests)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sphinxsys_jax.neighbors import (
    grid_from_bounds, build_cell_table, build_neighbor_list, brute_force_neighbors,
)
from sphinxsys_jax.neighbors.cell_list import morton_key, spatial_sort_permutation


def random_cloud(n, dim, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n, dim))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [1, 7, 300])
def test_inner_neighbors_match_brute_force(dim, n):
    pos = random_cloud(n, dim, seed=n + dim)
    cutoff = 0.22
    grid = grid_from_bounds([0.0] * dim, [1.0] * dim, cutoff)
    p = jnp.asarray(pos, dtype=jnp.float32)
    table = build_cell_table(p, jnp.int32(n), grid, cap=64)
    assert not bool(table.overflow)
    nl = build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n), table, grid,
                             cutoff, k_max=80, include_self=False)
    assert not bool(nl.overflow)
    got = set()
    idx = np.asarray(nl.idx)
    cnt = np.asarray(nl.count)
    for i in range(n):
        for s in range(cnt[i]):
            got.add((i, int(idx[i, s])))
        assert all(idx[i, s] == n for s in range(cnt[i], nl.k_max))
    expected = brute_force_neighbors(pos, n, pos, n, cutoff, include_self=False)
    assert got == expected


def test_contact_neighbors_two_bodies():
    dim = 2
    a = random_cloud(200, dim, seed=1, lo=0.0, hi=1.0)
    b = random_cloud(150, dim, seed=2, lo=0.5, hi=1.5)
    cutoff = 0.15
    grid = grid_from_bounds([0.0] * dim, [1.5] * dim, cutoff)
    pa, pb = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
    table_b = build_cell_table(pb, jnp.int32(150), grid, cap=32)
    nl = build_neighbor_list(pa, jnp.int32(200), pb, jnp.int32(150), table_b,
                             grid, cutoff, k_max=48, include_self=True)
    assert not bool(nl.overflow)
    got = set()
    idx, cnt = np.asarray(nl.idx), np.asarray(nl.count)
    for i in range(200):
        for s in range(cnt[i]):
            got.add((i, int(idx[i, s])))
    expected = brute_force_neighbors(a, 200, b, 150, cutoff, include_self=True)
    assert got == expected


def test_padding_particles_are_ignored():
    dim = 2
    n_real = 50
    pos = np.full((64, dim), 1.0e16)
    pos[:n_real] = random_cloud(n_real, dim, seed=3)
    cutoff = 0.3
    grid = grid_from_bounds([0.0] * dim, [1.0] * dim, cutoff)
    p = jnp.asarray(pos, jnp.float32)
    table = build_cell_table(p, jnp.int32(n_real), grid, cap=64)
    nl = build_neighbor_list(p, jnp.int32(n_real), p, jnp.int32(n_real), table,
                             grid, cutoff, k_max=64, include_self=False)
    idx, cnt = np.asarray(nl.idx), np.asarray(nl.count)
    # padding rows have no neighbors ...
    assert (cnt[n_real:] == 0).all()
    # ... and never appear as neighbors
    assert (idx[idx < 64] < n_real).all()


def test_cell_overflow_detected():
    pos = np.zeros((40, 2))  # all particles in one cell
    grid = grid_from_bounds([0.0, 0.0], [1.0, 1.0], 0.5)
    table = build_cell_table(jnp.asarray(pos, jnp.float32), jnp.int32(40), grid, cap=8)
    assert bool(table.overflow)


def test_neighbor_overflow_detected():
    pos = random_cloud(30, 2, seed=4, lo=0.0, hi=0.05)  # dense clump
    grid = grid_from_bounds([0.0, 0.0], [1.0, 1.0], 0.3)
    p = jnp.asarray(pos, jnp.float32)
    table = build_cell_table(p, jnp.int32(30), grid, cap=64)
    nl = build_neighbor_list(p, jnp.int32(30), p, jnp.int32(30), table, grid,
                             0.3, k_max=8, include_self=False)
    assert bool(nl.overflow)


def test_morton_key_2d():
    coords = jnp.asarray([[0, 0], [1, 0], [0, 1], [1, 1], [2, 2], [3, 5]], jnp.int32)
    keys = np.asarray(morton_key(coords))
    assert list(keys[:5]) == [0, 1, 2, 3, 12]
    # interleave x into even bits, y into odd: (3,5) -> 0b100111 = 39
    assert keys[5] == 39


def test_spatial_sort_is_locality_improving():
    pos = random_cloud(500, 2, seed=5)
    grid = grid_from_bounds([0.0, 0.0], [1.0, 1.0], 0.1)
    p = jnp.asarray(pos, jnp.float32)
    perm = np.asarray(spatial_sort_permutation(p, jnp.int32(500), grid))
    sorted_pos = pos[perm]
    # mean hop distance between consecutive particles should drop a lot
    def mean_hop(x):
        return np.linalg.norm(np.diff(x, axis=0), axis=1).mean()
    assert mean_hop(sorted_pos) < 0.5 * mean_hop(pos)


def test_neighbor_build_jits():
    """The full rebuild must be one traceable, jittable function."""
    dim = 2
    n = 128
    pos = jnp.asarray(random_cloud(n, dim, seed=6), jnp.float32)
    cutoff = 0.2
    grid = grid_from_bounds([0.0] * dim, [1.0] * dim, cutoff)

    @jax.jit
    def rebuild(p):
        table = build_cell_table(p, jnp.int32(n), grid, cap=32)
        return build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n), table,
                                   grid, cutoff, k_max=64, include_self=False)

    nl = rebuild(pos)
    assert nl.idx.shape == (n, 64)
    nl2 = rebuild(pos + 0.001)
    assert nl2.count.sum() > 0
