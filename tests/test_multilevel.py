"""Multi-level adaptive-h neighbor engine tests (cell_linked_list.h:169-219,
NeighborBuilderInnerAdaptive counterparts)."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.neighbors import multilevel as mlv

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def _two_resolution_lattice(dx=0.1, split=0.5, lo=0.0, hi=1.0):
    """Left half at dx (coarse), right half at dx/2 (fine)."""
    xs_c = np.arange(lo + dx / 2, split, dx)
    ys_c = np.arange(lo + dx / 2, hi, dx)
    Xc, Yc = np.meshgrid(xs_c, ys_c, indexing="ij")
    pos_c = np.stack([Xc.ravel(), Yc.ravel()], -1)
    m_c = np.full(len(pos_c), dx * dx)
    f = dx / 2
    xs_f = np.arange(split + f / 2, hi, f)
    ys_f = np.arange(lo + f / 2, hi, f)
    Xf, Yf = np.meshgrid(xs_f, ys_f, indexing="ij")
    pos_f = np.stack([Xf.ravel(), Yf.ravel()], -1)
    m_f = np.full(len(pos_f), f * f)
    pos = np.concatenate([pos_c, pos_f]).astype(np.float32)
    mass = np.concatenate([m_c, m_f]).astype(np.float32)
    h_ratio = np.concatenate([np.ones(len(pos_c)),
                              2.0 * np.ones(len(pos_f))]).astype(np.float32)
    return pos, mass, h_ratio


def test_adaptive_pairs_match_brute_force():
    rng = np.random.default_rng(0)
    n = 200
    pos = rng.uniform(0, 1, size=(n, 2)).astype(np.float32)
    h_ratio = rng.choice([1.0, 2.0], size=n).astype(np.float32)
    h_ref = 0.13
    ks = 2.0
    ml = mlv.build_multilevel_tables(jnp.asarray(pos), jnp.asarray(n),
                                     jnp.asarray(h_ratio), (0.0, 0.0),
                                     (1.0, 1.0), h_ref, kernel_size=ks,
                                     n_levels=2, cap=48)
    nl = mlv.build_adaptive_neighbor_list(
        jnp.asarray(pos), jnp.asarray(n), jnp.asarray(h_ratio),
        jnp.asarray(pos), jnp.asarray(h_ratio), ml, ks, h_ref,
        k_max_per_level=(128, 96), include_self=False)
    assert not bool(nl.overflow)

    got = set()
    idx = np.asarray(nl.idx)
    for i in range(n):
        for j in idx[i]:
            if j < n:
                got.add((i, int(j)))
    h = h_ref / h_ratio
    want = set()
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            r = np.linalg.norm(pos[i] - pos[j])
            if r < ks * max(h[i], h[j]):
                want.add((i, j))
    assert got == want, (len(got - want), len(want - got))


def test_adaptive_density_summation_two_resolutions():
    """Mixed-resolution lattice: the adaptive summation recovers rho = 1
    in both uniform regions and stays bounded across the transition."""
    dx = 0.1
    pos, mass, h_ratio = _two_resolution_lattice(dx=dx)
    n = len(pos)
    h_ref = 1.3 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    kernel = adaptation.kernel
    assert abs(kernel.h - h_ref) < 1e-12

    ml = mlv.build_multilevel_tables(jnp.asarray(pos), jnp.asarray(n),
                                     jnp.asarray(h_ratio), (-0.2, -0.2),
                                     (1.2, 1.2), h_ref, n_levels=2, cap=64)
    nl = mlv.build_adaptive_neighbor_list(
        jnp.asarray(pos), jnp.asarray(n), jnp.asarray(h_ratio),
        jnp.asarray(pos), jnp.asarray(h_ratio), ml, kernel.kernel_size,
        h_ref, k_max_per_level=(128, 48), include_self=False)
    assert not bool(nl.overflow)
    rho = np.asarray(mlv.adaptive_density_summation(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(h_ratio), nl,
        kernel, 2, h_ref))

    x = pos[:, 0]
    y = pos[:, 1]
    interior = (y > 0.25) & (y < 0.75)
    coarse_bulk = interior & (x > 0.2) & (x < 0.3)
    fine_bulk = interior & (x > 0.7) & (x < 0.8)
    band = interior & (x > 0.4) & (x < 0.6)
    assert abs(rho[coarse_bulk].mean() - 1.0) < 0.03
    assert abs(rho[fine_bulk].mean() - 1.0) < 0.03
    assert np.abs(rho[band] - 1.0).max() < 0.25  # transition band
