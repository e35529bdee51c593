"""Thick-shell particle relaxation: mid-surface fitting + normal prediction.

Counterpart of /root/reference/src/shared/particle_dynamics/relax_dynamics/
relax_thick_shell.{h,cpp}: lattice particles filled into a thin (thickness t)
volume are relaxed onto its MID-SURFACE and given consistent normal
directions, producing body-fitted shell initial conditions (consumed via the
reload channel, e.g. test_2d/3d_shell_particle_relaxation).

The pieces, re-designed order-free for XLA:

  * ShellMidSurfaceBounding (relax_thick_shell.cpp:18-24): every iteration,
    pos -= 0.2 |grad phi|_raw * (0.5 dx) * n_hat.  The RAW (non-normalized)
    level-set gradient magnitude ~1 away from the medial axis and ~0 on it,
    so the step drives particles to the mid surface and vanishes there.
  * ShellRelaxationStep (cpp:174-190): plain inner relaxation residual +
    max-residual scaling + position update + mid-surface bounding.
  * ShellNormalDirectionPrediction (cpp:26-83): iterate
    n <- normal(pos + 0.3 t n) to convergence (all cos > cos(0.01 pi)),
    then make orientations globally consistent.  The reference flood-fills
    sequentially from one seed under a mutex; here each sweep updates IN
    PARALLEL every particle that has an already-updated neighbor (masked
    argmax pick), which converges in O(surface diameter) sweeps inside one
    lax.while_loop — same fixed point, no ordering.
  * SmoothingNormal: W-weighted neighborhood average, re-normalized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphinxsys_jax.neighbors import build_cell_table, build_neighbor_list
from sphinxsys_jax.neighbors.cell_list import CellGrid
from sphinxsys_jax.neighbors.neighbor_list import gather
from sphinxsys_jax.physics.pair import pair_geometry
from sphinxsys_jax.physics.relax import (randomize_positions,
                                         relaxation_residual,
                                         relaxation_scaling)

TINY = 1.0e-15


def probe_raw_gradient(levelset, pts):
    """Non-normalized level-set gradient at query points
    (LevelSetShape::findLevelSetGradient)."""
    return levelset._multilinear(levelset.gradient(), pts)


def mid_surface_bounding(pos, levelset, spacing: float):
    """ShellMidSurfaceBounding::update (relax_thick_shell.cpp:18-24)."""
    g = probe_raw_gradient(levelset, pos)
    n = g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + TINY)
    factor = 0.2 * jnp.linalg.norm(g, axis=-1, keepdims=True)
    return (pos - factor * (0.5 * spacing) * n).astype(pos.dtype)


def shell_relax(levelset, pos0, volume: float, adaptation, grid: CellGrid,
                n_iterations: int = 2000, cell_cap: int = 32,
                k_max: int = 48, seed: int = 0):
    """ShellRelaxationStep driver (test_2d_shell_particle_relaxation.cpp
    main loop): randomize, bound to mid-surface, then relax with the plain
    inner residual + mid-surface bounding each iteration."""
    kernel = adaptation.kernel
    dim = pos0.shape[1]
    n = pos0.shape[0]
    vol = jnp.full((n,), volume, dtype=jnp.asarray(pos0).dtype)
    h_ref = adaptation.h
    cutoff = adaptation.cutoff
    spacing = adaptation.spacing

    pos0 = randomize_positions(jnp.asarray(pos0), spacing, seed)
    pos0 = mid_surface_bounding(pos0, levelset, spacing)

    @jax.jit
    def run(pos):
        def body(_, p):
            table = build_cell_table(p, jnp.int32(n), grid, cap=cell_cap)
            nl = build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n), table,
                                     grid, cutoff, k_max=k_max,
                                     include_self=False)
            res = relaxation_residual(p, vol, nl, kernel, dim)
            scale = relaxation_scaling(res, h_ref)
            p = p + 0.5 * res * scale
            return mid_surface_bounding(p, levelset, spacing)

        return jax.lax.fori_loop(0, n_iterations, body, pos)

    return run(pos0)


def _predict_normals(pos, n0, levelset, thickness: float,
                     convergence: float, max_iters: int = 100):
    """n <- levelset normal at (pos + 0.3 t n), iterated until every
    particle's direction change cosine exceeds `convergence`
    (NormalPrediction + PredictionConvergenceCheck)."""

    def cond(carry):
        _, ok, it = carry
        return jnp.logical_and(~ok, it < max_iters)

    def body(carry):
        nrm, _, it = carry
        new = levelset.probe_normal_direction(pos + 0.3 * thickness * nrm)
        ok = jnp.all(jnp.sum(new * nrm, axis=-1) > convergence)
        return new, ok, it + 1

    n, _, _ = jax.lax.while_loop(
        cond, body, (n0, jnp.asarray(False), jnp.int32(0)))
    return n


def _consistency_flood(n, nl, consistency: float, seed_index,
                       max_sweeps: int = 4096):
    """ConsistencyCorrection re-designed as parallel wavefront propagation:
    start from one updated seed; each sweep, every not-yet-updated particle
    with at least one updated REAL neighbor adopts a sign-consistent
    orientation from the first such neighbor.  Equivalent fixed point to
    the reference's sequenced flood fill (each particle is corrected exactly
    once, against an already-updated neighbor), order-free."""
    N = n.shape[0]
    updated0 = jnp.zeros((N,), jnp.bool_).at[seed_index].set(True)

    def cond(carry):
        _, updated, sweeps = carry
        return jnp.logical_and(~jnp.all(updated), sweeps < max_sweeps)

    def body(carry):
        nrm, updated, sweeps = carry
        upd_j, mask = gather(updated, nl.idx)
        valid = jnp.logical_and(upd_j, mask)
        has_src = jnp.any(valid, axis=1)
        src_slot = jnp.argmax(valid, axis=1)
        src_idx = jnp.take_along_axis(nl.idx, src_slot[:, None], axis=1)[:, 0]
        n_src = nrm[src_idx]
        dot = jnp.sum(n_src * nrm, axis=-1)
        flip = dot < -consistency        # aligned with -n_j: flip own sign
        adopt = jnp.abs(dot) <= consistency  # near-orthogonal: copy source
        cand = jnp.where(adopt[:, None], n_src,
                         jnp.where(flip[:, None], -nrm, nrm))
        take = jnp.logical_and(has_src, ~updated)
        nrm = jnp.where(take[:, None], cand, nrm)
        updated = jnp.logical_or(updated, take)
        return nrm, updated, sweeps + 1

    n, updated, _ = jax.lax.while_loop(cond, body,
                                       (n, updated0, jnp.int32(0)))
    return n, updated


def _smooth_normals(pos, n, nl, kernel, dim: int):
    """SmoothingNormal (ParticleSmoothing with W_ij weights + self W0),
    re-normalized (relax_thick_shell.cpp:164-172)."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_dW=False)
    n_j, _ = gather(n, nl.idx)
    w0 = kernel.w0(dim)
    num = w0 * n + jnp.sum(pg.W[..., None] * n_j, axis=1)
    den = w0 + jnp.sum(pg.W, axis=1)
    sm = num / (den[..., None] + TINY)
    return sm / (jnp.linalg.norm(sm, axis=-1, keepdims=True) + TINY)


def shell_normal_prediction(pos, levelset, thickness: float, adaptation,
                            grid: CellGrid, cell_cap: int = 32,
                            k_max: int = 48,
                            consistency: float = None):
    """ShellNormalDirectionPrediction::exec (relax_thick_shell.cpp:38-44):
    predict -> consistency-correct -> predict -> smooth.  Returns unit
    normals (N, dim) and the all-updated flag from the flood fill."""
    import numpy as np

    dim = pos.shape[1]
    n0 = levelset.probe_normal_direction(pos)
    convergence = float(np.cos(0.01 * np.pi))
    if consistency is None:
        consistency = float(np.cos(np.pi / 20.0))

    kernel = adaptation.kernel
    N = pos.shape[0]
    table = build_cell_table(pos, jnp.int32(N), grid, cap=cell_cap)
    nl = build_neighbor_list(pos, jnp.int32(N), pos, jnp.int32(N), table,
                             grid, adaptation.cutoff, k_max=k_max,
                             include_self=False)

    n1 = _predict_normals(pos, n0, levelset, thickness, convergence)
    n2, updated = _consistency_flood(n1, nl, consistency, N // 3)
    n3 = _predict_normals(pos, n2, levelset, thickness, convergence)
    n4 = _smooth_normals(pos, n3, nl, kernel, dim)
    return n4, updated
