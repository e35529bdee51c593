"""Body-fitted particle relaxation preprocessing.

Counterpart of /root/reference/src/shared/particle_dynamics/relax_dynamics/
(relax_stepping.{h,cpp}, base_relax_dynamics.cpp) — the `--relax=true` path
(SURVEY.md §3.5) that turns a lattice fill into an isotropic body-fitted
particle distribution, later consumed through the Reload channel:

    randomize -> loop { residual = -2 sum dW V_j e_ij (- surface correction)
                        scaling  = 0.0625 h / max|residual|
                        x += 0.5 * residual * scaling
                        surface bounding: project back inside the surface
                        band (phi > -dx/2 -> x -= (phi + dx/2) n) }

The level-set kernel-gradient surface correction is replaced by the exact
shape SDF (our shapes ARE SDFs — geometry.py): the bounding step alone
keeps particles inside, which is the dominant effect for convex-ish parts.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import build_cell_table, build_neighbor_list
from sphinxsys_jax.neighbors.cell_list import CellGrid
from sphinxsys_jax.physics.pair import pair_geometry
from sphinxsys_jax.neighbors.neighbor_list import gather

TINY = 1.0e-15


def randomize_positions(pos, spacing: float, seed: int = 0):
    """RandomizeParticlePosition (base_relax_dynamics.cpp): jitter by
    U(-1,1) * spacing * dt with the reference's default dt=0.25 scale."""
    key = jax.random.PRNGKey(seed)
    return pos + 0.25 * spacing * jax.random.uniform(
        key, pos.shape, dtype=pos.dtype, minval=-1.0, maxval=1.0)


def relaxation_residual(pos, vol, nl, kernel, dim: int, box=None):
    """residual_i = -2 sum_j dW_ij V_j e_ij (relax_stepping.cpp); `box`
    enables minimum-image displacements for periodic domains."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl.idx)
    return -jnp.sum((2.0 * pg.dW * vol_j)[..., None] * pg.e, axis=1)


def half_space_gradient_table(kernel, dim: int, n_samples: int = 64):
    """L(d) = |integral of grad W over the half space beyond distance d|
    (the flat-surface closed form of LevelSetShape::computeKernelIntegral,
    level_set_shape.h:67): in 2D L(d) = int W(sqrt(x^2+d^2)) dx, in 3D
    L(d) = 2 pi int_0^inf W(sqrt(s^2+d^2)) s ds.  Returns (d_grid, L)."""
    cutoff = kernel.cutoff
    d_grid = np.linspace(0.0, cutoff, n_samples)
    xs = np.linspace(-cutoff, cutoff, 801)
    dxs = xs[1] - xs[0]
    L = np.zeros_like(d_grid)
    for i, d in enumerate(d_grid):
        if dim == 2:
            r = np.sqrt(xs**2 + d**2)
            w = np.asarray(kernel.W(jnp.asarray(r), 2))
            L[i] = np.sum(w) * dxs
        else:
            s = np.linspace(0.0, cutoff, 401)
            ds = s[1] - s[0]
            r = np.sqrt(s**2 + d**2)
            w = np.asarray(kernel.W(jnp.asarray(r), 3))
            L[i] = 2.0 * np.pi * np.sum(w * s) * ds
    return jnp.asarray(d_grid), jnp.asarray(L)


def surface_residual_correction(pos, shape, table):
    """Missing-neighbor correction near the body surface: the truncated
    kernel sum is completed by the flat-surface integral, pointing inward
    (-n * L(|phi|)); cancels the outward truncation bias of
    relaxation_residual for particles inside the band."""
    d_grid, L = table
    d_grid = d_grid.astype(pos.dtype)
    L = L.astype(pos.dtype)
    phi = shape.signed_distance(pos)  # negative inside
    n = shape.find_normal_direction(pos)
    depth = jnp.clip(-phi, 0.0, d_grid[-1])
    corr = jnp.interp(depth, d_grid, L)
    return (-2.0 * corr[..., None] * n).astype(pos.dtype)


def relaxation_scaling(residual, h_ref: float):
    """0.0625 h / max|residual| (relax_stepping.cpp RelaxationScaling)."""
    return 0.0625 * h_ref / (jnp.max(jnp.linalg.norm(residual, axis=-1)) + TINY)


def surface_bounding(pos, shape, spacing: float):
    """ShapeSurfaceBounding (general_constraint.cpp): project particles
    with phi > -dx/2 back to the inner surface band."""
    phi = shape.signed_distance(pos)
    d = 0.5 * spacing
    n = shape.find_normal_direction(pos)
    shift = jnp.where((phi > -d)[..., None], (phi + d)[..., None] * n, 0.0)
    return (pos - shift).astype(pos.dtype)


def relax_shape(shape, pos0, volume: float, adaptation, grid: CellGrid,
                n_iterations: int = 200, cell_cap: int = 32, k_max: int = 48,
                seed: int = 0, surface_correction: bool = True):
    """RelaxationStepInner driver (relax_stepping.h:224, with the level-set
    surface correction variant): returns relaxed positions.  Whole loop is
    one jitted lax.fori_loop."""
    kernel = adaptation.kernel
    dim = pos0.shape[1]
    n = pos0.shape[0]
    vol = jnp.full((n,), volume, dtype=pos0.dtype)
    h_ref = adaptation.h
    cutoff = adaptation.cutoff
    spacing = adaptation.spacing
    table_L = half_space_gradient_table(kernel, dim) if surface_correction else None

    pos0 = randomize_positions(jnp.asarray(pos0), spacing, seed)
    pos0 = surface_bounding(pos0, shape, spacing)

    @jax.jit
    def run(pos):
        def body(_, p):
            table = build_cell_table(p, jnp.int32(n), grid, cap=cell_cap)
            nl = build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n), table,
                                     grid, cutoff, k_max=k_max, include_self=False)
            res = relaxation_residual(p, vol, nl, kernel, dim)
            if table_L is not None:
                res = res + surface_residual_correction(p, shape, table_L)
            scale = relaxation_scaling(res, h_ref)
            p = p + 0.5 * res * scale
            return surface_bounding(p, shape, spacing)

        return jax.lax.fori_loop(0, n_iterations, body, pos)

    return run(pos0)


def half_space_kernel_tables(kernel, dim: int, n_samples: int = 64):
    """Flat-surface closures used by the implicit level-set correction
    (relax_stepping.cpp RelaxationResidual<Inner<LevelSetCorrection,
    Implicit>>): K(d) = int W over the half space beyond depth d (the
    'overlap' kernel integral) and L'(d) = d/dd of the gradient-integral
    magnitude (the flat-surface second-gradient integral is
    -L'(d) n n^T).  Returns (d_grid, K, Lp)."""
    cutoff = kernel.cutoff
    d_grid = np.linspace(0.0, cutoff, n_samples)
    ys = np.linspace(0.0, cutoff, 401)
    dy = ys[1] - ys[0]
    if dim == 2:
        xs = np.linspace(-cutoff, cutoff, 801)
        dxs = xs[1] - xs[0]
        r = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2)
        Wg = np.asarray(kernel.W(jnp.asarray(r), 2))
        line = np.sum(Wg, axis=1) * dxs                       # (401,)
    else:
        s = np.linspace(0.0, cutoff, 401)
        ds = s[1] - s[0]
        r = np.sqrt(s[None, :] ** 2 + ys[:, None] ** 2)
        Wg = np.asarray(kernel.W(jnp.asarray(r), 3))
        line = 2.0 * np.pi * np.sum(Wg * s[None, :], axis=1) * ds
    # K(y) = int_y^cutoff line(t) dt — reversed cumulative integral
    tail = np.concatenate([np.cumsum(line[::-1])[::-1][1:] * dy, [0.0]])
    K = np.interp(d_grid, ys, tail)
    _, L = half_space_gradient_table(kernel, dim, n_samples)
    Lp = np.gradient(np.asarray(L), d_grid)
    return jnp.asarray(d_grid), jnp.asarray(K), jnp.asarray(Lp)


def implicit_relaxation_update(pos, vol, nl, kernel, dim: int, dtsq,
                               shape=None, tables=None, levelset=None):
    """One implicit relaxation solve, the Jacobi two-pass re-design of the
    reference's sequenced splitting sweep (relax_stepping.cpp
    RelaxationResidual<Inner<Implicit>>::computeErrorAndParameters /
    updateStates).  The reference visits particles in order, solving the
    local linearized system (a^2 + c) k = error for particle i and scattering
    -B_ij k to each neighbor as it goes; that scatter is sequential, so we
    solve ALL local systems from the same configuration (pass 1) and then
    apply each particle's own update a_i k_i plus the gathered neighbor
    pushes -B_ij k_j (pass 2) — deterministic and order-free.

    Returns (new_pos, residual) where residual = -error/dt^2 is the quantity
    the reference records as ParticleKineticEnergy."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False, box=None)
    vol_j, _ = gather(vol, nl.idx)
    fmask = pg.mask.astype(pos.dtype)
    d2w = kernel.d2W(pg.r, dim) * fmask
    ee = pg.e[..., :, None] * pg.e[..., None, :]            # (N, K, d, d)
    B = 2.0 * ee * (d2w * vol_j * dtsq)[..., None, None]    # (N, K, d, d)
    error = jnp.sum((2.0 * pg.dW * vol_j * dtsq)[..., None] * pg.e, axis=1)
    eye = jnp.eye(dim, dtype=pos.dtype)
    a = -eye - jnp.sum(B, axis=1)
    c = jnp.sum(B @ B, axis=1)
    if levelset is not None:
        # sampled level-set correction, exactly the reference's
        # RelaxationResidual<Inner<LevelSetCorrection, Implicit>>::
        # computeErrorAndParameters (relax_stepping.cpp:97-110): the
        # overlap/gradient/second-gradient integrals are probed from the
        # cut-cell mesh integrals, not the flat-surface closures.
        overlap = levelset.probe_kernel_integral(pos) * dtsq
        grad_int = levelset.probe_kernel_gradient_integral(pos)
        error = error + 2.0 * grad_int * dtsq * (1.0 + overlap)[..., None]
        sg = levelset.probe_kernel_second_gradient_integral(pos)
        a = a - 2.0 * sg * dtsq * (1.0 + overlap)[..., None, None]
    elif shape is not None and tables is not None:
        d_grid, K, Lp, L = tables
        phi = shape.signed_distance(pos)
        n = shape.find_normal_direction(pos)
        depth = jnp.clip(-phi, 0.0, d_grid[-1])
        overlap = jnp.interp(depth, d_grid, K) * dtsq
        grad_int = jnp.interp(depth, d_grid, L)[..., None] * n
        error = error + 2.0 * grad_int * dtsq * (1.0 + overlap)[..., None]
        sg = -jnp.interp(depth, d_grid, Lp)[..., None, None] * (
            n[..., :, None] * n[..., None, :])
        a = a - 2.0 * sg * dtsq * (1.0 + overlap)[..., None, None]
    lhs = a @ a + c
    k = jnp.linalg.solve(lhs, error[..., None])[..., 0]     # (N, d)
    # pass 2: own move + neighbor pushes (B with the receiver's volume)
    k_j, _ = gather(k, nl.idx)
    B_recv = 2.0 * ee * (d2w * dtsq)[..., None, None] * vol[:, None, None, None]
    push = jnp.sum((B_recv @ k_j[..., None])[..., 0], axis=1)
    new_pos = pos + (a @ k[..., None])[..., 0] - push
    residual = -error / dtsq
    return new_pos.astype(pos.dtype), residual.astype(pos.dtype)


def relax_shape_implicit(shape, pos0, volume: float, adaptation,
                         grid: CellGrid, n_iterations: int = 1000,
                         cell_cap: int = 32, k_max: int = 48, seed: int = 0,
                         record_every: int = 200, levelset=None):
    """RelaxationStepLevelSetCorrectionInnerImplicit driver
    (relax_stepping.hpp:66-89 + test_2d_implicit_relaxation): each iteration
    uses dt = min(sqrt(0.0625 h / max|residual|), 0.01) with the residual of
    the PREVIOUS iteration, runs the implicit solve, then projects back into
    the surface band.  Returns (relaxed_pos, kinetic_curve) where
    kinetic_curve[m] is the average |residual| after (m+1)*record_every
    iterations — the reference's regression quantity."""
    kernel = adaptation.kernel
    dim = pos0.shape[1]
    n = pos0.shape[0]
    vol = jnp.full((n,), volume, dtype=jnp.asarray(pos0).dtype)
    h_ref = adaptation.h
    cutoff = adaptation.cutoff
    spacing = adaptation.spacing
    d_grid, K, Lp = half_space_kernel_tables(kernel, dim)
    _, L = half_space_gradient_table(kernel, dim)
    dtype = jnp.asarray(pos0).dtype
    tables = (d_grid.astype(dtype), K.astype(dtype), Lp.astype(dtype),
              L.astype(dtype))

    pos0 = randomize_positions(jnp.asarray(pos0), spacing, seed)
    pos0 = surface_bounding(pos0, shape, spacing)
    n_records = n_iterations // record_every

    @jax.jit
    def run(pos):
        def body(it, carry):
            p, res_max, curve = carry
            dt = jnp.minimum(jnp.sqrt(0.0625 * h_ref / (res_max + TINY)), 0.01)
            table = build_cell_table(p, jnp.int32(n), grid, cap=cell_cap)
            nl = build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n), table,
                                     grid, cutoff, k_max=k_max,
                                     include_self=False)
            p, res = implicit_relaxation_update(p, vol, nl, kernel, dim,
                                                dt * dt, shape, tables,
                                                levelset=levelset)
            p = surface_bounding(p, shape, spacing)
            rn = jnp.linalg.norm(res, axis=-1)
            rec = (it + 1) // record_every - 1
            hit = (it + 1) % record_every == 0
            curve = jnp.where(
                hit, curve.at[jnp.clip(rec, 0, n_records - 1)].set(
                    jnp.mean(rn)), curve)
            return p, jnp.max(rn), curve

        curve0 = jnp.zeros((n_records,), dtype=pos.dtype)
        p, _, curve = jax.lax.fori_loop(
            0, n_iterations, body, (pos, jnp.zeros((), pos.dtype), curve0))
        return p, curve

    return run(pos0)


def relax_periodic(pos0, volume: float, adaptation, grid: CellGrid,
                   n_iterations: int = 200, cell_cap: int = 32,
                   k_max: int = 48, seed: int = 0, box=None):
    """Periodic-domain relaxation (the fully-periodic counterpart of
    relax_shape, e.g. the Taylor-Green relaxed initial condition): no
    surface bounding, positions wrapped into the box each iteration and
    residuals evaluated with minimum-image displacements."""
    from sphinxsys_jax.neighbors.cell_list import wrap_positions

    kernel = adaptation.kernel
    dim = pos0.shape[1]
    n = pos0.shape[0]
    vol = jnp.full((n,), volume, dtype=jnp.asarray(pos0).dtype)
    h_ref = adaptation.h
    cutoff = adaptation.cutoff
    spacing = adaptation.spacing

    pos0 = wrap_positions(randomize_positions(jnp.asarray(pos0), spacing,
                                              seed), grid)

    @jax.jit
    def run(pos):
        def body(_, p):
            table = build_cell_table(p, jnp.int32(n), grid, cap=cell_cap)
            nl = build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n), table,
                                     grid, cutoff, k_max=k_max,
                                     include_self=False)
            res = relaxation_residual(p, vol, nl, kernel, dim, box=box)
            scale = relaxation_scaling(res, h_ref)
            return wrap_positions(p + 0.5 * res * scale, grid)

        return jax.lax.fori_loop(0, n_iterations, body, pos)

    return run(pos0)
