"""Operator-split implicit damping.

Counterpart of /root/reference/src/shared/particle_dynamics/
dissipation_dynamics/particle_dynamics_dissipation.{h,hpp}: unconditionally
stable pairwise damping of a field (velocity for viscous damping of solids)
via per-pair implicit updates.

The reference serializes pairs with colored cell sweeps (InteractionSplit,
dynamics_algorithms.h:200-231) and forward/backward Gauss-Seidel within the
neighborhood — inherently sequential.  The XLA formulation keeps the SAME
per-pair implicit increment

    b      = rate * dW_ij V_i V_j dt / r_ij        (b <= 0)
    dphi   = b (phi_i - phi_j) / (C_i C_j - b (C_i + C_j))
    phi_i += dphi C_j ;  phi_j -= dphi C_i

but applies all pairs simultaneously (Jacobi relaxation) for a configurable
number of sweeps — deterministic, race-free, and converging to the same
fixed point (each Jacobi sweep is itself unconditionally stable because
every pair increment uses the implicit denominator).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


def damping_pairwise(state: State, field: str, nl_inner: NeighborList, kernel,
                     dim: int, eta: float, dt, capacity_key: str = "Mass",
                     n_sweeps: int = 2, box=None) -> State:
    """Implicit pairwise damping of `field` (vector or scalar) with damping
    rate eta (dynamic viscosity for velocity damping) and per-particle
    capacity (Mass for velocity)."""
    out = dict(state)
    phi = state[field]
    cap = state[capacity_key]
    vol = state["VolumetricMeasure"]

    pg = pair_geometry(state["Position"], state["Position"], nl_inner, kernel,
                       dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    cap_j, _ = gather(cap, nl_inner.idx)
    b = eta * pg.dW * vol[:, None] * vol_j * dt / (pg.r + TINY)  # (N, K) <= 0

    denom = cap[:, None] * cap_j - b * (cap[:, None] + cap_j)
    coef = -b * cap_j / denom  # >= 0; per-pair relaxation weight on phi_i
    # Jacobi stability: the simultaneous update must not overshoot
    # (|sum_j coef| <= 1).  Scale pairs by min(1, 1/a_i, 1/a_j) — the SAME
    # factor on both sides of a pair, so momentum stays conserved.  (The
    # reference is stable for free because its colored Gauss-Seidel sweeps
    # re-read updated values, dynamics_algorithms.h:200-231.)
    a = jnp.sum(coef, axis=1)
    a_j, _ = gather(a, nl_inner.idx)
    scale = jnp.minimum(1.0, jnp.minimum(
        1.0 / jnp.maximum(a[:, None], TINY), 1.0 / jnp.maximum(a_j, TINY)))
    coef_lim = coef * scale

    def sweep(phi_cur):
        phi_j, _ = gather(phi_cur, nl_inner.idx)
        if phi_cur.ndim == 2:
            diff = phi_cur[:, None, :] - phi_j
            # i-side of every pair; the j-side is applied when the pair is
            # visited from j's own (symmetric) neighbor list
            return phi_cur - jnp.sum(coef_lim[..., None] * diff, axis=1)
        diff = phi_cur[:, None] - phi_j
        return phi_cur - jnp.sum(coef_lim * diff, axis=1)

    for _ in range(n_sweeps):
        phi = sweep(phi)
    out[field] = phi
    return out


def damping_pairwise_wall(state: State, field: str, wall: State,
                          nl_wall: NeighborList, kernel, dim: int, eta: float,
                          dt, capacity_key: str = "Mass",
                          wall_field: str | None = None, box=None,
                          n_sweeps: int = 2) -> State:
    """Damping<Contact<Pairwise, Wall>> (particle_dynamics_dissipation.hpp:
    123-157): implicit damping of `field` toward the wall's value (zero for
    static walls).  The wall side never updates; the reference's per-pair
    implicit increment is

        b      = rate dW_ij V_i V_j dt / r_ij   (b <= 0)
        phi_i += b (phi_i - phi_w) / (C_i - 2 b)

    and each wall pair is visited TWICE per exec (forward + backward
    sweep) — matched here by `n_sweeps` Jacobi passes with the same
    overshoot limiter as damping_pairwise.  (The 2-sweep count is also
    what makes the pairwise-damping Laplacian consistent with viscosity
    eta: one sweep of b carries eta/2, see damping_pairwise — validated
    against the analytic startup Poiseuille profile in
    tests/test_throat.py.)"""
    out = dict(state)
    phi = state[field]
    cap = state[capacity_key]
    vol = state["VolumetricMeasure"]

    pg = pair_geometry(state["Position"], wall["Position"], nl_wall, kernel,
                       dim, need_W=False, box=box)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
    b = eta * pg.dW * vol[:, None] * wvol_j * dt / (pg.r + TINY)
    coef = -b / (cap[:, None] - 2.0 * b)              # >= 0
    a = jnp.sum(coef, axis=1)
    coef = coef * jnp.minimum(1.0, 1.0 / jnp.maximum(a[:, None], TINY))

    if wall_field is not None:
        phi_w, _ = gather(wall[wall_field], nl_wall.idx)
    else:
        phi_w = 0.0
    for _ in range(n_sweeps):
        if phi.ndim == 2:
            diff = phi[:, None, :] - (phi_w if wall_field else jnp.zeros_like(pg.e))
            phi = phi - jnp.sum(coef[..., None] * diff, axis=1)
        else:
            diff = phi[:, None] - (phi_w if wall_field else 0.0)
            phi = phi - jnp.sum(coef * diff, axis=1)
    out[field] = phi
    return out


def damping_projection(state: State, field: str, nl_inner: NeighborList,
                       kernel, dim: int, eta: float, dt,
                       capacity_key: str = "Mass", box=None) -> State:
    """Damping<Inner<Projection>> (particle_dynamics_dissipation.hpp:19-63):
    per-particle implicit projection solve.  The reference computes, for
    each particle i in sequence,

        b_ij  = 2 eta dW_ij V_i V_j dt / r_ij          (b <= 0)
        err_i = -sum_j (phi_i - phi_j) b_ij
        a_i   = sum_j b_ij - C_i,   c_i = sum_j b_ij^2
        k_i   = err_i / (a_i^2 + c_i)
        phi_i += k_i a_i
        phi_j -= (phi_i_new - (phi_j - k_i b_ij)) b_ij / C_j   (each j)

    and re-reads updated values as it walks the colored sweeps.  The
    order-free Jacobi analog evaluates every particle's projection from
    the same pre-sweep state and accumulates each particle's own update
    plus the exchanges scattered to it by its (symmetric-list) neighbors:

        dphi_m = k_m a_m
                 - sum_j (phi_j + k_j a_j - phi_m + k_j b_mj) b_mj / C_m

    Used by the 3D shell statics cases (3d_roof.cpp:136-139); note the
    projection split carries TWICE the pairwise b per visit plus the
    j-side exchange — at equal eta it damps substantially faster than
    one damping_pairwise sweep."""
    out = dict(state)
    phi = state[field]
    cap = state[capacity_key]
    vol = state["VolumetricMeasure"]

    pg = pair_geometry(state["Position"], state["Position"], nl_inner, kernel,
                       dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    fmask = pg.mask.astype(phi.dtype)
    b = 2.0 * eta * pg.dW * vol[:, None] * vol_j * dt / (pg.r + TINY) * fmask

    vec = phi.ndim == 2
    phi_j, _ = gather(phi, nl_inner.idx)
    if vec:
        err = -jnp.sum((phi[:, None, :] - phi_j) * b[..., None], axis=1)
    else:
        err = -jnp.sum((phi[:, None] - phi_j) * b, axis=1)
    a = jnp.sum(b, axis=1) - cap
    c = jnp.sum(b * b, axis=1)
    denom = (a * a + c + TINY)
    k = err / (denom[:, None] if vec else denom)

    k_j, _ = gather(k, nl_inner.idx)
    a_j, _ = gather(a, nl_inner.idx)
    if vec:
        exch = (phi_j + k_j * a_j[..., None] - phi[:, None, :]
                + k_j * b[..., None])
        dphi = k * a[:, None] - jnp.sum(
            exch * b[..., None], axis=1) / cap[:, None]
    else:
        exch = phi_j + k_j * a_j - phi[:, None] + k_j * b
        dphi = k * a - jnp.sum(exch * b, axis=1) / cap

    out[field] = phi + dphi
    return out


def damping_implicit_cg(state: State, field: str, nl_inner: NeighborList,
                        kernel, dim: int, eta: float, dt,
                        walls=(), capacity_key: str = "Mass", box=None,
                        tol: float = 1.0e-6, max_iter: int = 60,
                        inner_factor: float = 2.0) -> State:
    """EXACT implicit damping solve — the deep-implicit regime answer.

    Solves   (M + dt A) phi_new = M phi_old + dt A_w phi_wall
    where A is the SPD pairwise damping operator
    (A phi)_i = sum_j w_ij (phi_i - phi_j),  w_ij = -b_ij/dt
              = eta |dW_ij| V_i V_j / r_ij  >= 0,
    plus wall rows w_iw damping toward the wall's (average) velocity —
    by conjugate gradients with the neighbor-list matvec (XLA-native:
    each CG iteration is one gather + segment sum).

    Why: the reference's DampingPairwiseInner is a SEQUENTIAL Gauss-Seidel
    splitting (particle_dynamics_dissipation.hpp) whose sweeps cascade
    momentum through the whole domain in one exec; any Jacobi/parallel
    splitting (damping_pairwise above) can move momentum at most ONE
    kernel support per call, so its effective viscosity SATURATES at
    ~rho h c/CFL regardless of eta.  At throat-flow Reynolds numbers
    (Re = 1e-3, nu dt/h^2 ~ 40) the Jacobi form under-damps by ~2.7x
    (measured on the analytic Oldroyd-B channel); this CG solve converges
    to the true backward-Euler fixed point, which the sequential scheme
    itself only approximates from below.  Deviation: BETTER than the
    reference solver, same operator.
    """
    out = dict(state)
    phi0 = state[field]
    cap = state[capacity_key]
    vol = state["VolumetricMeasure"]

    pg = pair_geometry(state["Position"], state["Position"], nl_inner, kernel,
                       dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    # pair weight: the reference exec visits each inner pair TWICE
    # (forward + backward), so the per-exec operator carries 2x the
    # single-visit weight; `inner_factor` is calibrated on the analytic
    # Oldroyd-B channel (tests/test_throat.py)
    w_in = -inner_factor * eta * pg.dW * vol[:, None] * vol_j / (pg.r + TINY)
    idx = nl_inner.idx

    rhs = cap[..., None] * phi0 if phi0.ndim == 2 else cap * phi0
    diag_w = jnp.zeros_like(cap)
    for wstate, nlw, wall_field in walls:
        pgw = pair_geometry(state["Position"], wstate["Position"], nlw,
                            kernel, dim, need_W=False, box=box)
        wvol_j, _ = gather(wstate["VolumetricMeasure"], nlw.idx)
        w_w = -eta * pgw.dW * vol[:, None] * wvol_j / (pgw.r + TINY)
        # the reference wall pair uses denominator C - 2b (double-visit
        # convention): the wall row weight is 2 w_iw
        diag_w = diag_w + 2.0 * jnp.sum(w_w, axis=1)
        if wall_field is not None:
            phi_w, _ = gather(wstate[wall_field], nlw.idx)
            s_w = 2.0 * jnp.sum(w_w[..., None] * phi_w, axis=1)
            rhs = rhs + dt * s_w

    def matvec(phi):
        phi_j, _ = gather(phi, idx)
        if phi.ndim == 2:
            lap = jnp.sum(w_in[..., None] * (phi[:, None, :] - phi_j), axis=1)
            return (cap + dt * diag_w)[:, None] * phi + dt * lap
        lap = jnp.sum(w_in * (phi[:, None] - phi_j), axis=1)
        return (cap + dt * diag_w) * phi + dt * lap

    # Jacobi-preconditioned CG
    diag = cap + dt * (diag_w + jnp.sum(w_in, axis=1))
    pre = (1.0 / diag)[..., None] if phi0.ndim == 2 else 1.0 / diag
    phi_new, _ = jax.scipy.sparse.linalg.cg(
        matvec, rhs, x0=phi0, tol=tol, maxiter=max_iter,
        M=lambda r: pre * r)
    out[field] = phi_new
    return out
