"""Compressible Eulerian SPH with HLLC fluxes: Sod shock tube vs the exact
Riemann solution (the canonical compressible oracle; unlocks the reference's
eulerian_compressible examples)."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import CompressibleFluid
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import eulerian as eu

GAMMA = 1.4


def sod_exact(x, t, x0=0.5):
    """Exact Sod solution (rho) for left (1,0,1), right (0.125,0,0.1)."""
    rho_l, p_l, rho_r, p_r = 1.0, 1.0, 0.125, 0.1
    c_l = math.sqrt(GAMMA * p_l / rho_l)
    c_r = math.sqrt(GAMMA * p_r / rho_r)
    # star-region pressure by Newton iteration on the standard function
    g = GAMMA

    def f(p, rho_k, p_k, c_k):
        if p > p_k:  # shock
            A = 2.0 / ((g + 1) * rho_k)
            B = (g - 1) / (g + 1) * p_k
            return (p - p_k) * math.sqrt(A / (p + B))
        return 2 * c_k / (g - 1) * ((p / p_k) ** ((g - 1) / (2 * g)) - 1)

    p = 0.3
    for _ in range(60):
        fl, fr = f(p, rho_l, p_l, c_l), f(p, rho_r, p_r, c_r)
        dfl = (f(p + 1e-8, rho_l, p_l, c_l) - fl) / 1e-8
        dfr = (f(p + 1e-8, rho_r, p_r, c_r) - fr) / 1e-8
        p -= (fl + fr) / (dfl + dfr)
    p_star = p
    u_star = 0.5 * (f(p_star, rho_r, p_r, c_r) - f(p_star, rho_l, p_l, c_l))
    rho_star_l = rho_l * (p_star / p_l) ** (1 / g)
    c_star_l = math.sqrt(g * p_star / rho_star_l)
    rho_star_r = rho_r * ((p_star / p_r + (g - 1) / (g + 1)) /
                          ((g - 1) / (g + 1) * p_star / p_r + 1))
    s_shock = u_star + c_r * math.sqrt((g + 1) / (2 * g) * p_star / p_r
                                       + (g - 1) / (2 * g))
    xi = (x - x0) / t
    rho = np.empty_like(x)
    for i, s in enumerate(xi):
        if s < -c_l:
            rho[i] = rho_l
        elif s < u_star - c_star_l:  # rarefaction fan
            u = 2 / (g + 1) * (c_l + s)
            c = c_l - (g - 1) / 2 * u
            rho[i] = rho_l * (c / c_l) ** (2 / (g - 1))
        elif s < u_star:
            rho[i] = rho_star_l
        elif s < s_shock:
            rho[i] = rho_star_r
        else:
            rho[i] = rho_r
    return rho


def test_sod_shock_tube_hllc():
    dx = 1.0 / 200.0
    n_rows = 6
    xs = np.arange(dx / 2, 1.0, dx)
    ys = np.arange(dx / 2, n_rows * dx, dx)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel()], -1).astype(np.float32)
    gas = CompressibleFluid(gamma=GAMMA)

    left = pos[:, 0] < 0.5
    rho0 = np.where(left, 1.0, 0.125).astype(np.float32)
    p0 = np.where(left, 1.0, 0.1).astype(np.float32)
    state = eu.make_compressible_eulerian_state(pos, dx * dx, gas, rho0, p0)

    adaptation = SPHAdaptation(spacing=dx, dim=2)
    ly = n_rows * dx
    grid = grid_from_bounds((0.0, 0.0), (1.0, ly), adaptation.cutoff,
                            periodic=(False, True))
    box = (0.0, ly)
    table = build_cell_table(state["Position"], state["NReal"], grid, cap=16)
    nl = build_neighbor_list(state["Position"], state["NReal"],
                             state["Position"], state["NReal"], table, grid,
                             adaptation.cutoff, k_max=32, include_self=False)
    assert not bool(nl.overflow)
    kernel = adaptation.kernel
    h = adaptation.h

    @jax.jit
    def run(state, t_end):
        def cond(c):
            return c[1] < t_end

        def body(c):
            s, t = c
            dt = eu.compressible_time_step(s, gas, h)
            s = eu.compressible_integration_1st_half(s, nl, kernel, 2, gas,
                                                     dt, box=box)
            s = eu.compressible_integration_2nd_half(s, nl, kernel, 2, gas,
                                                     dt, box=box)
            return (s, t + dt)

        return jax.lax.while_loop(cond, body, (state, jnp.zeros((), jnp.float32)))

    s, t = run(state, 0.15)
    rho = np.asarray(s["Density"])
    x = np.asarray(s["Position"])[:, 0]
    assert np.isfinite(rho).all()
    # compare in the interior (ends have truncated kernels)
    sel = (x > 0.15) & (x < 0.9)
    exact = sod_exact(x[sel], float(t))
    l1 = np.mean(np.abs(rho[sel] - exact))
    # first-order HLLC without gradient reconstruction smears the shock and
    # contact over ~4h; L1 ~ 0.06 at dx = 1/200 (halves with resolution)
    assert l1 < 0.08, f"Sod L1 density error {l1:.4f}"
    # the shock plateau density is captured
    plateau = (x > 0.65) & (x < 0.72)
    assert abs(np.median(rho[plateau]) - 0.26557) < 0.04
