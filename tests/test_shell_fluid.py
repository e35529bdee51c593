"""Shell <-> fluid coupling machinery (physics/shell_fluid.py) against
closed-form and brute-force oracles, plus the hydrostatic fluid-shell case
(reference test_2d_hydrostatic_fluid_shell)."""

import pytest

import math
import types

import jax
import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def _kernel(dx, dim):
    from sphinxsys_jax.core.adaptation import SPHAdaptation

    return SPHAdaptation(spacing=dx, dim=dim)


def _shell_state(pos, normal, dx, thickness, rho0=1.0):
    from sphinxsys_jax.physics import shell as sh

    mat = types.SimpleNamespace(rho0=rho0)
    st = sh.make_shell_state(np.asarray(pos), np.asarray(normal), dx,
                             thickness, mat)
    st["AverageVelocity"] = jnp.zeros_like(st["Velocity"])
    st["AverageAcceleration"] = jnp.zeros_like(st["Velocity"])
    return st


def _nl(pos_q, pos_s, grid, cutoff, k_max, cap=32):
    from sphinxsys_jax.neighbors import build_cell_table, build_neighbor_list

    n_q = jnp.int32(len(pos_q))
    n_s = jnp.int32(len(pos_s))
    table = build_cell_table(jnp.asarray(pos_s), n_s, grid, cap=cap)
    return build_neighbor_list(jnp.asarray(pos_q), n_q, jnp.asarray(pos_s),
                               n_s, table, grid, cutoff, k_max=k_max,
                               include_self=True)


def test_shell_curvature_circle():
    """Normal-gradient curvature of a circle of radius R with outward
    normals is 1/R (AverageShellCurvature oracle)."""
    from sphinxsys_jax.neighbors import grid_from_bounds
    from sphinxsys_jax.physics import shell as sh
    from sphinxsys_jax.physics import shell_fluid as sf

    R = 1.0
    n_part = 128
    dx = 2 * math.pi * R / n_part
    theta = np.linspace(0.0, 2 * math.pi, n_part, endpoint=False)
    pos = R * np.stack([np.cos(theta), np.sin(theta)], -1)
    normal = np.stack([np.cos(theta), np.sin(theta)], -1)
    shell = _shell_state(pos, normal, dx, 0.05)

    ad = _kernel(dx, 2)
    grid = grid_from_bounds((-1.5, -1.5), (1.5, 1.5), ad.cutoff)
    nl = _nl(pos, pos, grid, ad.cutoff, k_max=12)
    k1, k2 = sf.shell_curvature(shell, nl, sh.ReducedKernel(ad.kernel), 2)
    np.testing.assert_allclose(np.asarray(k1), 1.0 / R, rtol=0.05)
    np.testing.assert_allclose(np.asarray(k2), 0.0, atol=1e-6)


def test_flat_shell_contact_equals_explicit_wall_slab():
    """For a FLAT shell (k = 0) the dummy-particle stack IS a lattice wall
    slab: the corrected pair sums must match plain kernel sums over an
    explicit multi-layer wall with one fluid particle, to float roundoff."""
    from sphinxsys_jax.neighbors import grid_from_bounds
    from sphinxsys_jax.physics import shell_fluid as sf
    from sphinxsys_jax.physics.pair import pair_geometry

    dx = 0.1
    ad = _kernel(dx, 2)
    kernel = ad.kernel
    # shell line along y = 0, normals DOWN (away from the fluid above)
    xs = np.arange(-1.0 + dx / 2, 1.0, dx)
    pos_s = np.stack([xs, np.zeros_like(xs)], -1)
    n_s = np.tile([0.0, -1.0], (len(xs), 1))
    thickness = 0.35
    shell = _shell_state(pos_s, n_s, dx, thickness)

    pos_q = np.asarray([[0.03, 0.17]])   # one fluid particle above the line
    grid = grid_from_bounds((-1.2, -1.5), (1.2, 0.6), ad.cutoff)
    nl = _nl(pos_q, pos_s, grid, ad.cutoff, k_max=16)
    zero = jnp.zeros((len(xs),), jnp.float32)
    pairs = sf.shell_contact_pairs(jnp.asarray(pos_q, jnp.float32), shell,
                                   zero, zero, nl, kernel, 2, dx)

    # corrected sums (x shell area dx) over all shell neighbors
    area = dx
    got_dWV = float(jnp.sum(pairs.dWV * area))
    got_W = float(jnp.sum(pairs.W * area * thickness))  # x m/rho0 = A*t

    # explicit slab: layers at y = 0, -dx, -2dx, ... with volume dx^2
    n_layer = sf.n_dummy_static(kernel, dx) + 1
    pos_w = np.concatenate([
        np.stack([xs, np.full_like(xs, -k * dx)], -1) for k in range(n_layer)])
    nlw = _nl(pos_q, pos_w, grid, ad.cutoff, k_max=16 * n_layer)
    pgw = pair_geometry(jnp.asarray(pos_q, jnp.float32),
                        jnp.asarray(pos_w, jnp.float32), nlw, kernel, 2)
    want_dWV = float(jnp.sum(pgw.dW) * dx * dx)
    want_W = float(jnp.sum(pgw.W) * dx * dx)

    assert abs(got_dWV - want_dWV) < 1e-5 * abs(want_dWV)
    assert abs(got_W - want_W) < 1e-5 * abs(want_W)

    # corrected direction: weighted average of dummy-stack directions
    e = np.asarray(pairs.e)
    mask = np.asarray(pairs.mask)
    assert np.all(np.abs(np.linalg.norm(e[mask], axis=-1) - 1.0) < 0.2)


def test_hydrostatic_fsi_matches_analytic_deflection():
    """Composed case at the reference dp_2 CI resolution: the settled gate
    mid-span deflection matches the clamped-clamped analytic solution
    p L^4/(384 E I) within the reference's own 15% gate
    (test_2d_hydrostatic_fluid_shell.cpp:395-409; full run in
    benchmarks/run_hydrofsi_validation.py settles flat at -8.23e-5 by
    t = 0.14, err 13.2%)."""
    from sphinxsys_jax.cases import hydrostatic_fsi_2d as hf

    case, fluid, gate = hf.build_case(dx=0.025)
    s = hf.init_sim(case, fluid, gate)
    run = hf.make_run_chunk(case)
    s = run(s, jnp.asarray(0.16, s.time.dtype))
    assert not bool(s.overflow)
    vel = np.asarray(s.fluid["Velocity"])
    assert not np.isnan(vel).any()
    d = hf.center_displacement(case, s)
    assert d < 0.0, f"gate must deflect down, got {d}"
    err = abs(abs(d) - hf.ANALYTIC_DISP) / hf.ANALYTIC_DISP
    assert err < 0.15, f"deflection {d:.3e} vs analytic {hf.ANALYTIC_DISP:.3e}"
    # fluid must not leak through the gate
    assert np.asarray(s.fluid["Position"])[:, 1].min() > -2 * case.dx
