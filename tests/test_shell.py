"""Thin-shell dynamics tests (thin_structure_dynamics analog).

The oracle: a shell cantilever strip with the oscillating-beam case's
material/geometry must reproduce the SOLID beam's tip oscillation
(period 0.280 s, amplitude 0.114) with a single particle row."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.physics import shell as sh


def test_transformation_matrix_2d():
    n = jnp.asarray([[0.0, 1.0], [1.0, 0.0]])
    Q = np.asarray(sh.transformation_matrix_2d(n))
    np.testing.assert_allclose(Q[0], np.eye(2), atol=1e-7)
    # local y = global x: Q maps (1,0) -> (0,1)
    np.testing.assert_allclose(Q[1] @ np.asarray([1.0, 0.0]), [0.0, 1.0], atol=1e-7)
    # orthonormal
    np.testing.assert_allclose(Q[1] @ Q[1].T, np.eye(2), atol=1e-7)


def test_pseudo_normal_rotation_consistency():
    theta = jnp.asarray([0.3])
    n = np.asarray(sh.rotate_pseudo_normal_2d(theta))[0]
    np.testing.assert_allclose(n, [math.sin(0.3), math.cos(0.3)], atol=1e-7)
    # rate = d/dt rotate(theta(t)) with omega
    omega = jnp.asarray([2.0])
    rate = np.asarray(sh.pseudo_normal_rate_2d(theta, omega))[0]
    np.testing.assert_allclose(rate, [math.cos(0.3) * 2, -math.sin(0.3) * 2],
                               atol=1e-7)


def test_reduced_kernel_uses_lower_dim_factors():
    from sphinxsys_jax.core.kernels import WendlandC2

    k = WendlandC2(h=0.01)
    rk = sh.ReducedKernel(k)
    r = jnp.asarray(0.005)
    np.testing.assert_allclose(float(rk.W(r, 2)), float(k.W(r, 1)), rtol=1e-7)
    np.testing.assert_allclose(float(rk.dW(r, 2)), float(k.dW(r, 1)), rtol=1e-7)


@pytest.fixture(scope="module")
def shell_run():
    from sphinxsys_jax.cases import shell_cantilever_2d as sc

    case, s = sc.build_case()
    run = sc.make_run_chunk(case)
    tips, ts = [], []
    for i in range(1, 33):
        s = run(s, jnp.asarray(i * 0.02, s.time.dtype))
        ts.append(float(s.time))
        tips.append(sc.tip_displacement(case, s))
    return case, s, np.asarray(ts), np.asarray(tips)


def test_shell_cantilever_matches_solid_beam_oracle(shell_run):
    case, s, t, d = shell_run
    crossings = t[np.where(np.diff(np.sign(d)))[0]]
    period = 2 * np.mean(np.diff(crossings))
    # solid-beam result for identical parameters: T = 0.280, amp 0.114
    assert abs(period - 0.280) < 0.015
    assert abs(np.abs(d).max() - 0.114) < 0.012


def test_shell_clamp_holds(shell_run):
    case, s, _, _ = shell_run
    mask = np.asarray(case.base_mask)
    disp = np.asarray(s.shell["Position"] - s.shell["InitialPosition"])[mask]
    assert np.abs(disp).max() < 1e-12
    rot = np.asarray(s.shell["Rotation"])[mask]
    assert np.abs(rot).max() < 1e-12


def test_shell_pseudo_normal_stays_unit(shell_run):
    case, s, _, _ = shell_run
    nrm = np.linalg.norm(np.asarray(s.shell["PseudoNormal"]), axis=-1)
    np.testing.assert_allclose(nrm, 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# 3D rotation algebra + plate dynamics
# ---------------------------------------------------------------------------

def test_transformation_matrix_3d_orthonormal_maps_n_to_z():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(20, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[0] = [0.0, 0.0, 1.0]
    Q = np.asarray(sh.transformation_matrix_3d(jnp.asarray(n)))
    np.testing.assert_allclose(Q[0], np.eye(3), atol=1e-12)
    for i in range(20):
        np.testing.assert_allclose(Q[i] @ Q[i].T, np.eye(3), atol=1e-10)
        np.testing.assert_allclose(Q[i] @ n[i], [0.0, 0.0, 1.0], atol=1e-10)
        np.testing.assert_allclose(np.linalg.det(Q[i]), 1.0, atol=1e-10)


def test_pseudo_normal_rate_3d_is_rotation_derivative():
    rot = jnp.asarray([[0.3, -0.5, 0.0]])
    w = jnp.asarray([[0.7, 1.3, 0.0]])
    eps = 1e-6
    n0 = np.asarray(sh.rotate_pseudo_normal_3d(rot - 0.5 * eps * w))
    n1 = np.asarray(sh.rotate_pseudo_normal_3d(rot + 0.5 * eps * w))
    fd = (n1 - n0) / eps
    rate = np.asarray(sh.pseudo_normal_rate_3d(rot, w))
    np.testing.assert_allclose(rate, fd, atol=1e-6)
    # unit normal for any angles
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(sh.rotate_pseudo_normal_3d(rot))), 1.0,
        atol=1e-12)


def test_rotation_accel_3d_small_angle_limit():
    """Linearized pseudo normal is (theta_1, -theta_0, 1): a pure local
    x-acceleration of the normal must give domega_1/dt = a_x, a pure local
    y-acceleration domega_0/dt = -a_y."""
    zero = jnp.zeros((1, 3))
    acc = np.asarray(sh.rotation_accel_from_pseudo_normal_3d(
        jnp.asarray([[0.25, 0.0, 0.0]]), zero, zero))
    np.testing.assert_allclose(acc[0], [0.0, 0.25, 0.0], atol=1e-9)
    acc = np.asarray(sh.rotation_accel_from_pseudo_normal_3d(
        jnp.asarray([[0.0, 0.4, 0.0]]), zero, zero))
    np.testing.assert_allclose(acc[0], [-0.4, 0.0, 0.0], atol=1e-9)


@pytest.fixture(scope="module")
def plate_run():
    from sphinxsys_jax.cases import shell_plate_3d as sp

    case, s = sp.build_case()       # dx = PL/20
    run = sp.make_run_chunk(case)
    tips, ts = [], []
    for i in range(1, 33):
        s = run(s, jnp.asarray(i * 0.02, s.time.dtype))
        ts.append(float(s.time))
        tips.append(sp.tip_displacement(case, s))
    return case, s, np.asarray(ts), np.asarray(tips)


def test_plate_3d_matches_2d_shell_at_matched_resolution(plate_run):
    """nu=0 cylindrical plate bending == beam: the 3D plate must track the
    2D shell run at the same dx (measured: 0.380 vs 0.360 at PL/20; both
    converge toward the analytic 0.277 with resolution)."""
    import sphinxsys_jax.cases.shell_cantilever_2d as sc

    case, s, t, d = plate_run
    crossings = t[np.where(np.diff(np.sign(d)))[0]]
    period3 = 2 * np.mean(np.diff(crossings))

    old_nu = sc.POISSON
    try:
        sc.POISSON = 0.0
        case2, s2 = sc.build_case(dx=sc.PL / 20.0)
        run2 = sc.make_run_chunk(case2)
        tips2, ts2 = [], []
        for i in range(1, 33):
            s2 = run2(s2, jnp.asarray(i * 0.02, s2.time.dtype))
            ts2.append(float(s2.time))
            tips2.append(sc.tip_displacement(case2, s2))
    finally:
        sc.POISSON = old_nu
    t2, d2 = np.asarray(ts2), np.asarray(tips2)
    crossings2 = t2[np.where(np.diff(np.sign(d2)))[0]]
    period2 = 2 * np.mean(np.diff(crossings2))

    assert abs(period3 - period2) / period2 < 0.08
    assert abs(np.abs(d).max() - np.abs(d2).max()) / np.abs(d2).max() < 0.15


def test_plate_3d_invariants(plate_run):
    case, s, _, d = plate_run
    shell = s.shell
    pn = np.asarray(shell["PseudoNormal"])
    np.testing.assert_allclose(np.linalg.norm(pn, axis=1), 1.0, atol=1e-3)
    # cylindrical bending: no drift across the width, no twist (rot_0 ~ 0)
    dy = np.abs(np.asarray(shell["Position"][:, 1]
                           - shell["InitialPosition"][:, 1]))
    assert dy.max() < 1e-3
    rot = np.asarray(shell["Rotation"])
    assert np.abs(rot[:, 0]).max() < 0.02  # bends about y only
    # clamp holds
    mask = np.asarray(case.base_mask)
    disp = np.asarray(shell["Position"] - shell["InitialPosition"])[mask]
    assert np.abs(disp).max() < 1e-12
