"""Rigid-body coupling tests (Simbody-bridge counterpart)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.physics import rigid as rg


def test_rigid_ballistics_with_spin():
    """Free rigid body under gravity with a constant torque: analytic
    parabola + angular acceleration."""
    rb = rg.RigidBody2D(com=jnp.zeros(2), vel=jnp.asarray([1.0, 2.0]),
                        theta=jnp.zeros(()), omega=jnp.zeros(()),
                        mass=jnp.asarray(2.0), inertia=jnp.asarray(0.5))
    dt = 1e-3
    g = (0.0, -9.81)
    torque = jnp.asarray(0.1)
    for _ in range(1000):
        rb = rg.rigid_step(rb, jnp.zeros(2), torque, dt, gravity=g)
    t = 1.0
    np.testing.assert_allclose(float(rb.com[0]), 1.0 * t, rtol=1e-3)
    np.testing.assert_allclose(float(rb.com[1]), 2.0 * t - 0.5 * 9.81 * t**2,
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(rb.omega), (0.1 / 0.5) * t, rtol=1e-6)
    np.testing.assert_allclose(float(rb.theta), 0.5 * (0.1 / 0.5) * t**2,
                               rtol=2e-3)


def test_constraint_imposes_rigid_motion():
    from sphinxsys_jax.core.state import make_solid_state

    pos0 = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    state = dict(make_solid_state(pos0, 0.1, 1.0))
    mask = jnp.ones(3, bool)
    rb = rg.RigidBody2D(com=jnp.asarray([2.0, 1.0]), vel=jnp.asarray([0.5, 0.0]),
                        theta=jnp.asarray(math.pi / 2), omega=jnp.asarray(1.0),
                        mass=jnp.asarray(1.0), inertia=jnp.asarray(1.0))
    com0 = jnp.asarray(pos0.mean(axis=0))
    out = rg.constrain_by_rigid_body(state, mask, rb, jnp.asarray(pos0), com0)
    p = np.asarray(out["Position"])
    # 90-degree rotation about COM0 then translation to COM
    r0 = pos0 - np.asarray(com0)
    expect = np.asarray([2.0, 1.0]) + r0 @ np.asarray([[0.0, -1.0], [1.0, 0.0]]).T
    np.testing.assert_allclose(p, expect, atol=1e-6)
    # velocity = V + omega x r
    v = np.asarray(out["Velocity"])
    r = p - np.asarray([2.0, 1.0])
    expect_v = np.asarray([0.5, 0.0]) + np.stack([-r[:, 1], r[:, 0]], -1)
    np.testing.assert_allclose(v, expect_v, atol=1e-6)


@pytest.mark.parametrize("", [()])
def test_floating_block_archimedes(_=None):
    """A half-density block dropped at the free surface must settle into a
    heave oscillation about the Archimedes draft (rho_ratio * height), with
    the theoretical heave period 2 pi sqrt(m / (rho g A))."""
    from sphinxsys_jax.cases import floating_body_2d as fb

    case, fluid = fb.build_case(dx=0.025)
    s = fb.init_sim(case, fluid)
    run = fb.make_run_chunk(case)
    drafts, times = [], []
    for i in range(1, 17):
        s = run(s, jnp.asarray(i * 0.125, s.time.dtype))
        drafts.append(fb.WH - (float(s.rb.com[1]) - fb.BH / 2))
        times.append(float(s.time))
    assert not bool(s.overflow)
    drafts = np.asarray(drafts)
    target = fb.RHO_RATIO * fb.BH  # 0.05
    # oscillates about the Archimedes draft (coarse-resolution tolerance)
    mean_draft = drafts[len(drafts) // 2:].mean()
    assert 0.4 * target < mean_draft < 1.4 * target
    # it definitely sank in (not resting at draft ~0) and didn't sink through
    assert drafts.max() > 0.5 * target
    assert drafts.max() < fb.BH
    # block stays horizontal-ish and near the tank center
    assert abs(float(s.rb.theta)) < 0.3
    assert abs(float(s.rb.com[0]) - fb.DL / 2) < 0.1


# ---------------------------------------------------------------------------
# 3D six-DOF
# ---------------------------------------------------------------------------

def test_box_inertia_tensor_from_particles():
    """Inertia of a particle-sampled box must match 1/12 m (b^2+c^2)."""
    dx = 0.05
    a, b, c = 0.4, 0.2, 0.1
    xs = np.arange(-a / 2 + dx / 2, a / 2, dx)
    ys = np.arange(-b / 2 + dx / 2, b / 2, dx)
    zs = np.arange(-c / 2 + dx / 2, c / 2, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    n = len(pos)
    rho = 2.0
    state = {"Position": jnp.asarray(pos, jnp.float64),
             "Mass": jnp.full((n,), rho * dx**3, jnp.float64)}
    rb = rg.rigid_body_from_particles_3d(state, jnp.ones(n, bool))
    m = rho * a * b * c
    np.testing.assert_allclose(float(rb.mass), m, rtol=1e-12)
    # point masses at cell centers: sum x^2 over a uniform grid of extent a
    # is m (a^2 - dx^2)/12 exactly — compare against the discrete value
    da, db, dc = a**2 - dx**2, b**2 - dx**2, c**2 - dx**2
    expect = m / 12.0 * np.array([db + dc, da + dc, da + db])
    np.testing.assert_allclose(np.diag(np.asarray(rb.inertia_body)), expect,
                               rtol=1e-9)
    # and it approaches the continuum box inertia to O(dx^2)
    cont = m / 12.0 * np.array([b**2 + c**2, a**2 + c**2, a**2 + b**2])
    np.testing.assert_allclose(np.diag(np.asarray(rb.inertia_body)), cont,
                               rtol=0.15)
    off = np.asarray(rb.inertia_body) - np.diag(np.diag(np.asarray(rb.inertia_body)))
    assert np.abs(off).max() < 1e-12


def test_torque_free_tumbling_conserves_invariants():
    """Free asymmetric top: L (world) exactly conserved, rotational kinetic
    energy conserved to integrator order, quaternion stays unit."""
    I = jnp.asarray(np.diag([1.0, 2.0, 3.0]))
    rb = rg.RigidBody3D(com=jnp.zeros(3), vel=jnp.zeros(3),
                        quat=jnp.asarray([1.0, 0.0, 0.0, 0.0]),
                        ang_mom=I @ jnp.asarray([2.0, 0.1, 1.0]),
                        mass=jnp.asarray(1.0), inertia_body=I)

    def ke(rb):
        w = rg.angular_velocity(rb)
        R = rg.quat_to_matrix(rb.quat)
        return 0.5 * float(w @ (R @ (rb.inertia_body @ (R.T @ w))))

    L0, ke0 = np.asarray(rb.ang_mom), ke(rb)
    dt = 5e-4
    for _ in range(4000):  # t = 2, several tumbles
        rb = rg.rigid_step_3d(rb, jnp.zeros(3), jnp.zeros(3), dt)
    np.testing.assert_allclose(np.asarray(rb.ang_mom), L0, rtol=1e-12)
    np.testing.assert_allclose(ke(rb), ke0, rtol=2e-3)
    np.testing.assert_allclose(float(jnp.linalg.norm(rb.quat)), 1.0, rtol=1e-9)
    # it actually tumbled (attitude far from identity)
    assert abs(float(rb.quat[0])) < 0.999


def test_constant_torque_spin_up_and_gravity_3d():
    I = jnp.asarray(np.diag([0.5, 0.5, 0.8]))
    rb = rg.RigidBody3D(com=jnp.zeros(3), vel=jnp.asarray([1.0, 0.0, 2.0]),
                        quat=jnp.asarray([1.0, 0.0, 0.0, 0.0]),
                        ang_mom=jnp.zeros(3),
                        mass=jnp.asarray(2.0), inertia_body=I)
    dt, g = 1e-3, (0.0, 0.0, -9.81)
    torque = jnp.asarray([0.0, 0.0, 0.4])
    for _ in range(1000):
        rb = rg.rigid_step_3d(rb, jnp.zeros(3), torque, dt, gravity=g)
    t = 1.0
    np.testing.assert_allclose(float(rb.com[0]), 1.0 * t, rtol=1e-3)
    np.testing.assert_allclose(float(rb.com[2]), 2.0 * t - 0.5 * 9.81 * t**2,
                               rtol=5e-3, atol=5e-3)
    w = np.asarray(rg.angular_velocity(rb))
    np.testing.assert_allclose(w[2], 0.4 / 0.8 * t, rtol=1e-6)
    # spin axis is principal: attitude is a pure z-rotation
    np.testing.assert_allclose(np.asarray(rb.quat[1:3]), 0.0, atol=1e-12)


def test_constraint_imposes_rigid_motion_3d():
    pos0 = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                       [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    state = {"Position": jnp.asarray(pos0), "Velocity": jnp.zeros((4, 3))}
    half = np.sqrt(0.5)
    q_z90 = jnp.asarray([half, 0.0, 0.0, half])  # 90 deg about z
    I = jnp.eye(3) * 2.0
    omega = np.asarray([0.0, 0.0, 1.5])
    rb = rg.RigidBody3D(com=jnp.asarray([2.0, 1.0, 0.5]),
                        vel=jnp.asarray([0.5, 0.0, 0.0]), quat=q_z90,
                        ang_mom=I @ jnp.asarray(omega),
                        mass=jnp.asarray(1.0), inertia_body=I)
    com0 = jnp.asarray(pos0.mean(axis=0))
    out = rg.constrain_by_rigid_body_3d(state, jnp.ones(4, bool), rb,
                                        jnp.asarray(pos0), com0)
    p = np.asarray(out["Position"])
    Rz = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    expect = np.asarray([2.0, 1.0, 0.5]) + (pos0 - np.asarray(com0)) @ Rz.T
    np.testing.assert_allclose(p, expect, atol=1e-12)
    v = np.asarray(out["Velocity"])
    r = p - np.asarray([2.0, 1.0, 0.5])
    expect_v = np.asarray([0.5, 0.0, 0.0]) + np.cross(omega, r)
    np.testing.assert_allclose(v, expect_v, atol=1e-12)
