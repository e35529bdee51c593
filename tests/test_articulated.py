"""Articulated multibody trees (physics/articulated.py) vs analytic
mechanics + the play_simbody reference case semantics
(/root/reference/tests/3d_examples/test_3d_play_simbody/)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import play_simbody_3d as ps
from sphinxsys_jax.physics import articulated as art

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

G = 9.81


def _single_pendulum(dtype=jnp.float64):
    """One link: joint 1 above the COM, unit mass, unit COM inertia."""
    return art.ArticulatedTree(
        parent=np.asarray([-1]),
        axis=jnp.asarray([[0.0, 0.0, 1.0]], dtype),
        r_parent=jnp.asarray([[0.0, 0.0, 0.0]], dtype),
        r_child=jnp.asarray([[0.0, 1.0, 0.0]], dtype),
        mass=jnp.ones(1, dtype),
        inertia=jnp.eye(3, dtype=dtype)[None],
        com=jnp.zeros((1, 3), dtype),
    )


def test_compound_pendulum_small_oscillation_period():
    """omega^2 = m g d / (I_com + m d^2) = g/2 for m=I=d=1."""
    tree = _single_pendulum()
    step = art.make_articulated_step(tree, gravity=(0.0, -G, 0.0))
    q = jnp.asarray([0.05])
    u = jnp.zeros(1)
    tau = jnp.zeros(1)
    t_expect = 2.0 * math.pi / math.sqrt(G / 2.0)

    @jax.jit
    def trajectory(q, u):
        # 8 s (~2.8 periods) sampled every 8 ms for the zero crossings
        def body(c, i):
            qq, uu = c
            qq, uu = step(i * 8e-3, qq, uu, 8e-3, tau)
            return (qq, uu), qq[0]
        _, traj = jax.lax.scan(body, (q, u), jnp.arange(1000))
        return traj

    traj = np.asarray(trajectory(q, u))
    # crossing-based period estimate
    sign = np.sign(traj)
    crossings = np.where(np.diff(sign) > 0)[0] * 8e-3
    periods = np.diff(crossings)
    assert abs(periods.mean() - t_expect) / t_expect < 0.01, (
        periods.mean(), t_expect)


def test_double_pendulum_conserves_energy():
    """Free chaotic double pendulum: RK4 at dt=1e-3 must hold E to 1e-6."""
    dtype = jnp.float64
    tree = art.ArticulatedTree(
        parent=np.asarray([-1, 0]),
        axis=jnp.tile(jnp.asarray([0.0, 0.0, 1.0], dtype), (2, 1)),
        r_parent=jnp.asarray([[0.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype),
        r_child=jnp.tile(jnp.asarray([0.0, 1.0, 0.0], dtype), (2, 1)),
        mass=jnp.asarray([1.0, 2.0], dtype),
        inertia=jnp.concatenate([jnp.eye(3, dtype=dtype)[None] * 0.4,
                                 jnp.eye(3, dtype=dtype)[None] * 0.1]),
        com=jnp.asarray([[0.1, 0.0, 0.0], [0.0, -0.2, 0.0]], dtype),
    )
    gravity = (0.0, -G, 0.0)
    step = art.make_articulated_step(tree, gravity=gravity)
    q = jnp.asarray([1.2, -0.7], dtype)
    u = jnp.asarray([0.3, 0.9], dtype)

    def energy(q, u):
        return (art.kinetic_energy(tree, q, u)
                + art.potential_energy(tree, q, jnp.asarray(gravity, dtype)))

    e0 = float(energy(q, u))
    dt = jnp.asarray(1e-3, dtype)
    tau = jnp.zeros(2, dtype)

    @jax.jit
    def advance(q, u):
        def body(i, c):
            qq, uu = c
            return step(i * dt, qq, uu, dt, tau)
        return jax.lax.fori_loop(0, 3000, body, (q, u))

    q3, u3 = advance(q, u)
    e3 = float(energy(q3, u3))
    assert abs(e3 - e0) / abs(e0) < 1e-6, (e0, e3)
    # and it actually moved (chaotic swing, not frozen)
    assert abs(float(q3[0]) - 1.2) > 0.05


def test_mass_matrix_reproduces_kinetic_energy():
    """T(q,u) == 0.5 u^T M(q) u for random configurations."""
    tree = ps.build_tree()
    rng = np.random.default_rng(3)
    for _ in range(3):
        q = jnp.asarray(rng.uniform(-1, 1, 3))
        u = jnp.asarray(rng.uniform(-1, 1, 3))
        M = art.mass_matrix(tree, q)
        np.testing.assert_allclose(np.asarray(M), np.asarray(M).T, atol=1e-12)
        assert np.all(np.linalg.eigvalsh(np.asarray(M)) > 0)
        t_direct = float(art.kinetic_energy(tree, q, u))
        t_quad = float(0.5 * u @ M @ u)
        np.testing.assert_allclose(t_quad, t_direct, rtol=1e-10)


def test_generalized_forces_single_link_lever_arm():
    """A world force F at the COM of a hanging link gives tau = (r x F)_z
    about the joint axis."""
    tree = _single_pendulum()
    q = jnp.asarray([0.3])
    kin = art.forward_kinematics(tree, q, jnp.zeros(1))
    F = jnp.asarray([[2.0, 0.5, 0.0]])
    T = jnp.zeros((1, 3))
    tau = art.generalized_forces(tree, q, F, T)
    joint_w = np.zeros(3)  # r_parent = origin
    r = np.asarray(kin.c[0]) - joint_w
    expect = r[0] * 0.5 - r[1] * 2.0
    np.testing.assert_allclose(float(tau[0]), expect, rtol=1e-10)
    # a pure world torque about z adds straight through
    tau2 = art.generalized_forces(tree, q, jnp.zeros((1, 3)),
                                  jnp.asarray([[0.0, 0.0, 1.5]]))
    np.testing.assert_allclose(float(tau2[0]), 1.5, rtol=1e-10)


def test_prescribed_triple_pendulum_follows_motions_exactly():
    """play_simbody: all three pins prescribed -> q(t) equals the ramped
    sinusoids and the tip matches the closed-form FK composition."""
    tree = ps.build_tree()
    motions = ps.build_motions()
    run = ps.make_run_step(tree, motions)
    s = ps.init_sim()
    for _ in range(4):
        s = run(s)
    t = float(s.t)
    np.testing.assert_allclose(t, 4.0, atol=1e-9)
    expect_q = [float(f(jnp.asarray(t, jnp.float64))) for f in motions.fns]
    np.testing.assert_allclose(np.asarray(s.q), expect_q, atol=1e-12)
    # independent numpy FK of the chain tip (link-2 origin)
    def numpy_tip(qs):
        R = np.eye(3)
        p = np.zeros(3)
        for qi in qs:
            c, si = np.cos(qi), np.sin(qi)
            Rq = np.asarray([[c, -si, 0.0], [si, c, 0.0], [0.0, 0.0, 1.0]])
            joint = p + R @ np.asarray([0.0, -1.0, 0.0])
            R = R @ Rq
            p = joint - R @ np.asarray([0.0, 1.0, 0.0])
        return p
    kin = art.forward_kinematics(tree, s.q, s.u)
    np.testing.assert_allclose(np.asarray(kin.p[2]), numpy_tip(expect_q),
                               atol=1e-10)


def test_play_simbody_state_engine_restart(tmp_path):
    """Run 10 steps writing XML states; restarting from step 5 reproduces
    the final state bit-for-bit (play_simbody.cpp:51-68 restart path)."""
    out = str(tmp_path)
    s_full = ps.run_case(out)
    t10, q10, u10 = art.read_state_xml(out, 10)
    s_re = ps.run_case(out, restart_step=5)
    np.testing.assert_array_equal(np.asarray(s_re.q, np.float64), q10)
    np.testing.assert_array_equal(np.asarray(s_re.u, np.float64), u10)
    np.testing.assert_allclose(float(s_re.t), t10, atol=0)
    np.testing.assert_allclose(t10, 10.0, atol=1e-9)
