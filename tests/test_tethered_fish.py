"""Tethered dead fish in flow (test_2d_tethered_dead_fish_in_flow):
the articulated (Simbody-analog) solver coupled to fluid forces — planar
mobilizer + cable spring + passive elastic body FSI."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import tethered_fish_2d as tf
from sphinxsys_jax.physics import articulated as ab

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_planar_tree_free_body():
    """The slider-slider-pin Planar chain reproduces free rigid-body
    dynamics: a force F at the COM gives udot = F/m on the sliders, a
    pure torque gives thetadot_dot = T/Izz."""
    tree = ab.planar_tree(2.0, 0.5, (1.0, 2.0, 0.0))
    q = jnp.zeros(3)
    u = jnp.zeros(3)
    forces = jnp.zeros((3, 3)).at[2].set(jnp.asarray([4.0, -2.0, 0.0]))
    torques = jnp.zeros((3, 3)).at[2].set(jnp.asarray([0.0, 0.0, 3.0]))
    tau = ab.generalized_forces(tree, q, forces, torques)
    udot = ab.forward_dynamics(tree, q, u, tau, (0.0, 0.0, 0.0))
    assert np.allclose(np.asarray(udot), [2.0, -1.0, 6.0], atol=1e-5)

    # kinematics at a rotated, displaced configuration
    kin = ab.forward_kinematics(tree, jnp.asarray([0.5, -0.25, np.pi / 2]),
                                jnp.zeros(3))
    assert np.allclose(np.asarray(kin.c[2]), [1.5, 1.75, 0.0], atol=1e-6)
    assert np.allclose(np.asarray(kin.R[2][:2, :2]),
                       [[0.0, -1.0], [1.0, 0.0]], atol=1e-6)


@pytest.fixture(scope="module")
def short_run():
    case, fluid, fish = tf.build_case(dx=0.15)
    s = tf.init_sim(case, fluid, fish)
    run = tf.make_run_chunk(case)
    s = run(s, jnp.asarray(0.5, s.time.dtype))
    return case, s


def test_composition_stable(short_run):
    case, s = short_run
    assert not bool(s.overflow)
    assert np.isfinite(np.asarray(s.fluid["Velocity"])).all()
    assert np.isfinite(np.asarray(s.fish["Position"])).all()
    assert np.isfinite(np.asarray(s.q)).all()


def test_tether_physics(short_run):
    """The ramped inflow drags the fish downstream until the initially
    just-slack cable (anchor->nose distance = rest length 3.0,
    cpp:29,378) goes taut; the head stays near the channel centerline."""
    case, s = short_run
    q = np.asarray(s.q)
    # downstream drift, bounded by the cable
    assert 0.005 < q[0] < 0.5
    assert abs(q[1]) < 0.2 and abs(q[2]) < 0.3
    assert tf.cable_tension(case, s) >= 0.0
    # head particles moved rigidly: pairwise distances preserved
    head = np.asarray(case.head_mask)
    p = np.asarray(s.fish["Position"])[head]
    p0 = np.asarray(s.fish["InitialPosition"])[head]
    d = np.linalg.norm(p[0] - p[-1])
    d0 = np.linalg.norm(p0[0] - p0[-1])
    assert abs(d - d0) < 1e-4 * max(d0, 1.0)
