"""Rigid multi-body coupling (native counterpart of the Simbody bridge).

Counterpart of /root/reference/src/shared/simbody_sphinxsys/ +
solid_dynamics/constraint_dynamics.h:156-184: the reference funnels SPH
forces into SimTK mobilized bodies and imposes the resulting rigid motion
back on the particles.  Here the rigid solver is native (and jit-compiled
like everything else):

  * RigidBody2D: COM state (x, v, theta, omega) + mass/inertia
  * total_force_and_torque: reduce the SPH forces of a body part onto the
    COM (TotalForceForSimBody analog)
  * rigid_step: symplectic Euler of the planar 3-DOF equations
  * constrain_by_rigid_body: impose the rigid transform on the particles
    (ConstraintBySimBody analog), with velocities v + omega x r.

3D (6-DOF, the SimTK::MobilizedBody::Free analog): RigidBody3D carries a
unit quaternion and the world-frame angular momentum; the step integrates
L += torque*dt, recovers omega = R I_body^-1 R^T L, and advances the
quaternion by dq/dt = 0.5 q (0, omega) — angular momentum is conserved
exactly under zero torque, including for tumbling asymmetric bodies.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphinxsys_jax.core.state import State


class RigidBody2D(NamedTuple):
    com: jnp.ndarray       # (2,)
    vel: jnp.ndarray       # (2,)
    theta: jnp.ndarray     # ()
    omega: jnp.ndarray     # ()
    mass: jnp.ndarray      # ()
    inertia: jnp.ndarray   # () about COM


def rigid_body_from_particles(state: State, mask) -> RigidBody2D:
    """Mass properties from a particle set (SolidBodyPartForSimbody,
    body_part_for_simbody.h:43)."""
    dtype = state["Position"].dtype
    m = jnp.where(mask, state["Mass"], 0.0)
    total = jnp.sum(m)
    com = jnp.sum(m[:, None] * state["Position"], axis=0) / total
    r = state["Position"] - com
    inertia = jnp.sum(m * jnp.sum(r * r, axis=-1))
    z = jnp.zeros((), dtype)
    return RigidBody2D(com=com, vel=jnp.zeros(2, dtype),
                       theta=z, omega=z, mass=total, inertia=inertia)


def total_force_and_torque(state: State, mask, rb: RigidBody2D,
                           force_keys=("Force", "ForcePrior")):
    """Reduce SPH forces on the body part to a COM force + torque
    (TotalForceForSimBody, constraint_dynamics.h:170-184)."""
    f = jnp.zeros_like(state["Position"])
    for k in force_keys:
        f = f + state[k]
    f = jnp.where(mask[:, None], f, 0.0)
    total_f = jnp.sum(f, axis=0)
    r = state["Position"] - rb.com
    torque = jnp.sum(jnp.where(mask, r[:, 0] * f[:, 1] - r[:, 1] * f[:, 0], 0.0))
    return total_f, torque


def rigid_step(rb: RigidBody2D, force, torque, dt, gravity=None) -> RigidBody2D:
    """Symplectic Euler for the planar rigid equations."""
    acc = force / rb.mass
    if gravity is not None:
        acc = acc + jnp.asarray(gravity, dtype=force.dtype)
    vel = rb.vel + acc * dt
    com = rb.com + vel * dt
    omega = rb.omega + (torque / rb.inertia) * dt
    theta = rb.theta + omega * dt
    return rb._replace(com=com, vel=vel, theta=theta, omega=omega)


def constrain_by_rigid_body(state: State, mask, rb: RigidBody2D,
                            initial_pos, initial_com) -> State:
    """Impose the rigid transform on the part's particles
    (ConstraintBySimBody::update): x = COM + R(theta) (x0 - COM0),
    v = V + omega x r, and the averaged-wall kinematics follow."""
    out = dict(state)
    c, s = jnp.cos(rb.theta), jnp.sin(rb.theta)
    R = jnp.asarray([[c, -s], [s, c]], dtype=state["Position"].dtype)
    r0 = initial_pos - initial_com
    new_pos = rb.com + r0 @ R.T
    r = new_pos - rb.com
    new_vel = rb.vel + rb.omega * jnp.stack([-r[:, 1], r[:, 0]], axis=-1)
    m = mask[:, None]
    out["Position"] = jnp.where(m, new_pos, state["Position"])
    out["Velocity"] = jnp.where(m, new_vel, state["Velocity"])
    if "AverageVelocity" in state:
        out["AverageVelocity"] = jnp.where(m, new_vel, state["AverageVelocity"])
    if "NormalDirection" in state and "InitialNormalDirection" in state:
        out["NormalDirection"] = jnp.where(
            m, state["InitialNormalDirection"] @ R.T, state["NormalDirection"])
    return out

# ---------------------------------------------------------------------------
# 3D six-degree-of-freedom rigid body (quaternion attitude)
# ---------------------------------------------------------------------------

class RigidBody3D(NamedTuple):
    com: jnp.ndarray           # (3,)
    vel: jnp.ndarray           # (3,)
    quat: jnp.ndarray          # (4,) unit quaternion (w, x, y, z), body->world
    ang_mom: jnp.ndarray       # (3,) angular momentum, world frame
    mass: jnp.ndarray          # ()
    inertia_body: jnp.ndarray  # (3,3) inertia tensor about COM, body frame


def quat_to_matrix(q):
    """Rotation matrix of a unit quaternion (w,x,y,z), body->world."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def quat_multiply(a, b):
    aw, av = a[0], a[1:]
    bw, bv = b[0], b[1:]
    return jnp.concatenate([
        (aw * bw - jnp.dot(av, bv))[None],
        aw * bv + bw * av + jnp.cross(av, bv)])


def rigid_body_from_particles_3d(state: State, mask) -> RigidBody3D:
    """Mass, COM, and the full inertia tensor of a particle set
    (SolidBodyPartForSimbody's SimTK::MassProperties)."""
    dtype = state["Position"].dtype
    m = jnp.where(mask, state["Mass"], 0.0)
    total = jnp.sum(m)
    com = jnp.sum(m[:, None] * state["Position"], axis=0) / total
    r = state["Position"] - com
    r2 = jnp.sum(r * r, axis=-1)
    eye = jnp.eye(3, dtype=dtype)
    inertia = jnp.sum(m[:, None, None]
                      * (r2[:, None, None] * eye - r[:, :, None] * r[:, None, :]),
                      axis=0)
    q0 = jnp.concatenate([jnp.ones((1,), dtype), jnp.zeros((3,), dtype)])
    return RigidBody3D(com=com.astype(dtype), vel=jnp.zeros(3, dtype), quat=q0,
                       ang_mom=jnp.zeros(3, dtype), mass=total.astype(dtype),
                       inertia_body=inertia.astype(dtype))


def total_force_and_torque_3d(state: State, mask, rb: RigidBody3D,
                              force_keys=("Force", "ForcePrior")):
    """Reduce SPH forces on the part to COM force + torque vector."""
    f = jnp.zeros_like(state["Position"])
    for k in force_keys:
        f = f + state[k]
    f = jnp.where(mask[:, None], f, 0.0)
    total_f = jnp.sum(f, axis=0)
    r = state["Position"] - rb.com
    torque = jnp.sum(jnp.cross(r, f) * mask[:, None], axis=0)
    return total_f, torque


def angular_velocity(rb: RigidBody3D):
    """omega = R I_body^-1 R^T L (world frame)."""
    R = quat_to_matrix(rb.quat)
    inv_I = jnp.linalg.inv(rb.inertia_body)
    return R @ (inv_I @ (R.T @ rb.ang_mom))


def rigid_step_3d(rb: RigidBody3D, force, torque, dt,
                  gravity=None) -> RigidBody3D:
    """Symplectic Euler on (v, x) and (L, q); the attitude update uses the
    mid-configuration angular velocity from the already-updated L, and the
    quaternion is renormalized (no drift)."""
    acc = force / rb.mass
    if gravity is not None:
        acc = acc + jnp.asarray(gravity, dtype=force.dtype)
    vel = rb.vel + acc * dt
    com = rb.com + vel * dt
    L = rb.ang_mom + torque * dt
    rb_mid = rb._replace(ang_mom=L)
    omega = angular_velocity(rb_mid)
    dq = 0.5 * quat_multiply(jnp.concatenate([jnp.zeros((1,), omega.dtype), omega]),
                             rb.quat)
    quat = rb.quat + dq * dt
    quat = quat / jnp.linalg.norm(quat)
    return rb._replace(com=com, vel=vel, quat=quat, ang_mom=L)


def constrain_by_rigid_body_3d(state: State, mask, rb: RigidBody3D,
                               initial_pos, initial_com) -> State:
    """Impose the 6-DOF rigid transform on the part's particles:
    x = COM + R (x0 - COM0), v = V + omega x r."""
    out = dict(state)
    R = quat_to_matrix(rb.quat).astype(state["Position"].dtype)
    r0 = initial_pos - initial_com
    new_pos = rb.com + r0 @ R.T
    r = new_pos - rb.com
    omega = angular_velocity(rb)
    new_vel = rb.vel + jnp.cross(jnp.broadcast_to(omega, r.shape), r)
    m = mask[:, None]
    out["Position"] = jnp.where(m, new_pos, state["Position"])
    out["Velocity"] = jnp.where(m, new_vel, state["Velocity"])
    if "AverageVelocity" in state:
        out["AverageVelocity"] = jnp.where(m, new_vel, state["AverageVelocity"])
    if "NormalDirection" in state and "InitialNormalDirection" in state:
        out["NormalDirection"] = jnp.where(
            m, state["InitialNormalDirection"] @ R.T, state["NormalDirection"])
    return out


# ---------------------------------------------------------------------------
# Articulated bodies: planar pin (revolute) joint — the
# SimTK::MobilizedBody::Pin + Force::MobilityLinearDamper pairing the OWSC
# wave-energy flap uses (test_2d_owsc/owsc.cpp:151-158).
# ---------------------------------------------------------------------------

class PinJoint2D(NamedTuple):
    pivot: jnp.ndarray          # (2,) fixed world anchor
    theta: jnp.ndarray          # () rotation about the pivot
    omega: jnp.ndarray          # ()
    mass: jnp.ndarray           # ()
    inertia: jnp.ndarray        # () about the PIVOT
    com0: jnp.ndarray           # (2,) initial COM (for the gravity torque)


def pin_joint_from_particles(state: State, mask, pivot) -> PinJoint2D:
    dtype = state["Position"].dtype
    pv = jnp.asarray(pivot, dtype)
    m = jnp.where(mask, state["Mass"], 0.0)
    total = jnp.sum(m)
    com = jnp.sum(m[:, None] * state["Position"], axis=0) / total
    r = state["Position"] - pv
    inertia = jnp.sum(m * jnp.sum(r * r, axis=-1))
    z = jnp.zeros((), dtype)
    return PinJoint2D(pivot=pv, theta=z, omega=z, mass=total,
                      inertia=inertia, com0=com)


def pin_torque(state: State, mask, pj: PinJoint2D,
               force_keys=("Force", "ForcePrior")):
    """Torque of the part's SPH forces about the pivot."""
    f = jnp.zeros_like(state["Position"])
    for k in force_keys:
        f = f + state[k]
    f = jnp.where(mask[:, None], f, 0.0)
    r = state["Position"] - pj.pivot
    return jnp.sum(r[:, 0] * f[:, 1] - r[:, 1] * f[:, 0])


def pin_joint_step(pj: PinJoint2D, torque, dt, damping: float = 0.0,
                   stiffness: float = 0.0, gravity=None) -> PinJoint2D:
    """Symplectic Euler of I_pivot d(omega)/dt = tau - c omega - k theta
    (+ the gravity torque about the pivot); the damper c is the PTO
    (MobilityLinearDamper)."""
    tau = torque - damping * pj.omega - stiffness * pj.theta
    if gravity is not None:
        g = jnp.asarray(gravity, pj.pivot.dtype)
        c, s = jnp.cos(pj.theta), jnp.sin(pj.theta)
        R = jnp.asarray([[c, -s], [s, c]], pj.pivot.dtype)
        com = pj.pivot + R @ (pj.com0 - pj.pivot)
        r = com - pj.pivot
        tau = tau + pj.mass * (r[0] * g[1] - r[1] * g[0])
    omega = pj.omega + tau / pj.inertia * dt
    theta = pj.theta + omega * dt
    return pj._replace(theta=theta, omega=omega)


def constrain_by_pin_joint(state: State, mask, pj: PinJoint2D,
                           initial_pos) -> State:
    """Impose the pivot rotation on the part's particles:
    x = pivot + R(theta)(x0 - pivot), v = omega x r."""
    out = dict(state)
    dtype = state["Position"].dtype
    c, s = jnp.cos(pj.theta), jnp.sin(pj.theta)
    R = jnp.asarray([[c, -s], [s, c]], dtype)
    r0 = initial_pos - pj.pivot
    new_pos = pj.pivot + r0 @ R.T
    r = new_pos - pj.pivot
    new_vel = pj.omega * jnp.stack([-r[:, 1], r[:, 0]], axis=-1)
    m = mask[:, None]
    out["Position"] = jnp.where(m, new_pos, state["Position"])
    out["Velocity"] = jnp.where(m, new_vel, state["Velocity"])
    if "AverageVelocity" in state:
        out["AverageVelocity"] = jnp.where(m, new_vel, state["AverageVelocity"])
    if "NormalDirection" in state and "InitialNormalDirection" in state:
        out["NormalDirection"] = jnp.where(
            m, state["InitialNormalDirection"] @ R.T, state["NormalDirection"])
    return out
