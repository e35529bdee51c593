"""Articulated rigid multibody trees (the Simbody mobilized-body analog).

Counterpart of the reference's SimTK coupling
(/root/reference/src/shared/simbody_sphinxsys/, exercised by
/root/reference/tests/3d_examples/test_3d_play_simbody/play_simbody.cpp:
pin-mobilized pendulum chains with prescribed sinusoidal motions and an
XML state engine) and the articulated piece the single pin joint in
physics/rigid.py could not express.

XLA-native design — this is NOT a port of Simbody's O(n) spatial-algebra
pipeline.  Multibody trees in SPH couplings are tiny (a handful of links),
so the right JAX formulation is *autodiff Lagrangian dynamics*:

  * forward kinematics is an unrolled traversal over the (static) tree in
    topological order — pure jnp, traced once;
  * the mass matrix is the exact Hessian of the kinetic energy in the
    joint rates, M(q) = d^2 T / du^2 (T is quadratic in u, so jax.hessian
    is exact, not an approximation);
  * the velocity-product (Coriolis/centrifugal) and gravity terms come
    from the Euler-Lagrange equation with every derivative taken by
    autodiff:  M udot = tau - (dG/dq) u + dT/dq - dV/dq,  G := dT/du.

Prescribed motions (SimTK::Motion::Custom, UdfMotion.h) are plain Python
time functions; their rates and accelerations are jax.grad's of the
position function — the reference hand-derives calcPrescribedPositionDot
/ DotDot (UdfMotion.h:33-67); here those two methods do not exist.
Prescribed DOFs are eliminated from the solve block-wise:
M_ff udot_f = rhs_f - M_fp udot_p.

The XML state save/restore channel mirrors SimbodyStateEngine
(state_engine.h:55): step-indexed snapshots of (t, q, u).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class ArticulatedTree(NamedTuple):
    """A tree of pin-mobilized rigid links.

    Link i attaches to ``parent[i]`` (-1 = ground/world) through a revolute
    joint: the joint sits at station ``r_parent`` in the parent's body frame
    (world frame for roots) and at station ``r_child`` in the child's body
    frame; the child rotates about ``axis`` (unit, expressed in the parent
    frame at q=0, where the child frame coincides with the parent frame) —
    the SimTK::MobilizedBody::Pin(parent, X_PF, body, X_BM) convention with
    X_PF.p = r_parent, X_BM.p = r_child and the pin about the frames'
    common axis.

    ``joint_type[i]`` selects the mobilizer: "pin" (revolute, the
    default) or "slider" (prismatic along ``axis`` — the
    SimTK::MobilizedBody::Slider convention; a Planar mobilizer is the
    chain slider-x -> slider-y -> pin of massless intermediate links,
    see `planar_tree`).  Because every dynamic quantity is derived from
    `forward_kinematics` by autodiff, prismatic joints need no new
    dynamics code.

    ``parent`` is a *static* numpy array (the tree's topology is trace-time
    structure, not data); everything else may be traced.
    """
    parent: np.ndarray        # (n,) int, parent[i] < i, -1 = ground
    axis: jnp.ndarray         # (n, 3) unit joint axes
    r_parent: jnp.ndarray     # (n, 3) joint station in parent frame
    r_child: jnp.ndarray      # (n, 3) joint station in child frame
    mass: jnp.ndarray         # (n,)
    inertia: jnp.ndarray      # (n, 3, 3) about the body COM, body frame
    com: jnp.ndarray          # (n, 3) COM station in body frame
    joint_type: tuple = ()    # static; () = all pins

    @property
    def n_links(self) -> int:
        return len(self.parent)


def _rot_axis_angle(axis, q):
    """Rodrigues rotation about a unit axis (3,3)."""
    c, s = jnp.cos(q), jnp.sin(q)
    K = jnp.asarray([[0.0, -axis[2], axis[1]],
                     [axis[2], 0.0, -axis[0]],
                     [-axis[1], axis[0], 0.0]], dtype=axis.dtype)
    eye = jnp.eye(3, dtype=axis.dtype)
    return eye + s * K + (1.0 - c) * (K @ K)


class LinkKinematics(NamedTuple):
    R: jnp.ndarray        # (n, 3, 3) body->world rotations
    p: jnp.ndarray        # (n, 3) body-frame origins in world
    v: jnp.ndarray        # (n, 3) origin velocities
    w: jnp.ndarray        # (n, 3) angular velocities
    c: jnp.ndarray        # (n, 3) world COM positions
    vc: jnp.ndarray       # (n, 3) world COM velocities


def forward_kinematics(tree: ArticulatedTree, q, u) -> LinkKinematics:
    """World frames and velocities of every link.

    The traversal is a Python loop over the (static) topology — unrolled
    at trace time into pure tensor ops, no data-dependent control flow."""
    dtype = tree.axis.dtype
    eye = jnp.eye(3, dtype=dtype)
    zero = jnp.zeros(3, dtype=dtype)
    Rs, ps, vs, ws = [], [], [], []
    for i in range(tree.n_links):
        pi = int(tree.parent[i])
        if pi < 0:
            R_p, p_p, v_p, w_p = eye, zero, zero, zero
        else:
            R_p, p_p, v_p, w_p = Rs[pi], ps[pi], vs[pi], ws[pi]
        a_w = R_p @ tree.axis[i]
        slider = bool(tree.joint_type) and tree.joint_type[i] == "slider"
        if slider:
            R_i = R_p
            rp_w = R_p @ tree.r_parent[i] + q[i] * a_w
            rc_w = R_i @ tree.r_child[i]
            p_i = p_p + rp_w - rc_w
            w_i = w_p
            v_i = v_p + jnp.cross(w_p, rp_w) + u[i] * a_w \
                - jnp.cross(w_i, rc_w)
        else:
            R_i = R_p @ _rot_axis_angle(tree.axis[i], q[i])
            rp_w = R_p @ tree.r_parent[i]
            rc_w = R_i @ tree.r_child[i]
            p_i = p_p + rp_w - rc_w
            w_i = w_p + u[i] * a_w
            v_i = v_p + jnp.cross(w_p, rp_w) - jnp.cross(w_i, rc_w)
        Rs.append(R_i), ps.append(p_i), vs.append(v_i), ws.append(w_i)
    R = jnp.stack(Rs)
    p = jnp.stack(ps)
    v = jnp.stack(vs)
    w = jnp.stack(ws)
    c = p + jnp.einsum("nij,nj->ni", R, tree.com)
    vc = v + jnp.cross(w, c - p)
    return LinkKinematics(R=R, p=p, v=v, w=w, c=c, vc=vc)


def kinetic_energy(tree: ArticulatedTree, q, u):
    k = forward_kinematics(tree, q, u)
    I_w = jnp.einsum("nij,njk,nlk->nil", k.R, tree.inertia, k.R)
    t_lin = 0.5 * jnp.sum(tree.mass * jnp.sum(k.vc * k.vc, axis=-1))
    t_rot = 0.5 * jnp.sum(jnp.einsum("ni,nij,nj->n", k.w, I_w, k.w))
    return t_lin + t_rot


def potential_energy(tree: ArticulatedTree, q, gravity):
    k = forward_kinematics(tree, q, jnp.zeros_like(q))
    g = jnp.asarray(gravity, dtype=q.dtype)
    return -jnp.sum(tree.mass * (k.c @ g))


def mass_matrix(tree: ArticulatedTree, q):
    """M(q) = d^2 T / du^2 — exact (T quadratic in u)."""
    n = tree.n_links
    zero_u = jnp.zeros(n, dtype=q.dtype)
    return jax.hessian(lambda uu: kinetic_energy(tree, q, uu))(zero_u)


def forward_dynamics(tree: ArticulatedTree, q, u, tau, gravity,
                     prescribed_udot=None, free_idx=None, pres_idx=None):
    """Joint accelerations from the Euler-Lagrange equation.

    With G(q,u) := dT/du:  M udot = tau - (dG/dq) u + dT/dq - dV/dq.
    If ``pres_idx``/``free_idx`` partition the DOFs (static index arrays)
    and ``prescribed_udot`` carries the prescribed accelerations, only the
    free block is solved: M_ff udot_f = rhs_f - M_fp udot_p."""
    T = lambda qq, uu: kinetic_energy(tree, qq, uu)
    M = jax.hessian(lambda uu: T(q, uu))(u)
    dG_dq = jax.jacobian(lambda qq: jax.grad(lambda uu: T(qq, uu))(u))(q)
    dT_dq = jax.grad(lambda qq: T(qq, u))(q)
    dV_dq = jax.grad(lambda qq: potential_energy(tree, qq, gravity))(q)
    rhs = tau - dG_dq @ u + dT_dq - dV_dq
    if pres_idx is None or len(pres_idx) == 0:
        return jnp.linalg.solve(M, rhs)
    if len(free_idx) == 0:
        return prescribed_udot
    M_ff = M[np.ix_(free_idx, free_idx)]
    M_fp = M[np.ix_(free_idx, pres_idx)]
    rhs_f = rhs[free_idx] - M_fp @ prescribed_udot[pres_idx]
    udot_f = jnp.linalg.solve(M_ff, rhs_f)
    udot = jnp.zeros_like(u).at[np.asarray(free_idx)].set(udot_f)
    return udot + prescribed_udot * _one_hot_mask(len(u), pres_idx, u.dtype)


def _one_hot_mask(n, idx, dtype):
    m = np.zeros(n, dtype=bool)
    m[np.asarray(idx, int)] = True
    return jnp.asarray(m, dtype=dtype)


def planar_tree(mass: float, inertia_zz: float, origin_w,
                dtype=jnp.float32) -> ArticulatedTree:
    """A single rigid body on a Planar mobilizer
    (SimTK::MobilizedBody::Planar, tethered_dead_fish_in_flow.cpp:370):
    massless x/y sliders then a pin about z.  q = (dx, dy, theta)
    relative to the world station ``origin_w`` (the body frame's origin
    at q = 0); put the body's COM at its frame origin."""
    zeros3 = jnp.zeros((3,), dtype)
    eye_eps = jnp.zeros((3, 3), dtype)
    izz = jnp.asarray([[0.0, 0, 0], [0, 0.0, 0], [0, 0, inertia_zz]], dtype)
    return ArticulatedTree(
        parent=np.asarray([-1, 0, 1]),
        axis=jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], dtype),
        r_parent=jnp.stack([jnp.asarray(origin_w, dtype), zeros3, zeros3]),
        r_child=jnp.stack([zeros3, zeros3, zeros3]),
        mass=jnp.asarray([0.0, 0.0, mass], dtype),
        inertia=jnp.stack([eye_eps, eye_eps, izz]),
        com=jnp.stack([zeros3, zeros3, zeros3]),
        joint_type=("slider", "slider", "pin"))


# ---------------------------------------------------------------------------
# Prescribed motions (SimTK::Motion::Custom analog)
# ---------------------------------------------------------------------------

def sinusoid_motion(amplitude: float, t0: float, rate: float, phase: float
                    ) -> Callable:
    """q(t) = A sin(rate t + phase), quintic-smoothstep-ramped over [0, t0]
    (UdfMotion.h:20-31).  Rates/accelerations are autodiff'd — the
    reference's hand-derived Dot/DotDot methods have no analog here."""
    def q_of_t(t):
        s = jnp.sin(rate * t + phase) * amplitude
        x = jnp.clip(t / t0, 0.0, 1.0)
        ramp = x ** 3 * (10.0 - 15.0 * x + 6.0 * x * x)
        return s * ramp
    return q_of_t


class MotionSet(NamedTuple):
    """Static per-joint prescribed-motion table."""
    fns: tuple                 # len n; None = free DOF
    pres_idx: np.ndarray       # indices with a motion
    free_idx: np.ndarray       # the rest

    @classmethod
    def build(cls, fns: Sequence[Optional[Callable]]) -> "MotionSet":
        pres = np.asarray([i for i, f in enumerate(fns) if f is not None], int)
        free = np.asarray([i for i, f in enumerate(fns) if f is None], int)
        return cls(fns=tuple(fns), pres_idx=pres, free_idx=free)

    def q_u_udot(self, t, dtype):
        """Prescribed (q, u, udot) rows at time t (zeros on free DOFs)."""
        n = len(self.fns)
        q = [jnp.zeros((), dtype)] * n
        u = [jnp.zeros((), dtype)] * n
        a = [jnp.zeros((), dtype)] * n
        tt = jnp.asarray(t, dtype)
        for i, fn in enumerate(self.fns):
            if fn is None:
                continue
            q[i] = fn(tt)
            u[i] = jax.grad(fn)(tt)
            a[i] = jax.grad(jax.grad(fn))(tt)
        return jnp.stack(q), jnp.stack(u), jnp.stack(a)


def make_articulated_step(tree: ArticulatedTree, gravity,
                          motions: Optional[MotionSet] = None,
                          joint_damping: float = 0.0):
    """RK4 step of (q, u) — (t, q, u, dt, tau) -> (q, u).

    The RungeKuttaMerson TimeStepper analog (play_simbody.cpp:60-61);
    fixed-step RK4 keeps the trace static.  Prescribed DOFs are overwritten
    from their motion functions at every stage, so they are exact (not
    integrated)."""
    def deriv(t, q, u, tau):
        tau_eff = tau - joint_damping * u
        if motions is None:
            udot = forward_dynamics(tree, q, u, tau_eff, gravity)
        else:
            qp, up, ap = motions.q_u_udot(t, q.dtype)
            mask = _one_hot_mask(len(q), motions.pres_idx, q.dtype)
            q = q * (1 - mask) + qp * mask
            u = u * (1 - mask) + up * mask
            udot = forward_dynamics(tree, q, u, tau_eff, gravity,
                                    prescribed_udot=ap,
                                    free_idx=motions.free_idx,
                                    pres_idx=motions.pres_idx)
        return u, udot

    def step(t, q, u, dt, tau):
        k1q, k1u = deriv(t, q, u, tau)
        k2q, k2u = deriv(t + 0.5 * dt, q + 0.5 * dt * k1q, u + 0.5 * dt * k1u, tau)
        k3q, k3u = deriv(t + 0.5 * dt, q + 0.5 * dt * k2q, u + 0.5 * dt * k2u, tau)
        k4q, k4u = deriv(t + dt, q + dt * k3q, u + dt * k3u, tau)
        q = q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q)
        u = u + dt / 6.0 * (k1u + 2 * k2u + 2 * k3u + k4u)
        if motions is not None:
            qp, up, _ = motions.q_u_udot(t + dt, q.dtype)
            mask = _one_hot_mask(len(q), motions.pres_idx, q.dtype)
            q = q * (1 - mask) + qp * mask
            u = u * (1 - mask) + up * mask
        return q, u

    return step


# ---------------------------------------------------------------------------
# SPH coupling
# ---------------------------------------------------------------------------

def generalized_forces(tree: ArticulatedTree, q, forces_w, torques_w):
    """Map per-link world forces (at the COM) + torques to joint torques,
    tau = sum_i Jv_i^T F_i + Jw_i^T T_i, with BOTH Jacobians by autodiff:
    Jv from the COM positions, Jw from dR/dq via unskew((dR/dq_k) R^T)."""
    def coms(qq):
        return forward_kinematics(tree, qq, jnp.zeros_like(qq)).c
    Jv = jax.jacobian(coms)(q)                         # (n, 3, ndof)
    tau = jnp.einsum("nik,ni->k", Jv, forces_w)

    def rots(qq):
        return forward_kinematics(tree, qq, jnp.zeros_like(qq)).R
    R = rots(q)
    dR = jax.jacobian(rots)(q)                         # (n, 3, 3, ndof)
    W = jnp.einsum("nijk,nlj->nilk", dR, R)            # skew(Jw col k)
    Jw = jnp.stack([W[:, 2, 1, :], W[:, 0, 2, :], W[:, 1, 0, :]], axis=1)
    return tau + jnp.einsum("nik,ni->k", Jw, torques_w)


def constrain_by_link(state: dict, mask, kin: LinkKinematics, link: int,
                      initial_station) -> dict:
    """Impose link ``link``'s rigid motion on a particle set whose
    body-frame stations are ``initial_station`` (n_particles, 3):
    x = p + R s, v = v_origin + w x (R s)."""
    out = dict(state)
    R, p = kin.R[link], kin.p[link]
    s_w = initial_station @ R.T
    new_pos = p + s_w
    new_vel = kin.v[link] + jnp.cross(kin.w[link], s_w)
    m = mask[:, None]
    out["Position"] = jnp.where(m, new_pos, state["Position"])
    out["Velocity"] = jnp.where(m, new_vel, state["Velocity"])
    if "AverageVelocity" in state:
        out["AverageVelocity"] = jnp.where(m, new_vel, state["AverageVelocity"])
    return out


# ---------------------------------------------------------------------------
# State engine (SimbodyStateEngine analog, state_engine.h:55)
# ---------------------------------------------------------------------------

def write_state_xml(output_dir: str, step: int, t, q, u) -> str:
    """Step-indexed XML snapshot of the multibody state
    (SimbodyStateEngine::writeStateToXml analog)."""
    os.makedirs(output_dir, exist_ok=True)
    root = ET.Element("MultibodyState")
    root.set("step", str(int(step)))
    root.set("time", repr(float(t)))
    root.set("q", " ".join(repr(float(x)) for x in np.asarray(q)))
    root.set("u", " ".join(repr(float(x)) for x in np.asarray(u)))
    path = os.path.join(output_dir, f"multibody_state_{int(step):06d}.xml")
    ET.ElementTree(root).write(path)
    return path


def read_state_xml(output_dir: str, step: int):
    """(t, q, u) from a step snapshot (readStateFromXml analog)."""
    path = os.path.join(output_dir, f"multibody_state_{int(step):06d}.xml")
    root = ET.parse(path).getroot()
    t = float(root.get("time"))
    q = np.asarray([float(x) for x in root.get("q").split()])
    u = np.asarray([float(x) for x in root.get("u").split()])
    return t, q, u
