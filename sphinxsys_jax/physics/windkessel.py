"""Windkessel (3-element RCR) outlet boundary condition.

Counterpart of /root/reference/tests/extra_source_and_tests/extra_src/
shared/pressure_boundary/windkessel_bc.h (TargetOutletPressureWindkessel):
the outlet pressure follows the lumped-parameter ODE

    dp/dt = -p/(C Rd) + (Rp + Rd) Q/(C Rd) + Rp dQ/dt

advanced by the same Heun (predictor-corrector) step, with the flow rate
Q measured through an outlet buffer region.  The resulting pressure is
imposed on the buffer particles (PressureCondition), closing the 0D-3D
coupling used by the aortic/carotid flow cases.

All pure jnp: the windkessel state is a small NamedTuple carried through
the jitted loop next to the fluid state.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphinxsys_jax.core.state import State, valid_mask

TINY = 1.0e-15


class WindkesselState(NamedTuple):
    p: jnp.ndarray        # current outlet pressure p_n
    q: jnp.ndarray        # current flow rate Q_n
    flow_acc: jnp.ndarray  # accumulated flow volume since last update


def init_windkessel(p0: float = 0.0, dtype=jnp.float32) -> WindkesselState:
    z = jnp.zeros((), dtype)
    return WindkesselState(p=jnp.asarray(p0, dtype), q=z, flow_acc=z)


def accumulate_flow(wk: WindkesselState, fluid: State, region,
                    axis: int, dt) -> WindkesselState:
    """Accumulate the volume flux of buffer particles through the region
    (the reference integrates particle crossings; the volumetric flux
    integral sum(v_axis * Vol)/L_axis * dt is its smooth equivalent)."""
    inside = region.contains(fluid["Position"]) & valid_mask(fluid)
    length = region.upper[axis] - region.lower[axis]
    flux = jnp.sum(jnp.where(inside,
                             fluid["Velocity"][:, axis]
                             * fluid["VolumetricMeasure"], 0.0)) / length
    return wk._replace(flow_acc=wk.flow_acc + flux * dt)


def windkessel_update(wk: WindkesselState, dt, Rp: float, C: float,
                      Rd: float) -> WindkesselState:
    """Heun step of the RCR ODE (windkessel_bc.h updateNextPressure):
    Q_n = accumulated flow / dt; dQ/dt = (Q_n - Q_0)/dt."""
    q_n = wk.flow_acc / (dt + TINY)
    dq_dt = (q_n - wk.q) / (dt + TINY)

    def rate(p):
        return -p / (C * Rd) + (Rp + Rd) * q_n / (C * Rd) + Rp * dq_dt

    dp = rate(wk.p)
    p_star = wk.p + dp * dt
    p_new = wk.p + 0.5 * dt * (dp + rate(p_star))
    return WindkesselState(p=p_new, q=q_n,
                           flow_acc=jnp.zeros_like(wk.flow_acc))


def impose_pressure_condition(fluid: State, region, p_target, eos) -> State:
    """PressureCondition: buffer particles take the windkessel pressure and
    the consistent EoS density."""
    out = dict(fluid)
    inside = region.contains(fluid["Position"]) & valid_mask(fluid)
    p = jnp.where(inside, p_target, fluid["Pressure"])
    out["Pressure"] = p
    out["Density"] = jnp.where(inside, eos.density_from_pressure(p_target),
                               fluid["Density"])
    return out


def kernel_gradient_sum(fluid: State, nl_inner, kernel, dim: int,
                        contacts=(), box=None):
    """KernelSummation of the pressure-boundary cases: S_i = sum_j
    gradW_ij V_j over inner + contact relations — ~0 in the bulk,
    pointing INTO the domain where the kernel support is truncated (the
    open channel ends), i.e. the missing-neighbor gradient."""
    from sphinxsys_jax.physics.pair import gather, pair_geometry

    pos = fluid["Position"]

    def one(pos_s, vol_s, nl):
        pg = pair_geometry(pos, pos_s, nl, kernel, dim, need_W=False,
                           box=box)
        vol_j, _ = gather(vol_s, nl.idx)
        return jnp.sum((pg.dW * vol_j)[..., None] * pg.e, axis=1)

    S = one(pos, fluid["VolumetricMeasure"], nl_inner)
    for c_state, nl_c in contacts:
        S = S + one(c_state["Position"], c_state["VolumetricMeasure"], nl_c)
    return S


def pressure_condition_velocity(fluid: State, region, p_target, dt,
                                kernel_sum, axis: int = 0) -> State:
    """The PressureCondition velocity update (pressure_boundary.h:60-70):
    buffer particles get the truncated-support compensation force
    vel += 2 S_i p_target / rho dt, and their velocity is constrained to
    the buffer's flow axis (transverse components zeroed)."""
    out = dict(fluid)
    inside = region.contains(fluid["Position"]) & valid_mask(fluid)
    vel = fluid["Velocity"]
    vel = vel + jnp.where(inside[:, None],
                          2.0 * kernel_sum * p_target
                          / fluid["Density"][:, None] * dt, 0.0)
    aligned = jnp.zeros_like(vel).at[:, axis].set(vel[:, axis])
    out["Velocity"] = jnp.where(inside[:, None], aligned, vel)
    return out
