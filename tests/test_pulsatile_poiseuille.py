"""Pulsatile (Womersley) Poiseuille flow driven purely by pressure
boundaries (cases/pulsatile_poiseuille_2d.py = reference
test_2d_pulsatile_poiseuille_flow): the pressure-condition compensation
velocity + bidirectional buffers must reproduce the EXACT start-from-rest
oscillatory-channel solution."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import pulsatile_poiseuille_2d as pp


def test_womersley_startup_consistency():
    """The eigenmode startup series must converge to the plain Womersley
    solution once the transient decays (t >> R^2/nu)."""
    case, _ = pp.build_case(n_across=6)
    y = np.linspace(-0.4, 0.4, 9) * case.dh
    nu = case.mu / case.rho0
    t_late = 8.0 * (0.5 * case.dh) ** 2 / nu
    u_exact = pp.womersley_velocity(case, y, t_late)
    u_series = pp.womersley_startup_velocity(case, y, t_late)
    assert np.abs(u_series - u_exact).max() < 1e-3 * max(case.u_ref, 1e-12)


@pytest.mark.slow
def test_centerline_tracks_womersley_startup():
    """Run the pressure-driven channel from rest through the early startup
    transient and compare the centerline velocity with the exact
    eigenmode solution (no free parameters)."""
    case, fluid = pp.build_case(n_across=12)
    s = pp.init_sim(case, fluid)
    run = pp.make_run_chunk(case)

    nu = case.mu / case.rho0
    t_visc = (0.5 * case.dh) ** 2 / nu          # viscous startup scale
    checks = []
    for frac in (0.1, 0.2):
        t = frac * t_visc
        s = run(s, jnp.asarray(t, s.time.dtype))
        assert not bool(s.overflow)
        u_sim = pp.centerline_velocity(case, s)
        u_ref = float(pp.womersley_startup_velocity(case, 0.0, float(s.time)))
        checks.append((float(s.time), u_sim, u_ref))

    # the startup flow is strongly accelerating: demand the simulated
    # centerline stays within 15% of the analytic startup solution
    for t, u_sim, u_ref in checks:
        assert abs(u_sim - u_ref) < 0.15 * abs(u_ref) + 0.02 * case.u_ref, \
            (t, u_sim, u_ref)
    # and that the flow actually developed (not a no-op)
    assert checks[-1][1] > 0.2 * case.u_ref


def test_conveyor_exact_count_conservation():
    """Pure-advection conveyor: uniform rightward then leftward transport
    through both buffers must conserve the alive count EXACTLY (regression
    for the stale-prev_pos double-clone bug: a fresh clone's slot carried
    a FAR prev position that satisfied the other buffer's one-sided
    crossing predicate)."""
    from sphinxsys_jax.physics import boundary as bdy

    dx, dl, dh = 1.0, 40.0, 4.0
    xs = np.arange(dx / 2, dl, dx)
    ys = np.arange(dx / 2, dh, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n0 = len(pos)
    cap = int(1.6 * n0)
    state = {"Position": jnp.asarray(
                 np.concatenate([pos, np.full((cap - n0, 2), 1e9)])),
             "Velocity": jnp.zeros((cap, 2)),
             "Alive": jnp.arange(cap) < n0,
             "_InjectionOverflow": jnp.zeros((), bool)}
    buf_l = bdy.AlignedBoxRegion(lower=(0.0, 0.0), upper=(5 * dx, dh))
    buf_r = bdy.AlignedBoxRegion(lower=(dl - 5 * dx, 0.0), upper=(dl, dh))
    for u in (0.37 * dx, -0.37 * dx):
        for _ in range(60):
            prev = state["Position"]
            state = dict(state)
            state["Position"] = state["Position"].at[:, 0].add(
                jnp.where(state["Alive"], u, 0.0))
            state = bdy.bidirectional_buffer_exchange(state, buf_l,
                                                      inward=+1, prev_pos=prev)
            state = bdy.bidirectional_buffer_exchange(state, buf_r,
                                                      inward=-1, prev_pos=prev)
        assert int(np.asarray(state["Alive"]).sum()) == n0
        assert not bool(np.asarray(state["_InjectionOverflow"]))


@pytest.mark.slow
def test_particle_count_conserved_through_buffers():
    """Bidirectional buffers must keep the alive population near the
    initial fill (injection replenishes deletions)."""
    case, fluid = pp.build_case(n_across=10)
    s = pp.init_sim(case, fluid)
    n0 = pp.n_alive(s)
    run = pp.make_run_chunk(case)
    nu = case.mu / case.rho0
    s = run(s, jnp.asarray(0.15 * (0.5 * case.dh) ** 2 / nu, s.time.dtype))
    assert not bool(s.overflow)
    n1 = pp.n_alive(s)
    # a mild transient dilation near the inlet is expected while the
    # startup flow accelerates (measured ~6.5% at 0.15 t_visc)
    assert abs(n1 - n0) < 0.08 * n0
