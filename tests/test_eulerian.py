"""Eulerian WCSPH tests: acoustic pulse propagation in a periodic box."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import eulerian as eu
from sphinxsys_jax.physics import riemann as rs


def setup(dx=0.01, L=1.0, c0=10.0):
    shape = G.Box(G.Transform(translation=(L / 2, L / 2)), halfsize=(L / 2, L / 2))
    pos, vol = generate_lattice(shape, (0, 0), (L, L), dx)
    ad = SPHAdaptation(spacing=dx, dim=2)
    eos = WeaklyCompressibleFluid(rho0=1.0, c0=c0)
    state = eu.make_eulerian_state(pos, vol, eos, dtype=jnp.float32)
    grid = grid_from_bounds((0, 0), (L, L), ad.cutoff, periodic=(True, True))
    n = len(pos)
    table = build_cell_table(state["Position"], jnp.int32(n), grid, cap=32)
    nl = build_neighbor_list(state["Position"], jnp.int32(n), state["Position"],
                             jnp.int32(n), table, grid, ad.cutoff, k_max=48,
                             include_self=False)
    return state, nl, ad, eos, grid


def test_acoustic_pulse_speed_and_mass_conservation():
    """A small gaussian density pulse splits and travels at c0 in the
    STATIC Eulerian frame; total mass is conserved by the flux form."""
    c0 = 10.0
    state, nl, ad, eos, grid = setup(dx=0.02, c0=c0)
    pos = np.asarray(state["Position"])
    amp = 1e-3
    rho0 = 1.0 + amp * np.exp(-((pos[:, 0] - 0.5) ** 2) / (2 * 0.05**2))
    state = dict(state)
    state["Density"] = jnp.asarray(rho0, jnp.float32)
    state["Mass"] = state["Density"] * state["VolumetricMeasure"]
    state["Pressure"] = eos.pressure(state["Density"])
    riemann = rs.acoustic_riemann(eos)
    box = grid.periodic_lengths

    @jax.jit
    def run(s, n_steps, dt):
        def body(_, ss):
            ss = eu.eulerian_integration_1st_half(ss, nl, ad.kernel, 2,
                                                  riemann, dt, box=box)
            ss = eu.eulerian_integration_2nd_half(ss, nl, ad.kernel, 2,
                                                  riemann, eos, dt, box=box)
            return ss
        return jax.lax.fori_loop(0, n_steps, body, s)

    mass0 = float(jnp.sum(state["Mass"]))
    dt = float(eu.eulerian_time_step(state, eos, ad.h))
    T = 0.02  # pulse travels c0*T = 0.2
    n_steps = int(T / dt)
    out = run(state, n_steps, dt)
    t_end = n_steps * dt

    # particles don't move (Eulerian)
    np.testing.assert_array_equal(np.asarray(out["Position"]), pos)
    # mass conservation
    mass1 = float(jnp.sum(out["Mass"]))
    np.testing.assert_allclose(mass1, mass0, rtol=1e-6)
    # the pulse splits into two fronts at x = 0.5 +- c0 t
    drho = np.asarray(out["Density"]) - 1.0
    mid_band = np.abs(pos[:, 1] - 0.5) < 0.05
    x = pos[mid_band, 0]
    d = drho[mid_band]
    x_right = x[np.argmax(np.where(x > 0.5, d, -1))]
    expected = 0.5 + c0 * t_end
    assert abs(x_right - expected) < 0.05, (x_right, expected)
    assert np.isfinite(d).all()


def test_still_state_stays_still():
    state, nl, ad, eos, grid = setup(dx=0.05)
    state = dict(state)
    state["Pressure"] = eos.pressure(state["Density"])
    riemann = rs.acoustic_riemann(eos)
    dt = float(eu.eulerian_time_step(state, eos, ad.h))
    s = state
    for _ in range(10):
        s = eu.eulerian_integration_1st_half(s, nl, ad.kernel, 2, riemann, dt,
                                             box=grid.periodic_lengths)
        s = eu.eulerian_integration_2nd_half(s, nl, ad.kernel, 2, riemann, eos,
                                             dt, box=grid.periodic_lengths)
    v = np.asarray(s["Velocity"])
    assert np.abs(v).max() < 1e-6
