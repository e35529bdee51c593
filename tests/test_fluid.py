"""WCSPH fluid-op physics tests."""

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import make_fluid_state
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import general as gd


def periodic_free_fluid(dx=0.05, L=1.0):
    """A block of fluid filling a box (no walls) at rest."""
    shape = G.Box(G.Transform(translation=(L / 2, L / 2)), halfsize=(L / 2, L / 2))
    pos, vol = generate_lattice(shape, (0, 0), (L, L), dx)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    eos = WeaklyCompressibleFluid(rho0=1.0, c0=10.0)
    fluid = make_fluid_state(pos, vol, 1.0, dtype=jnp.float32)
    grid = grid_from_bounds((0, 0), (L, L), adaptation.cutoff)
    table = build_cell_table(fluid["Position"], fluid["NReal"], grid, cap=32)
    nl = build_neighbor_list(fluid["Position"], fluid["NReal"], fluid["Position"],
                             fluid["NReal"], table, grid, adaptation.cutoff,
                             k_max=48, include_self=False)
    return fluid, nl, adaptation, eos, grid


def test_density_summation_interior_is_rho0():
    """Interior particles of a uniform lattice must see rho_sum == rho0
    (sigma == sigma0 by construction)."""
    fluid, nl, adaptation, eos, _ = periodic_free_fluid()
    out = fd.density_summation(fluid, nl, adaptation.kernel, 2, 1.0,
                               adaptation.sigma0, free_surface=False)
    pos = np.asarray(fluid["Position"])
    c = adaptation.cutoff
    interior = ((pos > c).all(axis=1)) & ((pos < 1.0 - c).all(axis=1))
    rho = np.asarray(out["Density"])[interior]
    np.testing.assert_allclose(rho, 1.0, atol=2e-3)


def test_pressure_force_conserves_momentum():
    """Total inner pressure force must vanish (pairwise antisymmetry)."""
    fluid, nl, adaptation, eos, _ = periodic_free_fluid()
    # random pressure field
    rng = np.random.default_rng(0)
    n = fluid["Position"].shape[0]
    p = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    drho = eos.density_from_pressure(p) - fluid["Density"]
    fluid = dict(fluid)
    fluid["DensityChangeRate"] = jnp.zeros_like(p)
    fluid["Density"] = eos.density_from_pressure(p)
    riemann = rs.no_riemann(eos)
    out = fd.acoustic_step_1st_half(fluid, nl, adaptation.kernel, 2, eos,
                                    riemann, 0.0)
    total_force = np.asarray(jnp.sum(out["Force"], axis=0))
    scale = float(jnp.max(jnp.linalg.norm(out["Force"], axis=-1)))
    np.testing.assert_allclose(total_force / (scale + 1e-12), 0.0, atol=1e-4)


def test_acoustic_wave_preserves_stillness():
    """Uniform still fluid stays still under both half steps."""
    fluid, nl, adaptation, eos, _ = periodic_free_fluid()
    riemann = rs.acoustic_riemann(eos)
    f = fd.density_summation(fluid, nl, adaptation.kernel, 2, 1.0,
                             adaptation.sigma0, free_surface=False)
    dt = 1e-3
    f1 = fd.acoustic_step_1st_half(f, nl, adaptation.kernel, 2, eos, riemann, dt)
    f2 = fd.acoustic_step_2nd_half(f1, nl, adaptation.kernel, 2, riemann, dt)
    # interior velocities stay ~0 (edges see truncated kernels -> surface
    # forces).  fp32 floor: rho noise ~1e-7 amplified by c0^2 in the EoS
    # gives |dv| ~ 3e-4; assert we stay at that floor.
    pos = np.asarray(fluid["Position"])
    c = adaptation.cutoff
    interior = ((pos > c).all(axis=1)) & ((pos < 1.0 - c).all(axis=1))
    v = np.asarray(f2["Velocity"])[interior]
    assert np.abs(v).max() < 1e-3


def test_time_steps_match_reference_formulas():
    fluid, nl, adaptation, eos, _ = periodic_free_fluid()
    h = adaptation.h
    dt_ac = float(fd.acoustic_time_step(fluid, eos, h))
    # still fluid: dt = 0.6 h / c0
    np.testing.assert_allclose(dt_ac, 0.6 * h / 10.0, rtol=1e-5)
    dt_adv = float(fd.advection_time_step(fluid, h, speed_ref=2.0))
    np.testing.assert_allclose(dt_adv, 0.25 * h / 2.0, rtol=1e-5)


def test_riemann_solver_values():
    """Acoustic Riemann dissipation terms vs riemann_solver.h closed forms."""
    eos = WeaklyCompressibleFluid(rho0=2.0, c0=5.0)
    r = rs.acoustic_riemann(eos)
    rho0c0 = 10.0
    # same fluid both sides: geo average = rho0c0, inv ave = 1/rho0c0
    u_jump = 0.1
    expected = rho0c0 * u_jump * min(3.0 * (1.0 / 5.0) * u_jump, 1.0)
    got = float(r.dissipative_p_jump(jnp.asarray(u_jump)))
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    # negative u_jump -> limiter uses max(u,0) = 0 -> no dissipation
    assert float(r.dissipative_p_jump(jnp.asarray(-0.1))) == 0.0
    got_u = float(r.dissipative_u_jump(jnp.asarray(0.5)))
    np.testing.assert_allclose(got_u, 0.5 / rho0c0, rtol=1e-6)


def test_viscous_force_opposes_shear():
    fluid, nl, adaptation, eos, _ = periodic_free_fluid()
    f = dict(fluid)
    pos = f["Position"]
    # linear shear: vx = y
    f["Velocity"] = jnp.stack([pos[:, 1], jnp.zeros_like(pos[:, 0])], axis=-1)
    out = fd.viscous_force(f, nl, adaptation.kernel, 2, mu=0.1,
                           smoothing_length=adaptation.h)
    # total viscous force ~ 0 (momentum conserving)
    total = np.asarray(jnp.sum(out["ViscousForce"], axis=0))
    scale = float(jnp.max(jnp.linalg.norm(out["ViscousForce"], axis=-1)))
    np.testing.assert_allclose(total / (scale + 1e-12), 0.0, atol=1e-3)


def test_gravity_and_energy():
    fluid, nl, adaptation, eos, _ = periodic_free_fluid()
    g = gd.Gravity(acceleration=(0.0, -2.0))
    out = gd.gravity_force(fluid, g)
    fp = np.asarray(out["ForcePrior"])
    m = np.asarray(fluid["Mass"])
    np.testing.assert_allclose(fp[:, 1], -2.0 * m, rtol=1e-6)
    e = float(gd.total_mechanical_energy(out, g))
    # potential = g * y (positive above reference), all at rest
    pos = np.asarray(fluid["Position"])
    np.testing.assert_allclose(e, float((m * 2.0 * pos[:, 1]).sum()), rtol=1e-5)
