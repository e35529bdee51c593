"""Generic block-engine tests (engine/block_fluid.py + engine/scene.py):
the fast path must reproduce the gather engine on viscous + TVC +
periodic + moving-wall FSI cases."""

import pytest

import math

import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def _run_tg_gather(t_end, dx=0.025):
    from sphinxsys_jax.cases import taylor_green_2d as tg

    case, fluid = tg.build_case(dx=dx)
    s = tg.init_sim(case, fluid)
    s = tg.make_run_chunk(case)(s, jnp.asarray(t_end, s.time.dtype))
    return case, s


def _run_tg_block(t_end, dx=0.025, **kw):
    from sphinxsys_jax.cases import taylor_green_2d as tg
    from sphinxsys_jax.engine import scene as sc

    scene, fluid = tg.build_block_case(dx=dx, **kw)
    s = sc.init_sim(scene, fluid)
    s = sc.make_run_chunk(scene)(s, jnp.asarray(t_end, s.time.dtype))
    assert not bool(s.overflow)
    return scene, s, sc.blocks_to_particles(scene, s)


def test_taylor_green_block_matches_gather_engine():
    """Viscous + TVC + doubly-periodic on the block engine == gather engine
    to fp32 roundoff (same math, different summation layout)."""
    case_g, sg = _run_tg_gather(0.02)
    case_b, sb, pb = _run_tg_block(0.02)
    assert int(sg.n_ac) == int(sb.n_ac)
    vg = np.asarray(sg.fluid["Velocity"])
    vb = np.asarray(pb["Velocity"])
    np.testing.assert_allclose(vg, vb, atol=5e-5)
    np.testing.assert_allclose(np.asarray(sg.fluid["Position"]),
                               np.asarray(pb["Position"]), atol=5e-5)


def test_taylor_green_block_decay_tracks_analytic():
    """Physics oracle on the fast path: kinetic energy decays like
    exp(-16 pi^2 nu t) (velocity ~ exp(-8 pi^2 nu t))."""
    from sphinxsys_jax.cases import taylor_green_2d as tg

    t_end = 0.1
    _, s, p = _run_tg_block(t_end, dx=0.025)
    nu = tg.MU_F / tg.RHO0_F
    v = np.asarray(p["Velocity"])
    ke = 0.5 * float(np.sum(np.asarray(p["Mass"]) * np.sum(v * v, axis=1)))
    # initial KE of the lattice-sampled field
    ke0 = 0.25 * tg.RHO0_F * tg.DL * tg.DH  # mean of cos^2*sin^2 sums = 1/2
    expected = ke0 * math.exp(-16.0 * math.pi ** 2 * nu * float(s.time))
    assert abs(ke - expected) / expected < 0.08


def test_fsi2_block_matches_gather_engine():
    """fsi2 (viscous + TVC + x-periodic + moving FSI wall-contact + solid
    sub-cycling) on the generic scene runner == gather engine.  Uses
    float64: the two engines are formulation-identical but sum in
    different orders, and the bluff-body shear flow amplifies fp32
    roundoff chaotically (f64 keeps the gap ~1e-9 where f32 reaches 1e-3
    by t=0.2)."""
    from sphinxsys_jax.cases import fsi2
    from sphinxsys_jax.engine import scene as sc

    t = 0.1
    case_g, fl_g, so_g = fsi2.build_case(dx=0.1, dtype=jnp.float64)
    sg = fsi2.init_sim(case_g, fl_g, so_g)
    sg = fsi2.make_run_chunk(case_g)(sg, jnp.asarray(t, sg.time.dtype))

    scene, fl_b, so_b = fsi2.build_block_case(dx=0.1, dtype=jnp.float64)
    sb = fsi2.init_block_sim(scene, fl_b, so_b)
    sb = sc.make_run_chunk(scene)(sb, jnp.asarray(t, sb.time.dtype))
    assert not bool(sb.overflow)
    assert int(sg.n_ac) == int(sb.n_ac)
    assert int(sg.n_s) == int(sb.aux["n_s"])

    pb = sc.blocks_to_particles(scene, sb)
    np.testing.assert_allclose(np.asarray(sg.fluid["Velocity"]),
                               np.asarray(pb["Velocity"]), atol=1e-8)
    np.testing.assert_allclose(np.asarray(sg.solid["Position"]),
                               np.asarray(sb.aux["solid"]["Position"]),
                               atol=1e-9)


def test_dambreak_3d_block_matches_gather_engine():
    """The dim-generic block engine in 3D (27-window sweeps, cap 48) ==
    the 3D gather engine over several dual-criteria advection steps."""
    import jax
    from sphinxsys_jax.cases import dambreak_3d as db3
    from sphinxsys_jax.engine import scene as sc

    dx = 0.1
    case_g, fluid_g = db3.build_case(dx=dx)
    sg = db3.init_sim(case_g, fluid_g)
    step_g = jax.jit(lambda s: db3._advection_step(case_g, s))

    scene, fluid_b = db3.build_block_case(dx=dx, cap=48)
    sb = sc.init_sim(scene, fluid_b)
    step_b = sc.make_advection_step(scene)

    for _ in range(5):
        sg = step_g(sg)
        sb = step_b(sb)
    assert not bool(sb.overflow)
    assert int(sg.n_ac) == int(sb.n_ac)
    pb = sc.blocks_to_particles(scene, sb)
    np.testing.assert_allclose(np.asarray(sg.fluid["Position"]),
                               np.asarray(pb["Position"]), atol=5e-5)
    np.testing.assert_allclose(np.asarray(sg.fluid["Velocity"]),
                               np.asarray(pb["Velocity"]), atol=5e-4)
