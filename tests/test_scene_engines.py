"""One scene, every engine: the generic block-engine runner
(engine/scene.py) must reproduce the gather engine on every bound case —
parity over the scene registry, so no case needs a hand-written block
twin.  Tiny resolutions keep this in the quick tier: it is the block
engine's only coverage there."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.engine import scene as sc

# registry: (case module name, build kwargs, t_end, block knobs, tolerance)
SCENES = [
    ("dambreak_2d", dict(dx=0.1), 0.30, dict(cap=16), 2e-3),
    ("dambreak_3d", dict(dx=0.2), 0.20, dict(cap=48), 2e-3),
    ("taylor_green_2d", dict(dx=0.05), 0.05, dict(), 2e-3),
]


@pytest.mark.parametrize("name,build_kw,t_end,block_kw,tol",
                         SCENES, ids=[s[0] for s in SCENES])
def test_block_engine_matches_gather(name, build_kw, t_end, block_kw, tol):
    mod = importlib.import_module(f"sphinxsys_jax.cases.{name}")

    case, fluid = mod.build_case(**build_kw)
    s_g = mod.init_sim(case, fluid)
    run_g = mod.make_run_chunk(case)
    s_g = run_g(s_g, jnp.asarray(t_end, s_g.time.dtype))
    assert not bool(s_g.overflow)

    scene, fluid_b = mod.build_block_case(**build_kw, **block_kw)
    s_b = sc.init_sim(scene, fluid_b)
    run_b = sc.make_run_chunk(scene)
    s_b = run_b(s_b, jnp.asarray(t_end, s_b.time.dtype))
    assert not bool(s_b.overflow)

    # identical dual-criteria loop -> identical step counts
    assert int(s_g.n_adv) == int(s_b.n_adv)
    assert int(s_g.n_ac) == int(s_b.n_ac)

    parts = sc.blocks_to_particles(scene, s_b)
    n = scene.n_fluid
    pos_g = np.asarray(s_g.fluid["Position"])[:n]
    pos_b = np.asarray(parts["Position"])[:n]
    d = pos_g - pos_b
    if scene.wrap:
        L = np.asarray(scene.grid.periodic_lengths)
        d -= np.round(d / L) * L
    scale = float(np.abs(pos_g).max())
    assert np.abs(d).max() < tol * scale, np.abs(d).max()
