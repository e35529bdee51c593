"""Open-boundary emitter/disposer tests (fluid_boundary.h analog)."""

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.state import make_fluid_state, FAR_AWAY
from sphinxsys_jax.physics import boundary as bd


def make_channel_state():
    """10 particles moving +x, capacity 16 (6 reserve).  Particles 0-1 sit
    in the emitter region [0, 0.2]; the rest are well downstream (> 0.35,
    outside the emitter crossing band)."""
    xs = np.concatenate([[0.05, 0.15], np.linspace(0.4, 0.95, 8)])
    pos = np.stack([xs, np.full(10, 0.5)], -1)
    state = dict(make_fluid_state(pos, 0.01, 1.0, capacity=16))
    state["Velocity"] = jnp.zeros((16, 2)).at[:, 0].set(1.0)
    return bd.ensure_alive_mask(state)


def test_disposer_deletes_outflow():
    state = make_channel_state()
    region = bd.AlignedBoxRegion(lower=(0.9, 0.0), upper=(2.0, 1.0))
    out = bd.disposer_outflow_deletion(state, region)
    alive = np.asarray(out["Alive"])
    assert alive.sum() == 9  # the particle at x=0.95 removed
    pos = np.asarray(out["Position"])
    assert (pos[~alive[: 16]] > 1e9).all() or (~alive).sum() == 7


def test_emitter_recycles_and_clones():
    state = make_channel_state()
    # move two particles past the emitter plane at x = 0.2
    state["Position"] = state["Position"].at[0, 0].set(0.25).at[1, 0].set(0.22)
    emitter = bd.AlignedBoxRegion(lower=(0.0, 0.0), upper=(0.2, 1.0))
    out = bd.emitter_inflow_injection(state, emitter)
    alive = np.asarray(out["Alive"])
    assert alive.sum() == 12  # two clones activated
    pos = np.asarray(out["Position"])
    # originals wrapped back by the emitter length 0.2
    np.testing.assert_allclose(pos[0, 0], 0.05, atol=1e-6)
    np.testing.assert_allclose(pos[1, 0], 0.02, atol=1e-6)
    # clones carry the pre-wrap (downstream) positions
    clone_x = np.sort(pos[10:12, 0])
    np.testing.assert_allclose(clone_x, [0.22, 0.25], atol=1e-6)
    assert not bool(out["_InjectionOverflow"])


def test_emitter_overflow_detected():
    state = make_channel_state()
    # exhaust the reserve: only 6 dead slots, 8 particles in the band
    state["Position"] = state["Position"].at[:, 0].set(0.25)
    emitter = bd.AlignedBoxRegion(lower=(0.0, 0.0), upper=(0.2, 1.0))
    out = bd.emitter_inflow_injection(state, emitter)
    assert bool(out["_InjectionOverflow"])


def test_injection_is_jittable():
    state = make_channel_state()
    emitter = bd.AlignedBoxRegion(lower=(0.0, 0.0), upper=(0.2, 1.0))
    region = bd.AlignedBoxRegion(lower=(0.9, 0.0), upper=(2.0, 1.0))

    @jax.jit
    def step(s):
        s = bd.emitter_inflow_injection(s, emitter)
        s = bd.disposer_outflow_deletion(s, region)
        return s

    out = step(state)
    assert np.asarray(out["Alive"]).dtype == bool


def test_masked_neighbor_search_with_alive():
    """Neighbor engines accept the Alive mask directly."""
    from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list

    state = make_channel_state()
    state["Alive"] = state["Alive"].at[3].set(False)
    grid = grid_from_bounds((0, 0), (1, 1), 0.3)
    table = build_cell_table(state["Position"], state["Alive"], grid, cap=16)
    nl = build_neighbor_list(state["Position"], state["Alive"],
                             state["Position"], state["Alive"], table, grid,
                             0.3, k_max=16, include_self=False)
    idx = np.asarray(nl.idx)
    assert (idx[idx < 16] != 3).all()  # dead particle never appears
    assert int(nl.count[3]) == 0
