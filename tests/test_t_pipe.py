"""T-shaped pipe (test_2d_T_shaped_pipe): multi-outlet open boundary.
The reference DB's TotalKineticEnergy plateaus at 18.2-18.4; ours reaches
the same plateau within 2% with balanced injection/deletion."""

import jax.numpy as jnp
import pytest

from sphinxsys_jax.cases import t_pipe_2d as tp

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_t_pipe_steady_split_and_energy_plateau():
    case, fluid = tp.build_case()
    n0 = tp.n_alive(tp.init_sim(case, fluid))
    s = tp.init_sim(case, fluid)
    run = tp.make_run_chunk(case)

    s = run(s, jnp.asarray(15.0, s.time.dtype))
    assert not bool(s.overflow)

    # steady KE plateau (reference DB tail: 18.16-18.40)
    ke = tp.kinetic_energy(s)
    assert ke == pytest.approx(18.28, rel=0.06), ke

    # imposed parabolic inflow peak 1.5 U
    alive = s.fluid["Alive"]
    vel = s.fluid["Velocity"]
    vmax = float(jnp.max(jnp.where(alive, jnp.linalg.norm(vel, axis=1), 0.0)))
    assert 1.35 < vmax < 1.75, vmax

    # mass balance: emitter feed matches the two outlets' deletion
    assert abs(tp.n_alive(s) - n0) < 0.1 * n0

    # the flow splits: upward flux in the top branch, downward in the bottom
    pos = s.fluid["Position"]
    up = alive & (pos[:, 1] > tp.DH + 1.0)
    down = alive & (pos[:, 1] < -1.0)
    vy_up = float(jnp.sum(jnp.where(up, vel[:, 1], 0.0)) / jnp.sum(up))
    vy_down = float(jnp.sum(jnp.where(down, vel[:, 1], 0.0)) / jnp.sum(down))
    assert vy_up > 0.05, vy_up
    assert vy_down < -0.05, vy_down
