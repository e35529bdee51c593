"""3D dambreak smoke/physics test (dimension-generality of the engine)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import dambreak_3d as db3
from sphinxsys_jax.physics import general as gd


@pytest.fixture(scope="module")
def sim3d():
    case, fluid = db3.build_case(dx=0.125)
    s = db3.init_sim(case, fluid)
    run = db3.make_run_chunk(case)
    s = run(s, jnp.asarray(1.0, s.time.dtype))
    return case, s


def test_3d_runs_without_overflow(sim3d):
    case, s = sim3d
    assert float(s.time) >= 1.0
    assert not bool(s.overflow)
    assert np.isfinite(np.asarray(s.fluid["Pressure"][: case.n_fluid])).all()


def test_3d_energy_and_front(sim3d):
    case, s = sim3d
    e = float(gd.total_mechanical_energy(s.fluid, case.gravity))
    # E0 = rho * V * g * ybar = 1 * (2*1*0.5) * 1 * 0.5 = 0.5
    assert 0.44 < e < 0.505
    xf = float(s.fluid["Position"][: case.n_fluid, 0].max())
    assert 2.3 < xf < db3.LL + 2.0 * float(s.time) + 0.3


def test_3d_stays_in_tank(sim3d):
    case, s = sim3d
    pos = np.asarray(s.fluid["Position"][: case.n_fluid])
    bw = 4 * case.dx
    assert pos[:, 0].min() > -bw and pos[:, 0].max() < db3.DL + bw
    assert pos[:, 1].min() > -bw
    assert pos[:, 2].min() > -bw and pos[:, 2].max() < db3.DW + bw
