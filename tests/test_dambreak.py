"""End-to-end 2D dambreak regression (coarse, fast) — the tier-2 analog of
the reference's regression-tested integration examples (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import dambreak_2d as db
from sphinxsys_jax.physics import general as gd


@pytest.fixture(scope="module")
def sim_t1():
    case, fluid = db.build_case(dx=0.1)
    s = db.init_sim(case, fluid)
    run = db.make_run_chunk(case)
    s = run(s, jnp.asarray(1.0, s.time.dtype))
    return case, s


def test_runs_to_t1_without_overflow(sim_t1):
    case, s = sim_t1
    assert float(s.time) >= 1.0
    assert not bool(s.overflow)
    p = np.asarray(s.fluid["Pressure"][: case.n_fluid])
    v = np.asarray(s.fluid["Velocity"][: case.n_fluid])
    assert np.isfinite(p).all() and np.isfinite(v).all()


def test_front_advances(sim_t1):
    """Shallow-water theory: front speed <= 2 sqrt(g LH) = 2."""
    case, s = sim_t1
    xfront = float(s.fluid["Position"][: case.n_fluid, 0].max())
    assert 2.5 < xfront < db.LL + 2.0 * float(s.time) + 0.3


def test_energy_budget(sim_t1):
    """Mechanical energy (relative to its initial value) must not grow and
    not dissipate more than a few % before impact."""
    case, s = sim_t1
    e = float(gd.total_mechanical_energy(s.fluid, case.gravity))
    case2, fluid0 = db.build_case(dx=0.1)
    e0 = float(gd.total_mechanical_energy(fluid0, case2.gravity))
    assert e < e0 * 1.001
    assert e > e0 * 0.93


def test_walls_contain_fluid(sim_t1):
    case, s = sim_t1
    pos = np.asarray(s.fluid["Position"][: case.n_fluid])
    assert pos[:, 0].min() > -4 * case.dx - 1e-6
    assert pos[:, 1].min() > -4 * case.dx - 1e-6
    assert pos[:, 0].max() < db.DL + 4 * case.dx
