"""Filling tank (test_2d_filling_tank): emitter injection rate, jet
trajectory, and mechanical energy vs the reference DB's early curve
(Run_0: 0.459/0.852/1.535/2.099 at t=0.5/1/2/3; ours tracks within 4%
over that window, drifting to ~6% by t=5 from splash details)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import filling_tank_2d as ft

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

REF_E = {0.5: 0.459, 1.0: 0.852, 2.0: 1.535, 3.0: 2.099}


def test_filling_tank_injection_and_energy():
    case, fluid = ft.build_case()
    s = ft.init_sim(case, fluid)
    run = ft.make_run_chunk(case)

    assert ft.n_alive(s) == case.n_seed

    for t, e_ref in sorted(REF_E.items()):
        s = run(s, jnp.asarray(t, s.time.dtype))
        assert not bool(s.overflow)
        # injection rate: U_JET * (LH/dx) / dx = 400 particles per unit time
        expected = case.n_seed + int(round(400 * float(s.time)))
        assert abs(ft.n_alive(s) - expected) <= 12, (t, ft.n_alive(s))
        e = ft.mechanical_energy(case, s)
        assert e == pytest.approx(e_ref, rel=0.05), (t, e)

    # the jet has hit the floor and spread to the right wall by t=3
    alive = s.fluid["Alive"]
    pos = s.fluid["Position"]
    assert float(jnp.min(jnp.where(alive, pos[:, 1], 1e9))) < case.dx
    assert float(jnp.max(jnp.where(alive, pos[:, 0], -1e9))) > ft.DL - 2 * case.dx
