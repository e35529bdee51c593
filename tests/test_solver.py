"""Solver driver utilities tests."""

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax import solver as sv


def test_trigger_by_interval():
    trig = sv.TriggerByInterval(0.1)
    fired = [t for t in np.arange(0, 1.0, 0.03) if trig(float(t))]
    # fires once per crossing, not repeatedly
    assert len(fired) == 9
    assert abs(fired[0] - 0.12) < 0.03


def test_event_scheduler():
    sched = sv.EventScheduler()
    log = []
    sched.schedule(0.5, lambda t: log.append(("a", t)))
    sched.schedule(0.2, lambda t: log.append(("b", t)))
    sched.fire_due(0.3)
    assert log == [("b", 0.3)]
    sched.fire_due(1.0)
    assert [x[0] for x in log] == ["b", "a"]


def test_run_simulation_dambreak():
    from sphinxsys_jax.cases import dambreak_2d as db

    case, fluid = db.build_case(dx=0.1)
    s = db.init_sim(case, fluid)
    run = db.make_run_chunk(case)
    outputs = []
    s, timer = sv.run_simulation(run, s, end_time=0.3, output_interval=0.1,
                                 on_output=lambda sim: outputs.append(float(sim.time)),
                                 verbose=False)
    assert float(s.time) >= 0.3
    assert len(outputs) == 3
    assert "integrate" in timer.totals


def test_rk2_sequence_order():
    """rk2_sequence turns a 1st-order step into 2nd order: on dc/dt = -c
    the Euler error scales ~dt, the RK2 error ~dt^2."""
    import numpy as np

    from sphinxsys_jax.solver import rk2_sequence

    def euler(state, dt):
        out = dict(state)
        out["C"] = state["C"] - state["C"] * dt
        return out

    rk2 = rk2_sequence(euler, ["C"])
    import jax.numpy as jnp

    exact = float(np.exp(-1.0))

    def run(step, n):
        s = {"C": jnp.asarray(1.0)}
        for _ in range(n):
            s = step(s, 1.0 / n)
        return abs(float(s["C"]) - exact)

    e1, e2 = run(rk2, 10), run(rk2, 20)
    assert e2 < e1 / 3.2            # ~4x drop = 2nd order
    assert run(rk2, 20) < run(euler, 20) / 10.0
