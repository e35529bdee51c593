"""Solver driver utilities: time stepping, event triggers, phase timing.

Counterpart of the reference CK scene/driver layer
(/root/reference/src/shared/shared_ck/particle_dynamics/sph_solver.h):
  * TimeStepper (:64-181) — physical-time state, integrateMatchedTimeInterval
  * TriggerByInterval / TriggerByPhysicalTime (:138-165)
  * EventScheduler (:41-62)
and of the coarse phase timers every example prints (SURVEY.md §5 tracing:
TickCount totals, Dambreak.cpp:151-156,229-238).

This framework keeps simulation state on device inside jitted
run-chunks; this layer orchestrates host-side concerns only: when to stop,
when to fire IO/observation events, and wall-clock accounting per phase.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List


class TriggerByInterval:
    """Fires every `interval` of physical time (sph_solver.h:138-152)."""

    def __init__(self, interval: float, start: float = 0.0):
        self.interval = float(interval)
        self.next_time = start + self.interval

    def __call__(self, t: float) -> bool:
        if t >= self.next_time - 1e-12:
            while self.next_time <= t + 1e-12:
                self.next_time += self.interval
            return True
        return False


class TriggerByCount:
    """Fires every n-th call (the reference's iteration-modulo outputs)."""

    def __init__(self, every: int):
        self.every = int(every)
        self.count = 0

    def __call__(self, *_):
        self.count += 1
        return self.count % self.every == 0


class EventScheduler:
    """Priority queue of (time, callback) one-shot events (sph_solver.h:41)."""

    def __init__(self):
        self._heap: List = []
        self._n = 0

    def schedule(self, t: float, fn: Callable):
        heapq.heappush(self._heap, (t, self._n, fn))
        self._n += 1

    def next_time(self, default: float) -> float:
        return self._heap[0][0] if self._heap else default

    def fire_due(self, t: float):
        while self._heap and self._heap[0][0] <= t + 1e-12:
            _, _, fn = heapq.heappop(self._heap)
            fn(t)


class PhaseTimer:
    """Wall-clock accumulation per named phase (TickCount/TimeInterval)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    class _Ctx:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            self.timer.totals[self.name] = self.timer.totals.get(
                self.name, 0.0) + time.perf_counter() - self.t0

    def phase(self, name: str):
        return self._Ctx(self, name)

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = [f"Total wall time for computation: {total:.3f} s"]
        for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v:.3f} s")
        return "\n".join(lines)


class ProfilerTrace:
    """jax.profiler trace hook (SURVEY.md §5 tracing/profiling): wraps a
    run region in jax.profiler.start_trace/stop_trace, writing a
    TensorBoard-loadable XPlane trace; annotate() tags host phases so the
    device timeline can be segmented per solver phase."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._active = False

    def __enter__(self):
        import jax

        jax.profiler.start_trace(self.trace_dir)
        self._active = True
        return self

    def __exit__(self, *exc):
        import jax

        if self._active:
            jax.profiler.stop_trace()
            self._active = False

    @staticmethod
    def annotate(name: str):
        import jax

        return jax.profiler.TraceAnnotation(name)


def run_simulation(run_chunk, sim, end_time: float, output_interval: float,
                   on_output: Callable | None = None,
                   check_overflow: bool = True, verbose: bool = True,
                   failure_check: Callable | None = None,
                   trace_dir: str | None = None):
    """Drive a jitted run_chunk to end_time, firing `on_output(sim)` every
    output interval — the standard main-loop shape of every reference case
    (SURVEY.md §3.2/§3.3).  Returns (sim, PhaseTimer).

    `failure_check(sim) -> bool`: fired every output interval; a True
    return aborts with the state dumped (io/failure.py's velocity-bound
    check is the canonical one, io_vtk.h:116-134).
    `trace_dir`: write a jax.profiler device trace of the whole run.
    """
    import contextlib

    import jax.numpy as jnp

    timer = PhaseTimer()
    trace_ctx = ProfilerTrace(trace_dir) if trace_dir else contextlib.nullcontext()
    with trace_ctx:
        return _run_simulation_body(
            run_chunk, sim, end_time, output_interval, on_output,
            check_overflow, verbose, failure_check, timer, jnp)


def _run_simulation_body(run_chunk, sim, end_time, output_interval, on_output,
                         check_overflow, verbose, failure_check, timer, jnp):
    t = float(sim.time)
    n_out = int(t / output_interval)
    while t < end_time - 1e-12:
        target = min((n_out + 1) * output_interval, end_time)
        with timer.phase("integrate"):
            sim = run_chunk(sim, jnp.asarray(target, sim.time.dtype))
            t = float(sim.time)
        n_out += 1
        if check_overflow and bool(sim.overflow):
            raise RuntimeError(
                "neighbor/block capacity overflow — raise k_max/cap/c_max")
        if failure_check is not None and failure_check(sim):
            raise RuntimeError(
                f"failure check fired at t = {t:.6f}; state dumped")
        with timer.phase("output"):
            if on_output is not None:
                on_output(sim)
        if verbose:
            print(f"t = {t:.4f} / {end_time}  (adv {int(sim.n_adv)}, "
                  f"ac {int(sim.n_ac)})", flush=True)
    return sim, timer


def rk2_sequence(step_fn, keys):
    """Generic second-order Runge-Kutta sequence combinator
    (RungeKuttaSequence / Dynamics1LevelRK2: run the 1st-order relaxation
    twice and average the advanced fields with their initial values —
    the pattern the reference instantiates per dynamic, e.g.
    continuum_dynamics and diffusion RK2 variants).

    `step_fn(state, dt, *args, **kwargs) -> state` advances the fields in
    `keys` first order; the returned callable advances them second order.
    """

    def rk2(state, dt, *args, **kwargs):
        s1 = step_fn(state, dt, *args, **kwargs)
        s2 = step_fn(s1, dt, *args, **kwargs)
        out = dict(s2)
        for key in keys:
            out[key] = 0.5 * (state[key] + s2[key])
        return out

    return rk2
