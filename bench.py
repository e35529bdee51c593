"""Benchmark: pair-interaction updates per second of the block engine on
one GPU.

Metric: every acoustic sub-step sweeps all fluid-fluid + fluid-wall pairs
twice (pressure + density relaxation); density summation adds one sweep
per advection step.  interaction-updates/sec = that pair count / wall
time of a timed window that ends in `block_until_ready`.

Cells (one JSON line each, printed as it completes): the 2D dambreak at
320k particles, the 3D dambreak at ~1M and at ~4.1M (the reference's
flagship scaling story is the 3D Kleefsman run,
docs/_posts/2025-02-01-heterogeneous-parallelism-p3.md), and the 3D
twisting column on the lattice-stencil TL solid engine at ~1.13M
particles.  Every line records the device (JAX's platform, device kind
and count, and the card's name and power limit), set-up time (compile +
warm-up), the timed window and peak device memory.  The run fails
without a GPU, and exits non-zero if any cell failed.

Env: BENCH_CASE (dambreak_2d | dambreak_3d | twisting_column_3d) runs
only that case, with BENCH_DX; BENCH_STEPS sets the timed advection steps
(default 40).
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

# (case, dx, block-engine capacities)
FLUID_CELLS = [
    ("dambreak_2d", 0.0025, {}),
    ("dambreak_3d", 0.01, {"cap": 32, "c_max": 125_000}),
    ("dambreak_3d", 0.00625, {"cap": 32, "c_max": 440_064}),
]
SOLID_DX = 0.0175


def count_pairs(scene, sim) -> int:
    """True interacting pairs (r < cutoff) of the current block state:
    fluid-fluid (self excluded) + fluid-wall."""
    import jax
    import jax.numpy as jnp

    from sphinxsys_jax.physics import fluid_blocks as fbops

    eng = scene.eng
    cutoff = eng.kernel.cutoff

    def window_count(pos, mask, src_pos, src_mask, nbr, exclude_self):
        n = jnp.zeros((), jnp.int32)
        for w in range(nbr.shape[1]):
            j = nbr[:, w]
            r, _, m = fbops._pair_geom(pos, mask, src_pos[j], src_mask[j], w,
                                       eng.kernel, eng.dim, eng.box,
                                       exclude_self)
            n = n + jnp.sum((m & (r < cutoff)).astype(jnp.int32))
        return n

    @jax.jit
    def count(fb, nbr_inner, wall_b, nbr_wall):
        pos, mask = fb["Position"], fb["SlotMask"]
        n = window_count(pos, mask, pos, mask, nbr_inner, True)
        if wall_b is not None:
            n = n + window_count(pos, mask, wall_b["Position"],
                                 wall_b["SlotMask"], nbr_wall, False)
        return n

    return int(count(sim.fluid_b, sim.nbr_inner, scene.wall_b, sim.nbr_wall))


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_fluid(case_name: str, dx: float, n_steps: int, block_kw: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from sphinxsys_jax.engine import scene as sc

    if case_name == "dambreak_3d":
        from sphinxsys_jax.cases import dambreak_3d as db
    else:
        from sphinxsys_jax.cases import dambreak_2d as db

    t_setup = time.perf_counter()
    case, fluid = db.build_block_case(dx=dx, **block_kw)
    sim = sc.init_sim(case, fluid)
    run_chunk = sc.make_run_chunk(case)
    dt_adv_est = 0.25 * case.base.adaptation.h / db.U_REF
    print(f"[bench] {case_name} dx={dx}: n_fluid={case.n_fluid}; compiling "
          "+ warming up", file=sys.stderr, flush=True)
    # warm-up: compile, then advance until the flow is moving
    sim = run_chunk(sim, jnp.asarray(5 * dt_adv_est, sim.time.dtype))
    jax.block_until_ready(sim.fluid_b["Position"])
    setup_s = time.perf_counter() - t_setup

    n_adv0, n_ac0, t0_sim = int(sim.n_adv), int(sim.n_ac), float(sim.time)
    t0 = time.perf_counter()
    sim = run_chunk(sim, sim.time + n_steps * dt_adv_est)
    jax.block_until_ready(sim.fluid_b["Position"])
    elapsed = time.perf_counter() - t0
    n_adv, n_ac = int(sim.n_adv) - n_adv0, int(sim.n_ac) - n_ac0

    if bool(sim.overflow):
        raise RuntimeError("block capacity overflow during the timed window")
    if not bool(jnp.all(jnp.isfinite(sim.fluid_b["Position"]))):
        raise RuntimeError("non-finite positions after the timed window")
    pairs = count_pairs(case, sim)
    # 2 pair sweeps per acoustic step + 1 density-summation sweep per
    # advection step
    rate = (2 * n_ac + n_adv) * pairs / elapsed
    return {
        "metric": "pair_interaction_updates_per_sec", "value": rate,
        "unit": "1/s",
        "detail": {
            "case": case_name, "engine": "block", "dx": dx,
            "n_fluid": case.n_fluid, "n_wall": case.base.n_wall,
            "advection_steps": n_adv, "acoustic_steps": n_ac,
            "pairs_per_sweep": pairs, "elapsed_s": elapsed,
            "setup_s": setup_s,
            "sim_seconds_per_wall_second":
                (float(sim.time) - t0_sim) / elapsed,
            "peak_bytes_in_use": _peak_bytes(),
        },
    }


def run_solid(dx: float, n_steps: int) -> dict:
    """Twisting-column throughput on the lattice-stencil TL solid engine.
    Pairs per sweep = the exact frozen-pair count (sum over stencil taps
    of in-box i,j pairs); each step runs 2 pair sweeps (1st + 2nd half)."""
    import jax
    import jax.numpy as jnp

    from sphinxsys_jax.cases import twisting_column_3d as tc

    t_setup = time.perf_counter()
    case, col = tc.build_case(dx=dx, engine="lattice")
    s = tc.init_sim(case, col)
    run = tc.make_run_chunk(case)
    print(f"[bench] twisting_column_3d dx={dx}: n={case.n_column}; "
          "compiling + warming up", file=sys.stderr, flush=True)
    s = run(s, jnp.asarray(1.0e-9, s.time.dtype))     # one step: learn dt
    jax.block_until_ready(s.column["Position"])
    dt0 = float(s.time) / int(s.n_steps)
    setup_s = time.perf_counter() - t_setup

    n0, t0_sim = int(s.n_steps), float(s.time)
    t0 = time.perf_counter()
    s = run(s, jnp.asarray(t0_sim + n_steps * dt0, s.time.dtype))
    jax.block_until_ready(s.column["Position"])
    elapsed = time.perf_counter() - t0
    steps = int(s.n_steps) - n0
    if not bool(jnp.all(jnp.isfinite(s.column["Position"]))):
        raise RuntimeError("non-finite positions after the timed window")

    nx, ny, nz = case.lat.shape
    pairs = sum((nx - abs(o[0])) * (ny - abs(o[1])) * (nz - abs(o[2]))
                for o, *_ in case.lat.taps)
    return {
        "metric": "pair_interaction_updates_per_sec",
        "value": 2 * steps * pairs / elapsed, "unit": "1/s",
        "detail": {
            "case": "twisting_column_3d", "engine": "lattice_stencil",
            "dx": dx, "n_solid": case.n_column, "steps": steps,
            "pairs_per_sweep": pairs, "elapsed_s": elapsed,
            "setup_s": setup_s,
            "sim_seconds_per_wall_second":
                (float(s.time) - t0_sim) / elapsed,
            "peak_bytes_in_use": _peak_bytes(),
        },
    }


def main() -> int:
    from sphinxsys_jax.utils.compile_cache import enable_compile_cache
    from sphinxsys_jax.utils.device import card_info, require_gpu

    device = require_gpu()
    card = card_info()
    enable_compile_cache()
    n_steps = int(os.environ.get("BENCH_STEPS", "40"))

    single = os.environ.get("BENCH_CASE")
    jobs = []
    if single == "twisting_column_3d":
        dx = float(os.environ.get("BENCH_DX", SOLID_DX))
        jobs.append(lambda: run_solid(dx, n_steps))
    elif single:
        cells = [c for c in FLUID_CELLS if c[0] == single]
        if not cells:
            raise SystemExit(f"unknown BENCH_CASE {single!r}")
        _, dx, kw = cells[0]
        dx = float(os.environ.get("BENCH_DX", dx))
        jobs.append(lambda: run_fluid(single, dx, n_steps, kw))
    else:
        for name, dx, kw in FLUID_CELLS:
            jobs.append(lambda name=name, dx=dx, kw=kw:
                        run_fluid(name, dx, n_steps, kw))
        jobs.append(lambda: run_solid(SOLID_DX, n_steps))

    failed = 0
    for job in jobs:
        try:
            result = job()
        except Exception:  # one failed cell must not hide the others
            traceback.print_exc()
            failed += 1
            continue
        result["device"] = dict(device, card=card)
        print(json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
