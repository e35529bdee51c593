"""Smoke test of the main path on one GPU: the quickest proof that the
system still starts and computes correctly on the card.

    python chip_smoke.py          # phases 1-4 on one card
    python chip_smoke.py --four   # the distributed block engine on 4 cards

Phase 1, main path: the 3D dam break at dx = 0.01 (~1M fluid particles)
  through the CLI's case registry for a few output intervals, then the
  lattice total-Lagrangian twisting column at dx = 0.0175 (~1.13M
  particles) for a few steps.  Checks: no capacity overflow, no NaN, the
  mechanical energy within a few per cent of its initial value before
  impact, the surge front advancing.  Prints compile time, time per
  advection step, XLA's memory analysis and peak device memory.
Phase 2, parity at real width: block engine against gather engine on the
  same 1M-particle dam break over a few advection steps.
Phase 3, GPU against CPU at small size: the block engine and the lattice
  solid, with the CPU backend of this process as the reference.
Phase 4, timings in turns (A, B, B, A): the re-slot sort as the engine
  does it (key-value sort + one row gather) against a multi-operand sort
  that carries every field column.

Every number is printed beside the card's name and power limit.  The last
line of standard output is one JSON object: {"ok": true, "device":
{...}}.  Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.utils.compile_cache import enable_compile_cache
from sphinxsys_jax.utils.device import card_info, require_gpu

# main path at the sizes the benchmark uses (bench.py FLUID_CELLS)
DX = 0.01
CAP = 32
C_MAX = 125_000
T_END = 0.03            # ~26 advection steps: well before the surge impact
N_OUTPUT = 3
SOLID_DX = 0.0175
SOLID_STEPS = 20
PARITY_STEPS = 3
TIMED_STEPS = 5
SMALL_DX = 0.1
ENERGY_TOL = 0.03       # relative drift allowed before impact
PARITY_TOL = 2e-3       # x domain scale (tests/test_scene_engines.py)
GPU_CPU_TOL = 1e-4      # x domain scale: float32 summation order only


def _report(card: str, phase: str, **numbers) -> None:
    vals = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{card}] {phase}: {vals}", flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _peak_bytes(device=None) -> int | None:
    device = device or jax.devices()[0]
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def _fluid_energy(fb, g: float = 1.0) -> float:
    """KE + PE (gravity along -y) of a block state's real slots."""
    m = jnp.where(fb["SlotMask"], fb["Mass"], 0.0)
    ke = 0.5 * m * jnp.sum(fb["Velocity"] ** 2, axis=-1)
    return float(jnp.sum(ke + m * g * fb["Position"][..., 1]))


# ---------------------------------------------------------------------------
# phase 1: the main path through the user's entry points
# ---------------------------------------------------------------------------

def phase_main(card: str, dx=DX, cap=CAP, c_max=C_MAX, t_end=T_END,
               n_output=N_OUTPUT, solid_dx=SOLID_DX,
               solid_steps=SOLID_STEPS):
    from sphinxsys_jax import run as cli
    from sphinxsys_jax.cases import dambreak_3d as db
    from sphinxsys_jax.cases import twisting_column_3d as tc
    from sphinxsys_jax.engine import scene as sc
    from sphinxsys_jax.utils.config import RunConfig

    cfg = RunConfig.from_cli([
        "--no-state-recording", "--set", f"dx={dx}", "--set", f"cap={cap}",
        "--set", f"c_max={c_max}", "--set", f"t_end={t_end}",
        "--set", f"n_output={n_output}"])
    t0 = time.perf_counter()
    scene, s = cli.CASES["dambreak_3d_block"](cfg)
    jax.block_until_ready(s.fluid_b["Position"])
    run_s = time.perf_counter() - t0
    fb = s.fluid_b
    mask = fb["SlotMask"]
    _check(not bool(s.overflow), "dam break: block capacity overflow")
    for k in ("Pressure", "Velocity", "Position"):
        _check(bool(jnp.all(jnp.isfinite(fb[k]))), f"dam break: NaN in {k}")
    # the resting column's mean height is LH/2, so E0 = M g LH/2
    mass = float(jnp.sum(jnp.where(mask, fb["Mass"], 0.0)))
    e0 = mass * db.GRAVITY_G * db.LH / 2.0
    e1 = _fluid_energy(fb, db.GRAVITY_G)
    front0 = db.LL - dx / 2.0
    front1 = float(jnp.max(jnp.where(mask, fb["Position"][..., 0], -1.0)))
    _check(abs(e1 - e0) / e0 < ENERGY_TOL,
           f"dam break: energy drift {e1} vs {e0}")
    _check(front1 > front0, f"dam break: front {front1} did not pass {front0}")
    _report(card, "phase1 dambreak_3d_block (CLI)", n_fluid=scene.n_fluid,
            sim_time=float(s.time), n_adv=int(s.n_adv), n_ac=int(s.n_ac),
            run_s=round(run_s, 3), energy0=e0, energy=e1,
            front0=front0, front=front1)

    # compile time, memory analysis and steady time of one advection step
    step_fn = jax.jit(lambda st, pk: sc._advection_step(
        sc._rebind(sc._bare(scene), pk), st))
    pack = sc._pack(scene)
    t0 = time.perf_counter()
    compiled = step_fn.lower(s, pack).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    s, _ = _timed(compiled, s, pack)                 # warm
    n0 = int(s.n_adv)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        s = compiled(s, pack)
    jax.block_until_ready(s.fluid_b["Position"])
    per_step = (time.perf_counter() - t0) / (int(s.n_adv) - n0)
    _check(not bool(s.overflow), "dam break: overflow in the timed steps")
    _report(card, "phase1 advection step", compile_s=round(compile_s, 3),
            s_per_step=round(per_step, 6),
            temp_bytes=getattr(mem, "temp_size_in_bytes", None),
            argument_bytes=getattr(mem, "argument_size_in_bytes", None),
            output_bytes=getattr(mem, "output_size_in_bytes", None),
            peak_bytes_in_use=_peak_bytes())

    # the lattice total-Lagrangian solid
    case, col = tc.build_case(dx=solid_dx, engine="lattice")
    st = tc.init_sim(case, col)
    run = tc.make_run_chunk(case)
    t0 = time.perf_counter()
    st = run(st, jnp.asarray(1.0e-9, st.time.dtype))       # one step
    jax.block_until_ready(st.column["Position"])
    first_s = time.perf_counter() - t0
    dt0 = float(st.time) / int(st.n_steps)
    n0 = int(st.n_steps)
    st, elapsed = _timed(
        lambda x: run(x, jnp.asarray(float(x.time) + solid_steps * dt0,
                                     x.time.dtype)), st)
    steps = int(st.n_steps) - n0
    _check(steps > 0, "solid: no steps taken")
    _check(bool(jnp.all(jnp.isfinite(st.column["Position"]))),
           "solid: NaN in Position")
    _report(card, "phase1 twisting_column_3d lattice", n=case.n_column,
            steps=steps, compile_and_first_step_s=round(first_s, 3),
            s_per_step=round(elapsed / steps, 6),
            peak_bytes_in_use=_peak_bytes())
    return scene, s


# ---------------------------------------------------------------------------
# phase 2: block engine against gather engine at real width
# ---------------------------------------------------------------------------

def phase_parity(card: str, dx=DX, cap=CAP, c_max=C_MAX,
                 n_steps=PARITY_STEPS):
    from sphinxsys_jax.cases import dambreak_3d as db
    from sphinxsys_jax.engine import scene as sc

    case_g, fluid_g = db.build_case(dx=dx)
    sg = db.init_sim(case_g, fluid_g)
    step_g = jax.jit(lambda st: db._advection_step(case_g, st))
    for _ in range(n_steps):
        sg = step_g(sg)
    pos_g = np.asarray(sg.fluid["Position"])[:case_g.n_fluid]
    n_adv_g, n_ac_g = int(sg.n_adv), int(sg.n_ac)
    _check(not bool(sg.overflow), "gather engine: neighbor overflow")
    del sg, step_g, fluid_g

    scene, fluid_b = db.build_block_case(dx=dx, cap=cap, c_max=c_max)
    sb = sc.init_sim(scene, fluid_b)
    step_b = sc.make_advection_step(scene)
    for _ in range(n_steps):
        sb = step_b(sb)
    _check(not bool(sb.overflow), "block engine: capacity overflow")
    pos_b = np.asarray(sc.blocks_to_particles(scene, sb)["Position"])
    scale = float(np.abs(pos_g).max())
    dev = float(np.abs(pos_g - pos_b[:case_g.n_fluid]).max())
    _report(card, "phase2 block vs gather", n_fluid=case_g.n_fluid,
            n_adv=(n_adv_g, int(sb.n_adv)), n_ac=(n_ac_g, int(sb.n_ac)),
            max_pos_dev=dev, limit=PARITY_TOL * scale)
    _check(n_adv_g == int(sb.n_adv) and n_ac_g == int(sb.n_ac),
           "block and gather engines took different steps")
    _check(dev < PARITY_TOL * scale, f"block vs gather deviation {dev}")


# ---------------------------------------------------------------------------
# phase 3: GPU against this process's CPU backend at small size
# ---------------------------------------------------------------------------

def _dambreak_small(dx, n_steps):
    from sphinxsys_jax.cases import dambreak_3d as db
    from sphinxsys_jax.engine import scene as sc

    scene, fluid = db.build_block_case(dx=dx)
    s = sc.init_sim(scene, fluid)
    step = sc.make_advection_step(scene)
    for _ in range(n_steps):
        s = step(s)
    return (np.asarray(sc.blocks_to_particles(scene, s)["Position"]),
            int(s.n_ac))


def _solid_small(n_steps):
    from sphinxsys_jax.cases import twisting_column_3d as tc

    case, col = tc.build_case(engine="lattice")
    s = tc.init_sim(case, col)
    step = jax.jit(lambda st: tc._step(case, st))
    for _ in range(n_steps):
        s = step(s)
    return np.asarray(s.column["Position"])


def phase_gpu_vs_cpu(card: str, dx=SMALL_DX, fluid_steps=5,
                     solid_steps=100):
    cpu = jax.devices("cpu")[0]
    # XLA's GPU default for float32 dot products may use TF32; the CPU
    # computes them in full float32.  Run the solid (the only path with
    # matrix products) at the default precision and at "highest".
    precision = jax.config.jax_default_matmul_precision or "default"
    pos_gpu, nac_gpu = _dambreak_small(dx, fluid_steps)
    with jax.default_device(cpu):
        pos_cpu, nac_cpu = _dambreak_small(dx, fluid_steps)
    scale = float(np.abs(pos_cpu).max())
    dev = float(np.abs(pos_gpu - pos_cpu).max())
    _report(card, "phase3 dambreak_3d block GPU vs CPU", dx=dx,
            n_ac=(nac_gpu, nac_cpu), max_pos_dev=dev,
            limit=GPU_CPU_TOL * scale)
    _check(nac_gpu == nac_cpu, "GPU and CPU took different steps")
    _check(dev < GPU_CPU_TOL * scale, f"dam break GPU vs CPU deviation {dev}")

    sol_gpu = _solid_small(solid_steps)
    with jax.default_matmul_precision("highest"):
        sol_gpu_hi = _solid_small(solid_steps)
    with jax.default_device(cpu):
        sol_cpu = _solid_small(solid_steps)
    scale = float(np.abs(sol_cpu).max())
    dev = float(np.abs(sol_gpu - sol_cpu).max())
    dev_hi = float(np.abs(sol_gpu_hi - sol_cpu).max())
    _report(card, "phase3 twisting_column lattice GPU vs CPU",
            steps=solid_steps, matmul_precision=precision,
            max_pos_dev=dev, max_pos_dev_highest=dev_hi,
            limit=GPU_CPU_TOL * scale)
    _check(dev < GPU_CPU_TOL * scale, f"solid GPU vs CPU deviation {dev}")


# ---------------------------------------------------------------------------
# phase 4: re-slot sort timings
# ---------------------------------------------------------------------------

def _reslot_inputs(scene, s):
    """The flat slot arrays a re-slot sorts: cell ids and the packed field
    columns, exactly as engine.slot_fluid builds them."""
    fb = s.fluid_b
    cols = []
    for k in scene.fields:
        v = fb[k].reshape((-1,) + fb[k].shape[2:]).astype(jnp.float32)
        cols.extend([v] if v.ndim == 1 else [v[:, d] for d in
                                             range(v.shape[1])])
    valid = fb["SlotMask"].reshape(-1)
    grid = scene.grid
    cid = jnp.where(valid, grid.cell_id(fb["Position"].reshape(
        -1, fb["Position"].shape[-1])), grid.ncells).astype(jnp.int32)
    return cid, jnp.stack(cols, axis=-1)


def _sort_kv_gather(cid, carry, m):
    """The engine's form (cell_blocks.build_block_map)."""
    iota = jnp.arange(cid.shape[0], dtype=jnp.int32)
    scid, order = jax.lax.sort((cid, iota), num_keys=1, is_stable=True)
    return scid[:m], carry[order[:m]]


def _sort_carry(cid, carry, m):
    """The alternative: every column rides a multi-operand sort."""
    iota = jnp.arange(cid.shape[0], dtype=jnp.int32)
    cols = tuple(carry[:, k] for k in range(carry.shape[1]))
    out = jax.lax.sort((cid, iota) + cols, num_keys=1, is_stable=True)
    return out[0][:m], jnp.stack(out[2:], axis=-1)[:m]


def _alternate(fns: dict, args, rounds: int = 2, reps: int = 5) -> dict:
    """Median seconds per call of each fn, run in turns A, B, B, A."""
    jitted = {k: jax.jit(f, static_argnums=(2,)) for k, f in fns.items()}
    for f in jitted.values():
        jax.block_until_ready(f(*args))             # compile + warm
    names = list(jitted)
    order = (names + names[::-1]) * rounds
    times = {k: [] for k in names}
    for k in order:
        for _ in range(reps):
            _, dt = _timed(jitted[k], *args)
            times[k].append(dt)
    return {k: statistics.median(v) for k, v in times.items()}


def phase_timings(card: str, scene, s):
    cid, carry = _reslot_inputs(scene, s)
    m = scene.n_fluid
    a = _sort_kv_gather(cid, carry, m)
    b = _sort_carry(cid, carry, m)
    _check(bool(jnp.all(a[0] == b[0])) and bool(jnp.all(a[1] == b[1])),
           "re-slot sort variants disagree")
    med = _alternate({"kv_sort_gather": _sort_kv_gather,
                      "multi_operand_sort": _sort_carry}, (cid, carry, m))
    _report(card, "phase4 re-slot sort", rows=int(cid.shape[0]),
            columns=int(carry.shape[1]), valid_rows=m,
            **{f"{k}_s": round(v, 6) for k, v in med.items()})


# ---------------------------------------------------------------------------
# --four: the distributed block engine on four cards
# ---------------------------------------------------------------------------

def phase_four(card: str, dx=DX, cap=CAP, c_max=C_MAX, n_steps=PARITY_STEPS,
               n_dev=4, halo_cap=16_384, migrate_cap=4_096,
               c_max_loc=None):
    from sphinxsys_jax.cases import dambreak_3d as db
    from sphinxsys_jax.engine import scene as sc
    from sphinxsys_jax.parallel import block_domain as bd
    from sphinxsys_jax.parallel.mesh import make_particle_mesh

    devices = jax.devices()
    _check(len(devices) >= n_dev, f"needs {n_dev} devices")
    scene, fluid = db.build_block_case(dx=dx, cap=cap, c_max=c_max)
    n = scene.n_fluid

    # the same case on one card: the reference
    s1 = sc.init_sim(scene, fluid)
    step1 = sc.make_advection_step(scene)
    for _ in range(n_steps):
        s1 = step1(s1)
    _check(not bool(s1.overflow), "one card: overflow")
    pos1 = np.asarray(sc.blocks_to_particles(scene, s1, n)["Position"])
    time1, nac1 = float(s1.time), int(s1.n_ac)
    del s1, step1

    mesh = make_particle_mesh(n_dev)
    hs = bd.distribute_block_engine(scene.eng, fluid, mesh)
    step = bd.make_distributed_engine_step(
        scene.eng, mesh, wall_b=scene.wall_b, bm_wall=scene.bm_wall,
        wall_dense_map=scene.wall_dense_map, halo_cap=halo_cap,
        migrate_cap=migrate_cap,
        c_max_loc=c_max_loc or c_max // 2)
    t0 = time.perf_counter()
    hs = step(hs)
    jax.block_until_ready(hs.fluid["Position"])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_steps - 1):
        hs = step(hs)
    jax.block_until_ready(hs.fluid["Position"])
    per_step = (time.perf_counter() - t0) / max(n_steps - 1, 1)
    _check(not bool(hs.overflow), "four cards: overflow")

    # each card holds its own slab
    pos_arr = hs.fluid["Position"]
    shard_devs = {sh.device for sh in pos_arr.addressable_shards}
    _check(len(shard_devs) == n_dev and
           pos_arr.sharding.spec[0] is not None,
           f"positions not split over {n_dev} cards: {pos_arr.sharding}")
    in_use = [(d.memory_stats() or {}).get("bytes_in_use")
              for d in devices[:n_dev]]
    if None not in in_use:          # the CPU backend keeps no statistics
        _check(min(in_use) > 0.1 * max(in_use),
               f"device memory unevenly used: {in_use}")
    alive_per_dev = [int(np.asarray(sh.data).sum())
                     for sh in hs.fluid["Alive"].addressable_shards]

    alive = np.asarray(hs.fluid["Alive"])
    ids = np.asarray(hs.fluid["OriginalID"])[alive]
    _check(sorted(ids.tolist()) == list(range(n)), "particles lost or copied")
    pos4 = np.zeros((n, 3), np.float32)
    pos4[ids] = np.asarray(hs.fluid["Position"])[alive]
    scale = float(np.abs(pos1).max())
    dev = float(np.abs(pos4 - pos1[:n]).max())
    _report(card, "four distributed vs one card", n_fluid=n,
            n_ac=(int(hs.n_ac), nac1), time=(float(hs.time), time1),
            max_pos_dev=dev, limit=PARITY_TOL * scale,
            alive_per_device=alive_per_dev, bytes_in_use=in_use,
            compile_and_first_step_s=round(first_s, 3),
            s_per_step=round(per_step, 6))
    _check(int(hs.n_ac) == nac1, "four cards took other acoustic steps")
    _check(dev < PARITY_TOL * scale, f"four-card deviation {dev}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the distributed block engine on 4 cards "
                        "against the same case on one card")
    args = p.parse_args(argv)

    device = require_gpu()
    card = card_info()
    print(f"card: {card.replace(chr(10), ' | ')}", flush=True)
    card_tag = card.splitlines()[0]
    enable_compile_cache()
    t_start = time.perf_counter()
    if args.four:
        phase_four(card_tag)
    else:
        scene, s = phase_main(card_tag)
        _report(card_tag, "phase1 done", wall_s=round(
            time.perf_counter() - t_start, 1))
        phase_timings(card_tag, scene, s)
        del scene, s
        _report(card_tag, "phase4 done", wall_s=round(
            time.perf_counter() - t_start, 1))
        phase_parity(card_tag)
        _report(card_tag, "phase2 done", wall_s=round(
            time.perf_counter() - t_start, 1))
        phase_gpu_vs_cpu(card_tag)
    _report(card_tag, "all phases done", wall_s=round(
        time.perf_counter() - t_start, 1))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
