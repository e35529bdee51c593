"""One scene, every engine — the generic block-engine runner.

The reference's core API property is that ONE case description runs under
every execution policy (`particle_method_container.h:206` — the same
scene executes seq / TBB / SYCL).  Here the same role is played by this
module: a case defines its physics once (the gather-path `base` case +
a `BlockEngine` + optional hooks) and gets the cell-block fast path,
the re-slot loop, and (through parallel/block_domain.py) the
distributed wrapper for free — no hand-written `*_block.py` twin.

Covers, through configuration alone:
  * static-wall free-surface scenes (dambreak 2D/3D),
  * wall-less periodic scenes with viscosity + TVC (taylor-green),
  * moving-wall FSI scenes with solid sub-cycling (fsi2) via `Hooks` +
    `wall_state_fn`.

The dual-criteria loop structure follows SURVEY.md §3.2 (reference
Dambreak.cpp:166-220): outer advection step (density summation, viscous,
TVC, re-slot) and inner acoustic loop (two half-steps, optional coupling
hooks between them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from sphinxsys_jax.engine import block_fluid as eng_mod
from sphinxsys_jax.engine.block_fluid import BlockEngine
from sphinxsys_jax.neighbors.cell_blocks import dense_cell_map
from sphinxsys_jax.neighbors.cell_list import wrap_positions


class Hooks(NamedTuple):
    """Case-specific extension points of the generic loop.  Every hook is
    optional; all run INSIDE jit (no data-dependent Python control flow).

    post_prep(fb, aux, time) -> (fb, aux)
        after density/viscous/TVC prep, once per advection step (e.g. FSI
        viscous force on the coupled solid + normal refresh).
    after_first_half(fb, aux, dt, t_now) -> (fb, aux)
        between the acoustic halves (e.g. solid pressure force — the
        reference runs pressure_force on the mid-step fluid state).
    post_acoustic(fb, aux, dt, t_next) -> (fb, aux)
        after the 2nd half, once per acoustic iteration (e.g. solid
        sub-cycling, inflow velocity imposition).
    post_advection(flat, aux, time) -> (flat, aux)
        on the FLAT particle arrays just before the re-slot (e.g.
        emitters/disposers/buffer exchange).
    rebuild_aux(bm_f, aux) -> aux
        after each re-slot (e.g. recompute solid->fluid block windows).
    """

    post_prep: Callable | None = None
    after_first_half: Callable | None = None
    post_acoustic: Callable | None = None
    post_advection: Callable | None = None
    rebuild_aux: Callable | None = None


class BlockSim(NamedTuple):
    fluid_b: Any
    nbr_inner: Any
    nbr_wall: Any      # None when the scene has no wall body
    wall_bm: Any       # moving-wall scenes only (slots re-frozen per step)
    wall_b0: Any       # moving-wall scenes only
    aux: Any           # case pytree (coupled solid, counters, windows, ...)
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class BlockScene:
    """Engine-agnostic scene -> block-engine binding.  Built by
    `standard_scene` (static/no wall) or `moving_wall_scene` (FSI)."""

    base: Any                 # the gather-path case (geometry, materials)
    eng: BlockEngine
    n_fluid: int
    # static wall channel (built once at case build)
    wall_b: Any = None
    bm_wall: Any = None
    wall_dense_map: Any = None
    # moving-wall channel (rebuilt per advection step from aux)
    wall_state_fn: Callable | None = None    # (aux) -> wall state dict
    wall_valid: Any = None
    c_max_wall: int = 0
    hooks: Hooks = Hooks()
    wrap: bool = False        # wrap positions into the periodic box on slot
    extra_fields: tuple = ()  # extra flat fields carried through re-slots

    @property
    def kernel(self):
        return self.eng.kernel

    @property
    def grid(self):
        return self.eng.grid

    @property
    def fields(self):
        return self.eng.fluid_fields + self.extra_fields + ("OriginalID",)


def standard_scene(base, fluid, *, rho0: float, speed_ref: float,
                   dim: int = 2, mu: float = 0.0, tvc_coef: float = 0.0,
                   tvc_limiter: float | None = None,
                   free_surface: bool = True, riemann2=None, wall=None,
                   cap: int = 12, c_max: int | None = None,
                   cap_wall: int | None = None, c_max_wall: int | None = None,
                   cap_ac_dt: bool = False, wrap: bool = False,
                   hooks: Hooks = Hooks(),
                   extra_fields: tuple = ()) -> BlockScene:
    """Bind a gather-path case to the block engine.  `base` must provide
    adaptation, grid, eos, riemann, n_fluid; `wall` (a state dict) is
    slotted once as a static contact body."""
    grid = base.grid if hasattr(base, "grid") else base.grid_f
    if c_max is None:
        # free-surface flows occupy a fraction of the domain cells
        # (measured dambreak max ~n/6 through impact; /5 adds surge
        # margin, overflow-flag guarded); confined/periodic boxes
        # occupy every cell
        c_max = max(base.n_fluid // 5, 512) if free_surface else grid.ncells
    eng = BlockEngine(
        grid=grid, kernel=base.kernel, eos=base.eos, riemann1=base.riemann,
        riemann2=riemann2 if riemann2 is not None else base.riemann,
        rho0=rho0, sigma0=base.adaptation.sigma0, h=base.adaptation.h,
        speed_ref=speed_ref, dim=dim, mu=mu, tvc_coef=tvc_coef,
        tvc_limiter=tvc_limiter, free_surface=free_surface, cap=cap,
        c_max=c_max, cap_ac_dt=cap_ac_dt)

    wall_b = bm_wall = dm_w = None
    if wall is not None:
        cmw = eng_mod.round_to(c_max_wall
                               or max(int(wall["Position"].shape[0]) // 4,
                                      256), 32)

        @jax.jit
        def _build_wall():
            return eng_mod.build_wall_blocks(
                dataclasses.replace(eng, cap=cap_wall or cap), wall, cmw)

        wall_b, bm_wall, dm_w = _build_wall()

    extra = tuple(extra_fields)
    return BlockScene(base=base, eng=eng, n_fluid=base.n_fluid,
                      wall_b=wall_b, bm_wall=bm_wall, wall_dense_map=dm_w,
                      hooks=hooks, wrap=wrap, extra_fields=extra)


def moving_wall_scene(base, *, eng: BlockEngine, wall_state_fn,
                      wall_valid, c_max_wall: int, hooks: Hooks,
                      wrap: bool = False,
                      extra_fields: tuple = ()) -> BlockScene:
    """FSI-style scenes: the wall-type contact body is DERIVED from the aux
    pytree (static strips + moving solid) and re-slotted every advection
    step; its channels refresh every acoustic iteration."""
    return BlockScene(base=base, eng=eng, n_fluid=base.n_fluid,
                      wall_state_fn=wall_state_fn, wall_valid=wall_valid,
                      c_max_wall=c_max_wall, hooks=hooks, wrap=wrap,
                      extra_fields=extra_fields)


def _pack(scene: BlockScene):
    """Array-bearing statics as a pytree.  Large device arrays must be jit
    ARGUMENTS, not closure constants: closure constants are embedded in
    the HLO as literals, which bloats compile time and memory at 1M+
    particles."""
    return (scene.wall_b, scene.bm_wall, scene.wall_dense_map,
            scene.wall_valid)


def _bare(scene: BlockScene) -> "BlockScene":
    return dataclasses.replace(scene, wall_b=None, bm_wall=None,
                               wall_dense_map=None, wall_valid=None)


def _rebind(bare: "BlockScene", pack) -> "BlockScene":
    return dataclasses.replace(bare, wall_b=pack[0], bm_wall=pack[1],
                               wall_dense_map=pack[2], wall_valid=pack[3])


def _slot(scene: BlockScene, flat: dict, valid, aux):
    """Re-slot fluid (+ moving wall) and rebuild window maps."""
    eng = scene.eng
    flat = dict(flat)
    if scene.wrap:
        flat["Position"] = wrap_positions(flat["Position"], eng.grid)
    fb, bm_f = eng_mod.slot_fluid(eng, flat, valid, n_max=scene.n_fluid)
    overflow = bm_f.overflow

    nbr_wall = wall_bm = wall_b0 = None
    if scene.wall_state_fn is not None:
        wstate = scene.wall_state_fn(aux)
        wall_b0, wall_bm, dm_w = eng_mod.build_wall_blocks(
            eng, wstate, scene.c_max_wall, valid=scene.wall_valid)
        nbr_wall = eng_mod.wall_windows(eng, bm_f, wall_bm, dm_w)
        overflow = overflow | wall_bm.overflow
    elif scene.wall_b is not None:
        nbr_wall = eng_mod.wall_windows(eng, bm_f, scene.bm_wall,
                                        scene.wall_dense_map)

    if scene.hooks.rebuild_aux is not None:
        aux = scene.hooks.rebuild_aux(bm_f, aux)
    return fb, bm_f, nbr_wall, wall_bm, wall_b0, aux, overflow


def init_sim(scene: BlockScene, fluid: dict, aux=None) -> BlockSim:
    n = fluid["Position"].shape[0]
    flat = {k: fluid[k] for k in scene.eng.fluid_fields if k in fluid}
    if "ViscousForcePrev" in scene.eng.fluid_fields \
            and "ViscousForcePrev" not in flat:
        flat["ViscousForcePrev"] = jnp.zeros_like(fluid["Velocity"])
    for k in scene.extra_fields:
        flat[k] = fluid[k]
    flat["OriginalID"] = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.arange(n) < fluid["NReal"]

    bare = _bare(scene)
    fb, bm_f, nbr_wall, wall_bm, wall_b0, aux, ovf = jax.jit(
        lambda fl, va, au, pk: _slot(_rebind(bare, pk), fl, va, au))(
            flat, valid, aux, _pack(scene))
    dtype = fluid["Position"].dtype
    z32 = jnp.zeros((), jnp.int32)
    return BlockSim(fluid_b=fb, nbr_inner=bm_f.nbr_block, nbr_wall=nbr_wall,
                    wall_bm=wall_bm, wall_b0=wall_b0, aux=aux,
                    time=jnp.zeros((), dtype), n_adv=z32, n_ac=z32,
                    overflow=ovf)


def _wall_ctx0(scene: BlockScene, s: BlockSim) -> eng_mod.WallCtx:
    if scene.wall_state_fn is not None:
        return eng_mod.WallCtx(s.wall_b0, s.nbr_wall)
    if scene.wall_b is not None:
        return eng_mod.WallCtx(scene.wall_b, s.nbr_wall)
    return eng_mod.WallCtx()


def _advection_step(scene: BlockScene, s: BlockSim) -> BlockSim:
    eng, hooks = scene.eng, scene.hooks
    fb, aux = s.fluid_b, s.aux
    wc0 = _wall_ctx0(scene, s)

    dt_adv = eng_mod.advection_dt(eng, fb)
    fb = eng_mod.advection_prep(eng, fb, s.nbr_inner, wc0)
    if hooks.post_prep is not None:
        fb, aux = hooks.post_prep(fb, aux, s.time)

    def ac_cond(carry):
        _, _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, au, rt, k = carry
        t_now = s.time + rt
        if scene.wall_state_fn is not None:
            wstate = scene.wall_state_fn(au)
            wall_b = eng_mod.refresh_wall_blocks(eng, s.wall_bm, wstate,
                                                 s.wall_b0)
            wc = eng_mod.WallCtx(wall_b, s.nbr_wall)
        else:
            wc = wc0
        dt = eng_mod.acoustic_dt(eng, f, dt_adv)
        f = eng_mod.acoustic_first_half(eng, f, s.nbr_inner, wc, dt)
        if hooks.after_first_half is not None:
            f, au = hooks.after_first_half(f, au, dt, t_now)
        f = eng_mod.acoustic_second_half(eng, f, s.nbr_inner, wc, dt)
        if hooks.post_acoustic is not None:
            f, au = hooks.post_acoustic(f, au, dt, t_now + dt)
        return (f, au, rt + dt, k + 1)

    fb, aux, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fb, aux, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    flat = {k: fb[k].reshape((-1,) + fb[k].shape[2:]) for k in scene.fields}
    valid = fb["SlotMask"].reshape(-1)
    if hooks.post_advection is not None:
        flat, aux = hooks.post_advection(flat, aux, s.time + relax_t)
        valid = flat.pop("_Valid", valid)
    fb2, bm_f, nbr_wall, wall_bm, wall_b0, aux, ovf = _slot(
        scene, flat, valid, aux)

    return BlockSim(fluid_b=fb2, nbr_inner=bm_f.nbr_block, nbr_wall=nbr_wall,
                    wall_bm=wall_bm, wall_b0=wall_b0, aux=aux,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | ovf)


def make_run_chunk(scene: BlockScene):
    bare = _bare(scene)

    @jax.jit
    def run_chunk(s: BlockSim, t_target, pk) -> BlockSim:
        sc = _rebind(bare, pk)
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(sc, st), s)

    pack = _pack(scene)
    return lambda s, t_target: run_chunk(s, t_target, pack)


def make_advection_step(scene: BlockScene):
    bare = _bare(scene)

    @jax.jit
    def step(s: BlockSim, pk) -> BlockSim:
        return _advection_step(_rebind(bare, pk), s)

    pack = _pack(scene)
    return lambda s: step(s, pack)


def blocks_to_particles(scene: BlockScene, s: BlockSim, n: int | None = None
                        ) -> dict:
    return eng_mod.blocks_to_particles(scene.eng, s.fluid_b,
                                       n or scene.n_fluid)
