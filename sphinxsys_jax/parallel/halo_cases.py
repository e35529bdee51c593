"""Distributed case closures over the generic slab-decomposition API.

Two different physics compositions run through parallel/domain.py (the
VERDICT r1 "one API, two cases" requirement):

  * dambreak: free-surface WCSPH with a replicated static wall body
    (contact terms), non-periodic slabs;
  * Taylor-Green: fully periodic doubly-wrapped vortex sheet — periodic
    ring topology, viscous + transport-velocity correction, no walls.

Each closure is the case's ordinary advection-step physics written
against the combined local+ghost state, with ctx.refresh after every
half-step pair sweep and ctx.pmax for the global CFL reduces.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from jax.sharding import Mesh

from sphinxsys_jax.neighbors import build_cell_table, build_neighbor_list
from sphinxsys_jax.neighbors.cell_list import CellGrid
from sphinxsys_jax.parallel.domain import (
    AXIS, HaloContext, HaloShard, SlabDecomposition, distribute,
    make_distributed_step,
)
from sphinxsys_jax.physics import fluid as fd

TINY = 1.0e-15


def _extended_grid(grid: CellGrid, axis: int, cutoff: float) -> CellGrid:
    """Extend the build grid by one halo band on each side of `axis` so
    wrapped ghost coordinates bin into real cells."""
    extra = int(jnp.ceil(cutoff / grid.spacing[axis])) + 1
    lower = list(grid.lower)
    shape = list(grid.shape)
    lower[axis] -= extra * grid.spacing[axis]
    shape[axis] += 2 * extra
    periodic = list(grid.periodic or (False,) * grid.dim)
    periodic[axis] = False
    return dataclasses.replace(grid, lower=tuple(lower), shape=tuple(shape),
                               periodic=tuple(periodic))


def _pad_nl(nl, extra: int, sentinel: int):
    import jax.numpy as jnp
    pad_idx = jnp.full((extra,) + nl.idx.shape[1:], sentinel, dtype=nl.idx.dtype)
    pad_cnt = jnp.zeros((extra,), dtype=nl.count.dtype)
    return type(nl)(idx=jnp.concatenate([nl.idx, pad_idx], axis=0),
                    count=jnp.concatenate([nl.count, pad_cnt], axis=0),
                    overflow=nl.overflow)


def make_halo_dambreak_step(case, mesh: Mesh, halo_cap: int = 512,
                            migrate_cap: int = 256):
    """Distributed 2D dambreak through the generic API (replaces the
    hard-coded prototype in parallel/halo.py)."""
    from sphinxsys_jax.cases.dambreak_2d import RHO0_F, U_REF

    n_dev = mesh.devices.size
    decomp = SlabDecomposition(grid=case.grid, n_dev=n_dev,
                               cutoff=case.adaptation.cutoff,
                               halo_cap=halo_cap, migrate_cap=migrate_cap)
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    wall, wall_table = case.wall, case.wall_table

    def physics(ctx: HaloContext, comb, aux):
        table = build_cell_table(comb["Position"], comb["Alive"], case.grid,
                                 cap=case.cell_cap)
        nl_inner = build_neighbor_list(
            comb["Position"], comb["Alive"], comb["Position"], comb["Alive"],
            table, case.grid, decomp.cutoff, k_max=case.k_inner,
            include_self=False)
        nl_wall_loc = build_neighbor_list(
            comb["Position"][:ctx.n_loc], ctx.alive, wall["Position"],
            wall["NReal"], wall_table, case.grid, decomp.cutoff,
            k_max=case.k_wall, include_self=True)
        nl_wall = _pad_nl(nl_wall_loc, ctx.n_ghost, case.n_wall)

        # advection dt: local masked reduce + global pmax
        accel = 4.0 * h * jnp.linalg.norm(
            comb["Force"][:ctx.n_loc] + comb["ForcePrior"][:ctx.n_loc],
            axis=-1) / comb["Mass"][:ctx.n_loc]
        v2 = jnp.sum(comb["Velocity"][:ctx.n_loc] ** 2, axis=-1)
        red = ctx.pmax(jnp.max(jnp.where(ctx.alive, jnp.maximum(v2, accel), 0.0)))
        dt_adv = 0.25 * h / (jnp.maximum(jnp.sqrt(red), U_REF) + TINY)

        comb = fd.density_summation(comb, nl_inner, kernel, dim, RHO0_F,
                                    sigma0, contacts=[(wall, nl_wall, RHO0_F)],
                                    free_surface=True)
        comb = ctx.refresh(comb)

        def ac_cond(carry):
            _, rt, _ = carry
            return rt < dt_adv

        def ac_body(carry):
            sc, rt, k = carry
            c_eos = case.eos.sound_speed(sc["Pressure"], sc["Density"])
            speed = jnp.linalg.norm(sc["Velocity"], axis=-1)
            local = jnp.max(jnp.where(sc["Alive"], c_eos + speed, 0.0))
            dt = 0.6 * h / (ctx.pmax(local) + TINY)
            sc = fd.acoustic_step_1st_half(sc, nl_inner, kernel, dim, case.eos,
                                           case.riemann, dt, wall=wall,
                                           nl_wall=nl_wall)
            sc = ctx.refresh(sc)
            sc = fd.acoustic_step_2nd_half(sc, nl_inner, kernel, dim,
                                           case.riemann, dt, wall=wall,
                                           nl_wall=nl_wall)
            sc = ctx.refresh(sc)
            return (sc, rt + dt, k + 1)

        comb, relax_t, n_ac = jax.lax.while_loop(
            ac_cond, ac_body,
            (comb, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))
        overflow = nl_inner.overflow | nl_wall_loc.overflow
        return comb, aux, relax_t, n_ac, overflow

    return make_distributed_step(decomp, mesh, physics)


def distribute_dambreak(case, fluid, mesh: Mesh, n_loc: int | None = None):
    n_dev = mesh.devices.size
    decomp = SlabDecomposition(grid=case.grid, n_dev=n_dev,
                               cutoff=case.adaptation.cutoff)
    return distribute(fluid, mesh, decomp, n_loc=n_loc)


def make_halo_taylor_green_step(case, mesh: Mesh, halo_cap: int = 512,
                                migrate_cap: int = 256):
    """Distributed Taylor-Green vortex (periodic ring, viscous + transport
    correction, no walls) through the same API."""
    from sphinxsys_jax.cases.taylor_green_2d import MU_F, RHO0_F, U_F

    n_dev = mesh.devices.size
    decomp = SlabDecomposition(grid=case.grid, n_dev=n_dev,
                               cutoff=case.adaptation.cutoff,
                               periodic=True, halo_cap=halo_cap,
                               migrate_cap=migrate_cap)
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    build_grid = _extended_grid(case.grid, decomp.axis, decomp.cutoff)
    # pair math wraps only the NON-decomposed axis; the decomposed one is
    # materialized by wrapped ghosts
    box = tuple(0.0 if d == decomp.axis else l
                for d, l in enumerate(case.box))

    def physics(ctx: HaloContext, comb, aux):
        table = build_cell_table(comb["Position"], comb["Alive"], build_grid,
                                 cap=case.cell_cap)
        nl_inner = build_neighbor_list(
            comb["Position"], comb["Alive"], comb["Position"], comb["Alive"],
            table, build_grid, decomp.cutoff, k_max=case.k_inner,
            include_self=False)

        accel = 4.0 * h * jnp.linalg.norm(
            comb["Force"][:ctx.n_loc] + comb["ForcePrior"][:ctx.n_loc],
            axis=-1) / comb["Mass"][:ctx.n_loc]
        v2 = jnp.sum(comb["Velocity"][:ctx.n_loc] ** 2, axis=-1)
        red = ctx.pmax(jnp.max(jnp.where(ctx.alive, jnp.maximum(v2, accel), 0.0)))
        speed_sq = jnp.sqrt(red)
        visc_ref = MU_F / RHO0_F / h
        dt_adv = 0.25 * h / (jnp.maximum(jnp.maximum(speed_sq, U_F), visc_ref)
                             + TINY)

        comb = fd.density_summation(comb, nl_inner, kernel, dim, RHO0_F,
                                    sigma0, free_surface=False, box=box)
        # ghost rows only see half a support, so their summed density /
        # volume is garbage — refresh pulls the owners' values before any
        # op consumes V_j
        comb = ctx.refresh(comb)
        comb = fd.viscous_force(comb, nl_inner, kernel, dim, MU_F, h, box=box)
        comb = fd.transport_velocity_correction(comb, nl_inner, kernel, dim,
                                                h, limiter_slope=100.0, box=box)
        comb = ctx.refresh(comb)

        def ac_cond(carry):
            _, rt, _ = carry
            return rt < dt_adv

        def ac_body(carry):
            sc, rt, k = carry
            c_eos = case.eos.sound_speed(sc["Pressure"], sc["Density"])
            speed = jnp.linalg.norm(sc["Velocity"], axis=-1)
            local = jnp.max(jnp.where(sc["Alive"], c_eos + speed, 0.0))
            dt = jnp.minimum(0.6 * h / (ctx.pmax(local) + TINY), dt_adv)
            sc = fd.acoustic_step_1st_half(sc, nl_inner, kernel, dim, case.eos,
                                           case.riemann, dt, box=box)
            sc = ctx.refresh(sc)
            sc = fd.acoustic_step_2nd_half(sc, nl_inner, kernel, dim,
                                           case.no_riemann, dt, box=box)
            sc = ctx.refresh(sc)
            return (sc, rt + dt, k + 1)

        comb, relax_t, n_ac = jax.lax.while_loop(
            ac_cond, ac_body,
            (comb, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))
        # wrap the non-decomposed periodic axes (the single-device case
        # wraps all axes at rebuild; the decomposed axis is wrapped by the
        # migration machinery)
        pos = comb["Position"]
        for d, L in enumerate(case.box):
            if L > 0 and d != decomp.axis:
                lo_d = case.grid.lower[d]
                pos = pos.at[:, d].set(lo_d + jnp.mod(pos[:, d] - lo_d, L))
        comb = dict(comb)
        comb["Position"] = pos
        return comb, aux, relax_t, n_ac, nl_inner.overflow

    return make_distributed_step(decomp, mesh, physics)


def distribute_taylor_green(case, fluid, mesh: Mesh, n_loc: int | None = None):
    n_dev = mesh.devices.size
    decomp = SlabDecomposition(grid=case.grid, n_dev=n_dev,
                               cutoff=case.adaptation.cutoff, periodic=True)
    return distribute(fluid, mesh, decomp, n_loc=n_loc)


SOLID_HALO_FIELDS = ("Position", "Velocity", "InitialPosition",
                     "DeformationGradient", "DeformationRate", "Mass",
                     "VolumetricMeasure", "LinearGradientCorrectionMatrix",
                     "Constrained")


def _beam_decomp(case, n_dev: int, halo_cap: int) -> SlabDecomposition:
    return SlabDecomposition(grid=case.grid, n_dev=n_dev,
                             cutoff=case.adaptation.cutoff,
                             halo_cap=halo_cap, migrate_cap=8,
                             migrate=False, band_coord="InitialPosition",
                             halo_fields=SOLID_HALO_FIELDS)


def make_halo_beam_step(case, mesh: Mesh, halo_cap: int = 256):
    """Distributed total-Lagrangian oscillating beam (VERDICT r2 item 5):
    the third physics family through the one slab-decomposition API.

    The natural decomposition for a total-Lagrangian solid is over the
    REFERENCE configuration: particles never change owners (migrate=False)
    and halo-band membership is static (band_coord="InitialPosition"), so
    the only per-step communication is the halo value refresh.  Each
    device rebuilds its frozen reference pairs from the combined
    local+ghost reference positions — identical every step, so XLA sees a
    static-shape computation.

    Within one elastic step (oscillating_beam.cpp stepping loop):
    stress half-step needs NO mid-step exchange (each ghost's PK1 stress
    is a pure local function of its refreshed carry), one refresh before
    the deformation-rate half-step, and the reference's after-step
    AcousticTimeStep arrives through the replicated `aux` carry.
    """
    from sphinxsys_jax.physics import solid as sd

    n_dev = mesh.devices.size
    decomp = _beam_decomp(case, n_dev, halo_cap)
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    w0 = kernel.w0(dim)
    material = case.material
    c0 = material.sound_speed
    cfl = 0.6

    def physics(ctx: HaloContext, comb, aux):
        dt = aux  # this step's dt = previous step's AcousticTimeStep
        ip = comb["InitialPosition"]
        table = build_cell_table(ip, comb["Alive"], case.grid, cap=32)
        nl = build_neighbor_list(ip, comb["Alive"], ip, comb["Alive"],
                                 table, case.grid, decomp.cutoff,
                                 k_max=64, include_self=False)
        rp = sd.freeze_reference_pairs(ip, nl, kernel, dim)

        comb = sd.integration_1st_half_pk2(comb, rp, material, dt, h, w0)
        comb = sd.fix_constraint(comb, comb["Constrained"] > 0.5)
        comb = ctx.refresh(comb)
        comb = sd.integration_2nd_half(comb, rp, dt)

        # AcousticTimeStep over local rows + global pmin ring reduce
        accel = jnp.linalg.norm(
            (comb["Force"][:ctx.n_loc] + comb["ForcePrior"][:ctx.n_loc])
            / comb["Mass"][:ctx.n_loc, None], axis=-1)
        v = jnp.linalg.norm(comb["Velocity"][:ctx.n_loc], axis=-1)
        per = jnp.minimum(jnp.sqrt(h / (accel + TINY)), h / (c0 + v))
        dt_next = cfl * ctx.pmin(
            jnp.min(jnp.where(ctx.alive, per, jnp.inf)))
        return comb, dt_next, dt_next, jnp.ones((), jnp.int32), nl.overflow

    return make_distributed_step(decomp, mesh, physics)


def distribute_beam(case, solid, mesh: Mesh, halo_cap: int = 256,
                    n_loc: int | None = None):
    """Partition a beam solid state; adds the Constrained channel and the
    dt aux carry (first step dt = 0, as in the single-device case)."""
    n_dev = mesh.devices.size
    decomp = _beam_decomp(case, n_dev, halo_cap)
    state = dict(solid)
    dtype = state["Position"].dtype
    state["Constrained"] = case.base_mask.astype(dtype)
    return distribute(state, mesh, decomp, n_loc=n_loc,
                      aux=jnp.zeros((), dtype))


def _zero_ghost_volume(comb, n_loc: int):
    """Fluid copy whose ghost rows carry V = 0: every fluid->solid force
    term is proportional to dW V_j, so summing per-device contributions
    with ghosts zeroed and psum-ing over the ring counts each fluid-solid
    pair exactly once (on the fluid particle's owner)."""
    out = dict(comb)
    vol = comb["VolumetricMeasure"]
    keep = jnp.arange(vol.shape[0]) < n_loc
    out["VolumetricMeasure"] = jnp.where(keep, vol, 0.0)
    return out


def make_halo_fsi2_step(case, mesh: Mesh, halo_cap: int = 512,
                        migrate_cap: int = 256):
    """Distributed fsi2 (VERDICT r2 item 5): x-periodic fluid slabs +
    a REPLICATED elastic insert.

    The solid is tiny next to the fluid, so the natural decomposition
    replicates it (aux carry) and shards only the fluid: each device
    computes the fluid->solid pressure/viscous forces from its OWN fluid
    rows (ghost volumes zeroed so pairs are counted once) and psums them
    over the ring; the solid sub-cycling then runs identically on every
    device — redundant compute, zero extra communication, and the solid
    state stays bit-identical across the ring (deterministic ops)."""
    from sphinxsys_jax.cases.fsi2 import MU_F, RHO0_F, RHO0_S, U_F
    from sphinxsys_jax.cases import fsi2 as fsi2_mod
    from sphinxsys_jax.physics import fsi
    from sphinxsys_jax.physics import solid as sd

    n_dev = mesh.devices.size
    decomp = SlabDecomposition(
        grid=case.grid_f, n_dev=n_dev, cutoff=case.adaptation.cutoff,
        periodic=True, halo_cap=halo_cap, migrate_cap=migrate_cap,
        halo_fields=("Position", "Velocity", "Density", "DensityChangeRate",
                     "VolumetricMeasure", "Pressure", "Mass", "ForcePrior"))
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    wall, wall_table = case.wall, case.wall_table
    build_grid = _extended_grid(case.grid_f, decomp.axis, decomp.cutoff)
    w0 = kernel.w0(dim)
    c0s = case.material_s.sound_speed

    def physics(ctx: HaloContext, comb, aux):
        solid, n_s_total, t0 = aux
        table = build_cell_table(comb["Position"], comb["Alive"], build_grid,
                                 cap=case.cell_cap)
        nl_ff = build_neighbor_list(
            comb["Position"], comb["Alive"], comb["Position"], comb["Alive"],
            table, build_grid, decomp.cutoff, k_max=case.k_inner,
            include_self=False)
        nl_fw_loc = build_neighbor_list(
            comb["Position"][:ctx.n_loc], ctx.alive, wall["Position"],
            wall["NReal"], wall_table, case.grid_w, decomp.cutoff,
            k_max=case.k_contact, include_self=True)
        nl_fw = _pad_nl(nl_fw_loc, ctx.n_ghost, case.n_wall)
        table_s = build_cell_table(solid["Position"], solid["NReal"],
                                   case.grid_s, cap=case.cell_cap)
        nl_fs = build_neighbor_list(
            comb["Position"], comb["Alive"], solid["Position"],
            solid["NReal"], table_s, case.grid_s, decomp.cutoff,
            k_max=case.k_contact, include_self=True)
        nl_sf = build_neighbor_list(
            solid["Position"], solid["NReal"], comb["Position"],
            comb["Alive"], table, build_grid, decomp.cutoff,
            k_max=case.k_contact, include_self=True)
        walls = [(wall, nl_fw), (solid, nl_fs)]

        # AdvectionViscousTimeStep: local masked reduce + ring pmax
        accel = 4.0 * h * jnp.linalg.norm(
            comb["Force"][:ctx.n_loc] + comb["ForcePrior"][:ctx.n_loc],
            axis=-1) / comb["Mass"][:ctx.n_loc]
        v2 = jnp.sum(comb["Velocity"][:ctx.n_loc] ** 2, axis=-1)
        red = ctx.pmax(jnp.max(jnp.where(ctx.alive,
                                         jnp.maximum(v2, accel), 0.0)))
        visc_ref = MU_F / RHO0_F / h
        dt_adv = 0.25 * h / (jnp.maximum(jnp.maximum(jnp.sqrt(red), U_F),
                                         visc_ref) + TINY)

        comb = fd.density_summation(comb, nl_ff, kernel, dim, RHO0_F, sigma0,
                                    contacts=[(wall, nl_fw, RHO0_F),
                                              (solid, nl_fs, RHO0_S)],
                                    free_surface=False)
        comb = ctx.refresh(comb)
        comb = fd.viscous_force(comb, nl_ff, kernel, dim, MU_F, h,
                                walls=walls)
        comb = fd.transport_velocity_correction(comb, nl_ff, kernel, dim, h,
                                                coefficient=0.25, walls=walls)
        comb = ctx.refresh(comb)

        # per-advection-step solid prep: viscous force from OWNED fluid,
        # psum'd over the ring; then the elastic normal update
        fl0 = _zero_ghost_volume(comb, ctx.n_loc)
        solid = fsi.viscous_force_from_fluid(solid, fl0, nl_sf, kernel, dim,
                                             MU_F, h)
        vf = ctx.psum(solid["ViscousForceFromFluid"])
        solid = dict(solid)
        solid["ForcePrior"] = (solid["ForcePrior"]
                               - solid["ViscousForceFromFluid"] + vf)
        solid["ViscousForceFromFluid"] = vf
        solid["PreviousViscousForceFromFluid"] = vf
        solid = fsi.update_elastic_normal_direction(solid)

        def ac_cond(carry):
            _, _, rt, _, _ = carry
            return rt < dt_adv

        def ac_body(carry):
            sc, so, rt, k_ac, k_s = carry
            c_eos = case.eos.sound_speed(sc["Pressure"], sc["Density"])
            speed = jnp.linalg.norm(sc["Velocity"], axis=-1)
            local = jnp.max(jnp.where(sc["Alive"], c_eos + speed, 0.0))
            dt = jnp.minimum(0.6 * h / (ctx.pmax(local) + TINY), dt_adv)
            walls_now = [(wall, nl_fw), (so, nl_fs)]
            sc = fd.acoustic_step_1st_half(sc, nl_ff, kernel, dim, case.eos,
                                           case.riemann, dt, walls=walls_now)
            sc = ctx.refresh(sc)
            so2 = fsi.pressure_force_from_fluid(
                so, _zero_ghost_volume(sc, ctx.n_loc), nl_sf, kernel, dim,
                case.riemann)
            pf = ctx.psum(so2["PressureForceFromFluid"])
            so = dict(so)
            so["ForcePrior"] = so["ForcePrior"] + pf - so.get(
                "PreviousPressureForceFromFluid", jnp.zeros_like(pf))
            so["PressureForceFromFluid"] = pf
            so["PreviousPressureForceFromFluid"] = pf
            sc = fd.acoustic_step_2nd_half(sc, nl_ff, kernel, dim,
                                           case.no_riemann, dt,
                                           walls=walls_now)
            sc = fsi2_mod.inflow_velocity(sc, t0 + rt + dt, case.dl_sponge)
            sc = ctx.refresh(sc)

            so = fsi.initialize_displacement(so)

            def s_cond(s_carry):
                _, ds_sum, _ = s_carry
                return ds_sum < dt

            def s_body(s_carry):
                so_i, ds_sum, k = s_carry
                dt_s = jnp.minimum(sd.solid_acoustic_time_step(so_i, c0s, h),
                                   dt - ds_sum)
                so_i = sd.integration_1st_half_pk2(so_i, case.rp,
                                                   case.material_s, dt_s, h,
                                                   w0)
                so_i = sd.fix_constraint(so_i, case.base_mask)
                so_i = sd.integration_2nd_half(so_i, case.rp, dt_s)
                return (so_i, ds_sum + dt_s, k + 1)

            so, _, k_sub = jax.lax.while_loop(
                s_cond, s_body,
                (so, jnp.zeros_like(dt), jnp.zeros((), jnp.int32)))
            so = fsi.update_average_velocity_acceleration(so, dt)
            return (sc, so, rt + dt, k_ac + 1, k_s + k_sub)

        comb, solid, relax_t, n_ac, n_s_steps = jax.lax.while_loop(
            ac_cond, ac_body,
            (comb, solid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32)))

        overflow = (nl_ff.overflow | nl_fw_loc.overflow | nl_fs.overflow
                    | nl_sf.overflow)
        return (comb, (solid, n_s_total + n_s_steps, t0 + relax_t), relax_t,
                n_ac, overflow)

    return make_distributed_step(decomp, mesh, physics)


def distribute_fsi2(case, fluid, solid, mesh: Mesh, n_loc: int | None = None):
    """Shard the fsi2 fluid into periodic x-slabs; the solid rides the
    replicated aux carry."""
    n_dev = mesh.devices.size
    decomp = SlabDecomposition(grid=case.grid_f, n_dev=n_dev,
                               cutoff=case.adaptation.cutoff, periodic=True)
    dtype = fluid["Position"].dtype
    return distribute(fluid, mesh, decomp, n_loc=n_loc,
                      aux=(dict(solid), jnp.zeros((), jnp.int32),
                           jnp.zeros((), dtype)))
