"""Muscle-solid contact: soft body compressed by a rigid sliding plate.

Counterpart of /root/reference/tests/3d_examples/test_3d_muscle_solid_contact/
muscle_solid_contact.cpp: a NeoHookean cube (L = 0.04, dx = L/12,
rho = 1265, E = 5e4, nu = 0.45) backed by a fixed holder plate, compressed
by a RIGID moving plate carried by a 1-DOF x-slider (Simbody
MobilizedBody::Slider) under gravity g_x = -100 with a linear mobility
damper c = 20; the plate's motion is driven by the solid-solid contact
force (TotalForceOnBodyPartForSimBody), closing the deformable <-> rigid
loop.  The deformable side runs PK2 stress relaxation + pairwise velocity
damping (physical_viscosity = 200, DampingWithRandomChoice ratio 0.1 —
run every step at eta/ratio, the convention calibrated on roof_3d).

Contact = the reference's solid-solid ContactFactorSummation +
ContactForce pair (physics/contact.py), evaluated both ways each step;
neighbor lists rebuild every step (the plate moves).

DB quantity: MyocardiumBody TotalKineticEnergy (DTW,
regression_test_tool/), written on the reference's ite%100 cadence.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import (NeoHookeanSolid,
                                          SaintVenantKirchhoffSolid)
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import contact as ct
from sphinxsys_jax.physics import dissipation as dpp
from sphinxsys_jax.physics import solid as sd

L = 0.04
PL = 0.1
DX = L / 12.0
BW = 4 * DX
RHO0 = 1265.0
POISSON = 0.45
YOUNGS = 5.0e4
PHYSICAL_VISCOSITY = 200.0
DAMPING_RATIO = 0.1
GRAVITY_X = -100.0
DAMPER_C = 20.0
END_TIME = 0.1


class MuscleSim(NamedTuple):
    myo: Any
    plate: Any
    q: jnp.ndarray      # slider coordinate (plate x-offset)
    u: jnp.ndarray      # slider velocity
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class MuscleCase:
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    material_p: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl_inner: Any
    holder_mask: Any
    grid: Any
    n_myo: int
    n_plate: int
    plate_mass: float
    cell_cap: int = 40
    k_contact: int = 48

    @property
    def kernel(self):
        return self.adaptation.kernel


def _lattice_box(lo, hi, dx):
    axes = [np.arange(l + dx / 2, h, dx) for l, h in zip(lo, hi)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def build_case(dx: float = DX, dtype=jnp.float64, k_inner: int = 96,
               cell_cap: int = 40, k_contact: int = 48):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)
    material_p = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)

    # myocardium = cube [0,L]^3 centered on y,z + stationary holder plate
    # x in [-BW, 0] (muscle_solid_contact.cpp:16-20)
    cube = _lattice_box((0.0, -0.5 * L, -0.5 * L), (L, 0.5 * L, 0.5 * L), dx)
    holder = _lattice_box((-BW, -0.5 * L - BW, -0.5 * L - BW),
                          (0.0, 0.5 * L + BW, 0.5 * L + BW), dx)
    pos_m = np.concatenate([cube, holder])
    holder_mask = jnp.asarray(
        np.concatenate([np.zeros(len(cube), bool), np.ones(len(holder), bool)]))

    # moving plate: x in [L+BW/2, L+1.5BW], y/z in [-PL/2, PL/2]
    pos_p = _lattice_box((L + 0.5 * BW, -0.5 * PL, -0.5 * PL),
                         (L + 1.5 * BW, 0.5 * PL, 0.5 * PL), dx)

    vol = dx ** 3
    myo = dict(sd.make_elastic_solid_state(pos_m, vol, material, dtype=dtype))
    plate = dict(sd.make_elastic_solid_state(pos_p, vol, material_p,
                                             dtype=dtype))
    plate["AverageVelocity"] = jnp.zeros_like(plate["Velocity"])
    # pre-seed the force-prior registry keys so the while_loop carry is
    # structure-stable (force_prior_update adds them on first call)
    for b in (myo, plate):
        b["RepulsionForce"] = jnp.zeros_like(b["Velocity"])
        b["PreviousRepulsionForce"] = jnp.zeros_like(b["Velocity"])

    dom_lo = (-2 * BW, -0.6 * PL, -0.6 * PL)
    dom_hi = (2.0 * L + 3 * BW, 0.6 * PL, 0.6 * PL)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)

    table = build_cell_table(myo["Position"], myo["NReal"], grid,
                             cap=cell_cap)
    nl = build_neighbor_list(myo["Position"], myo["NReal"], myo["Position"],
                             myo["NReal"], table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    assert not bool(nl.overflow), "raise k_inner"
    rp = sd.freeze_reference_pairs(myo["Position"], nl, adaptation.kernel, 3)
    myo["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, myo["VolumetricMeasure"])

    case = MuscleCase(adaptation=adaptation, material=material,
                      material_p=material_p, rp=rp, nl_inner=nl,
                      holder_mask=holder_mask, grid=grid, n_myo=len(pos_m),
                      n_plate=len(pos_p), plate_mass=RHO0 * vol * len(pos_p),
                      cell_cap=cell_cap, k_contact=k_contact)
    dt0 = jnp.asarray(1.0e-6, dtype)
    sim = MuscleSim(myo=myo, plate=plate, q=jnp.zeros((), dtype),
                    u=jnp.zeros((), dtype), time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32), dt=dt0,
                    overflow=jnp.zeros((), bool))
    return case, sim


def _contact_nl(case, pos_q, n_q, pos_t, n_t):
    table = build_cell_table(pos_t, n_t, case.grid, cap=case.cell_cap)
    return build_neighbor_list(pos_q, n_q, pos_t, n_t, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_contact,
                               include_self=True)


def _step(case: MuscleCase, s: MuscleSim) -> MuscleSim:
    kernel, dim = case.kernel, 3
    h = case.adaptation.h
    myo, plate = dict(s.myo), dict(s.plate)
    dt = s.dt

    # contact both ways (ContactFactorSummation + ContactForce)
    nl_mp = _contact_nl(case, myo["Position"], myo["NReal"],
                        plate["Position"], plate["NReal"])
    nl_pm = _contact_nl(case, plate["Position"], plate["NReal"],
                        myo["Position"], myo["NReal"])
    ovf = nl_mp.overflow | nl_pm.overflow

    fac_m = ct.repulsion_factor_contact(myo, plate, nl_mp, kernel, dim)
    fac_p = ct.repulsion_factor_contact(plate, myo, nl_pm, kernel, dim)
    myo = ct.repulsion_force_contact(myo, plate, nl_mp, kernel, dim,
                                     fac_m, fac_p,
                                     ct.contact_stiffness(case.material))
    plate = ct.repulsion_force_contact(plate, myo, nl_pm, kernel, dim,
                                       fac_p, fac_m,
                                       ct.contact_stiffness(case.material_p))

    # slider dynamics (Slider mobilizer + UniformGravity + MobilityLinearDamper)
    f_x = jnp.sum(plate["RepulsionForce"][:, 0])
    m = case.plate_mass
    acc = f_x / m + GRAVITY_X - DAMPER_C * s.u / m
    u_new = s.u + acc * dt
    q_new = s.q + u_new * dt
    plate["Position"] = plate["Position"].at[:, 0].add(u_new * dt)
    plate["Velocity"] = jnp.zeros_like(plate["Velocity"]).at[:, 0].set(u_new)

    # stress relaxation + holder constraint + pairwise damping
    w0 = kernel.w0(dim)
    myo = sd.integration_1st_half_pk2(myo, case.rp, case.material, dt, h, w0)
    myo = sd.fix_constraint(myo, case.holder_mask)
    myo = dpp.damping_pairwise(myo, "Velocity", case.nl_inner, kernel, dim,
                               PHYSICAL_VISCOSITY / DAMPING_RATIO, dt)
    myo = sd.fix_constraint(myo, case.holder_mask)
    myo = sd.integration_2nd_half(myo, case.rp, dt)

    dt_next = sd.solid_acoustic_time_step(myo, case.material.sound_speed, h)
    return MuscleSim(myo=myo, plate=plate, q=q_new, u=u_new,
                     time=s.time + dt, n_steps=s.n_steps + 1, dt=dt_next,
                     overflow=s.overflow | ovf)


def make_run_chunk(case: MuscleCase):
    @jax.jit
    def run_chunk(s: MuscleSim, t_target) -> MuscleSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def kinetic_energy(s: MuscleSim) -> float:
    """MyocardiumBody TotalKineticEnergy (the DTW-regressed quantity)."""
    m = s.myo
    ke = 0.5 * m["Mass"] * jnp.sum(m["Velocity"] ** 2, axis=-1)
    return float(jnp.sum(ke))
