"""Purkinje-network-driven left-ventricle electro-contraction (3D).

Counterpart of tests/3d_examples/test_3d_pkj_lv_electrocontraction/
pkj_lv_electrocontraction.cpp: a Purkinje TREE grown over the LV inner
surface conducts the excitation fast (ElectroPhysiologyDiffusionNetworkRK2
on the TreeInnerRelation, cpp:173), its terminal leaves stimulate the
myocardium, the monodomain Aliev-Panfilov reaction-diffusion propagates
the wave through the muscle, and the resulting active contraction stress
Ta drives the total-Lagrangian muscle mechanics (cpp:186-200).

Deviations from the reference, for a self-contained procedural setup:
  * LV geometry: ellipsoid shell (outer (1, 1, 1.5), inner (0.7, 0.7,
    1.25), base cut z > 0.55) instead of the STL heart model;
  * one particle set for physiology + mechanics (the reference couples two
    same-geometry bodies by kernel interpolation);
  * rule-based circumferential fibers f = normalize(-y, x, 0).

Oracle: the apex lies ~2.4 units of tissue path from the base.  Pure
tissue diffusion (D = 0.1) covers sqrt(D t) ~ 0.8 by t = 6 — the apex can
only activate that early through the fast network (D_pkj = 2), and once
the wave passes, Ta contracts the wall: the mid-wall ring radius
shrinks measurably.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.network import generate_network
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.neighbors.neighbor_list import NeighborList
from sphinxsys_jax.physics import bar as bd
from sphinxsys_jax.physics import diffusion as df
from sphinxsys_jax.physics import solid as sd

OUTER = (1.0, 1.0, 1.5)
INNER = (0.7, 0.7, 1.25)
Z_CUT = 0.55                 # base opening
RHO0 = 1.0
YOUNGS = 50.0
POISSON = 0.45
D_MYO = 0.05
D_PKJ = 0.5     # cable-equation balance: wavefront width sqrt(D/k) ~ 2
                # segments propagates; larger D dilutes the pulse below the
                # ignition threshold on the small tree
STIM_T = 0.5    # hold the root stimulus until the tree ignites
K_A = 0.3                    # excitation-contraction gain
SEG = 0.12                   # Purkinje segment length


class Sim(NamedTuple):
    myo: Any                 # myocardium state (voltage + mechanics)
    pkj_v: Any               # tree voltages
    pkj_w: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt_s: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class PkjLVCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl_myo: Any
    nl_pkj: NeighborList
    pkj_pos: Any
    line_kernel: Any
    base_mask: Any
    leaf_nearest: Any        # (n_myo,) nearest leaf index into pkj arrays
    leaf_mask: Any           # (n_myo,) within coupling radius of a leaf
    model_myo: df.AlievPanfilowModel
    model_pkj: df.AlievPanfilowModel
    n_myo: int
    n_pkj: int
    dt_d: float
    n_pkj_sub: int
    n_mech_sub: int

    def __hash__(self):
        return hash((self.n_myo, self.n_pkj))

    def __eq__(self, other):
        return self is other


def build_case(dx: float = 0.12, dtype=jnp.float32, k_inner: int = 72,
               seed: int = 3):
    shell = G.make_complex(
        ("add", G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=OUTER)),
        ("sub", G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=INNER)),
        # subtract the region ABOVE the base cut (HalfSpace "inside" is
        # where sd < 0, i.e. the side the outward normal points AWAY from)
        ("sub", G.HalfSpace(point=(0.0, 0.0, Z_CUT),
                            outward_normal=(0.0, 0.0, -1.0))))
    lo = (-1.1, -1.1, -1.6)
    hi = (1.1, 1.1, 0.7)
    pos, vol = generate_lattice(shell, lo, hi, dx)
    n = len(pos)

    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    myo = dict(sd.make_elastic_solid_state(pos, vol, material, dtype=dtype))

    adaptation = SPHAdaptation(spacing=dx, dim=3)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = build_cell_table(myo["Position"], jnp.int32(n), grid, cap=40)
    nl = build_neighbor_list(myo["Position"], jnp.int32(n), myo["Position"],
                             jnp.int32(n), table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    assert not bool(nl.overflow)
    rp = sd.freeze_reference_pairs(myo["Position"], nl, adaptation.kernel, 3)
    myo["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, myo["VolumetricMeasure"])

    # circumferential fibers
    p = np.asarray(pos)
    fib = np.stack([-p[:, 1], p[:, 0], np.zeros(n)], -1)
    fib /= np.linalg.norm(fib, axis=1, keepdims=True) + 1e-12
    myo["Fiber"] = jnp.asarray(fib, dtype)

    # physiology species
    for name in ("Voltage", "GateVariable", "ActiveContractionStress"):
        myo[name] = jnp.zeros((n,), dtype)

    base_mask = jnp.asarray(p[:, 2] > Z_CUT - 1.2 * dx)

    # --- Purkinje tree on the inner surface ---------------------------
    inner = G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=INNER)
    start = np.asarray([0.0, -INNER[1], 0.0])
    start = start / np.linalg.norm(start / np.asarray(INNER))  # ~on surface
    net = generate_network(inner, starting_point=(0.0, -0.699, 0.35),
                           second_point=(0.0, -0.69, 0.25), iterations=5,
                           segment_length=SEG, segments_per_branch=4,
                           angle=0.4, repulsivity=0.3, seed=seed)
    n_pkj = net.n_particles
    adj = net.adjacency(k_max=4)
    nl_pkj = NeighborList(idx=jnp.asarray(adj, jnp.int32),
                          count=jnp.asarray((adj < n_pkj).sum(1), jnp.int32),
                          overflow=jnp.zeros((), bool))
    pkj_pos = jnp.asarray(net.positions, dtype)
    lk = bd.LineKernel(SPHAdaptation(spacing=SEG, dim=3).kernel)

    # leaves = last particle of each terminal branch
    leaf_ids = [b.particles[-1] for b in net.branches
                if not b.children and b.particles]
    leaves = net.positions[leaf_ids]
    d2 = np.linalg.norm(p[:, None, :] - leaves[None], axis=-1)
    nearest = np.argmin(d2, axis=1)
    leaf_mask = d2[np.arange(n), nearest] < 2.0 * dx
    leaf_nearest = np.asarray(leaf_ids)[nearest]

    model = df.AlievPanfilowModel(k_a=K_A)
    model_pkj = df.AlievPanfilowModel()      # no contraction on the tree

    h = adaptation.h
    dt_d = 0.5 * h * h / D_MYO / 3.0
    # the SPH line-diffusion operator's effective eigenvalue exceeds the
    # nominal D by the kernel-discretization factor — 8x safety margin
    dt_pkj = 0.5 * SEG * SEG / D_PKJ / 8.0
    n_pkj_sub = max(1, int(np.ceil(dt_d / dt_pkj)))
    c0 = material.sound_speed
    dt_s = 0.5 * h / c0
    n_mech_sub = max(1, int(np.ceil(dt_d / dt_s)))

    case = PkjLVCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                     nl_myo=nl, nl_pkj=nl_pkj, pkj_pos=pkj_pos,
                     line_kernel=lk, base_mask=base_mask,
                     leaf_nearest=jnp.asarray(leaf_nearest, jnp.int32),
                     leaf_mask=jnp.asarray(leaf_mask),
                     model_myo=model, model_pkj=model_pkj, n_myo=n,
                     n_pkj=n_pkj, dt_d=float(dt_d), n_pkj_sub=n_pkj_sub,
                     n_mech_sub=n_mech_sub)

    pkj_v = jnp.zeros((n_pkj,), dtype)
    # stimulus at the tree root (the bundle entry), cpp applies it to the
    # first segments at t=0
    pkj_v = pkj_v.at[:3].set(0.92)
    pkj_w = jnp.zeros((n_pkj,), dtype)
    sim = Sim(myo=myo, pkj_v=pkj_v, pkj_w=pkj_w,
              time=jnp.zeros((), dtype), n_steps=jnp.zeros((), jnp.int32),
              dt_s=jnp.asarray(dt_s, dtype))
    return case, sim


def _pkj_state(case, v, w):
    n = case.n_pkj
    return {"Position": case.pkj_pos, "Voltage": v, "GateVariable": w,
            "VolumetricMeasure": jnp.full((n,), SEG, v.dtype),
            "NReal": jnp.asarray(n, jnp.int32)}


def _step(case: PkjLVCase, s: Sim) -> Sim:
    dt = jnp.asarray(case.dt_d, s.time.dtype)
    # 1. fast conduction along the Purkinje tree (NetworkRK2, cpp:173);
    #    LineKernel reduces the 3D kernel twice internally (call dim=3)
    pk0 = _pkj_state(case, s.pkj_v, s.pkj_w)

    def pkj_sub(_, pk):
        pk = df.electrophysiology_step(
            pk, case.nl_pkj, case.line_kernel, 3,
            df.IsotropicDiffusion(D_PKJ), case.model_pkj,
            dt / case.n_pkj_sub)
        # hold the root stimulus during ignition
        v = pk["Voltage"]
        v = jnp.where((jnp.arange(v.shape[0]) < 3) & (s.time < STIM_T),
                      jnp.maximum(v, 0.92), v)
        return dict(pk, Voltage=v)

    pk = jax.lax.fori_loop(0, case.n_pkj_sub, pkj_sub, pk0)
    myo = dict(s.myo)
    # 2. leaves stimulate the myocardium
    leaf_v = pk["Voltage"][case.leaf_nearest]
    myo["Voltage"] = jnp.where(case.leaf_mask & (leaf_v > myo["Voltage"]),
                               leaf_v, myo["Voltage"])
    # 3. monodomain reaction-diffusion + Ta on the muscle
    myo = df.electrophysiology_step(
        myo, case.nl_myo, case.adaptation.kernel, 3,
        df.IsotropicDiffusion(D_MYO), case.model_myo, dt)
    # 4. mechanics subloop with the active fiber stress
    active = sd.active_fiber_stress()
    h = case.adaptation.h
    w0 = case.adaptation.kernel.w0(3)
    dt_s = dt / case.n_mech_sub

    def mech_sub(_, m):
        m = sd.integration_1st_half_pk2(m, case.rp, case.material, dt_s,
                                        h, w0, active_stress_fn=active)
        m = sd.fix_constraint(m, case.base_mask)
        return sd.integration_2nd_half(m, case.rp, dt_s)

    myo = jax.lax.fori_loop(0, case.n_mech_sub, mech_sub, myo)
    return Sim(myo=myo, pkj_v=pk["Voltage"], pkj_w=pk["GateVariable"],
               time=s.time + dt, n_steps=s.n_steps + 1, dt_s=s.dt_s)


def make_run_chunk(case: PkjLVCase):
    @jax.jit
    def run_chunk(s: Sim, t_target) -> Sim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def apex_voltage(case: PkjLVCase, s: Sim) -> float:
    p0 = np.asarray(s.myo["InitialPosition"])
    apex = int(np.argmin(p0[:, 2]))
    return float(s.myo["Voltage"][apex])


def midwall_ring_radius(case: PkjLVCase, s: Sim) -> float:
    """Mean radial distance of the mid-height wall ring (contraction
    observable)."""
    p0 = np.asarray(s.myo["InitialPosition"])
    ring = np.abs(p0[:, 2] + 0.2) < 0.15
    p = np.asarray(s.myo["Position"])[ring]
    return float(np.linalg.norm(p[:, :2], axis=1).mean())
