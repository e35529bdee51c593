"""2D plane-strain necking of a notched steel bar (quasi-static stretch).

Counterpart of /root/reference/tests/2d_examples/test_2d_stretching/
stretching.cpp: a NonLinearHardeningPlasticSolid bar (PL x PH with a 1%-PH
necking notch at mid-span, stretching.cpp:60-66) is pulled apart by two
BW-wide end bands whose positions are shifted +-0.5e-4 * Dt per macro step
(Left/RightStretchSolidBodyRegion, stretching.cpp:96-122), with vel_x
pinned to zero in the bands (ConstrainXVelocity, stretching.cpp:148-164).
Each macro step recomputes F by summation, then relaxes acoustically with
DecomposedPlasticIntegration1stHalf + pairwise damping until the kinetic
energy falls under 0.005 * refer_energy (the reference's gated inner loop,
stretching.cpp:317-326) or the Dt window is consumed.

Material: rho=7850, G=80.1938e9, K=164.21e9 (-> E, nu via the standard
relations), yield 0.45e9, hardening 1.2924e8, saturation 7.15e8 /
exponent 16.93 (stretching.cpp:25-36) — the Simo necking benchmark
(doi.org/10.1016/j.cma.2013.09.024).

Oracles used by tests/test_stretching.py: the bar is elastic below the
yield strain (kappa stays 0), flows plastically beyond it with the neck
section's von Mises Kirchhoff stress pinned at the current flow stress
(radial-return consistency, checked through the independently
reconstructed stress), and the notch carries more accumulated plastic
strain than the quarter-span sections (localization).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import NonLinearHardeningPlasticSolid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import solid as sd

PL = 0.05334               # bar length (stretching.cpp:14)
PH = 0.012826              # bar height
RHO0 = 7850.0
SHEAR_MODULUS = 80.1938e9  # stretching.cpp:26-27
BULK_MODULUS = 164.21e9
POISSON = ((3.0 * BULK_MODULUS - 2.0 * SHEAR_MODULUS)
           / (6.0 * BULK_MODULUS + 2.0 * SHEAR_MODULUS))
YOUNGS = (9.0 * SHEAR_MODULUS * BULK_MODULUS
          / (3.0 * BULK_MODULUS + SHEAR_MODULUS))
YIELD_STRESS = 0.45e9
HARDENING_MODULUS = 1.2924e8
SATURATION_FLOW = 7.15e8
SATURATION_EXP = 16.93
PHYSICAL_VISCOSITY = 1.0e4
REFER_ENERGY = 0.5 * 8000 * 0.01        # stretching.cpp:38
PULL_RATE = 0.5e-4                      # m/s shift of each end band
DT_MACRO = 100.0 / 10000.0              # Dt (stretching.cpp:293)
KE_GATE = 0.005                         # stretching.cpp:320


class SimState(NamedTuple):
    bar: Any
    time: jnp.ndarray
    n_macro: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class StretchingCase:
    dx: float
    adaptation: SPHAdaptation
    material: NonLinearHardeningPlasticSolid
    rp: sd.ReferencePairs
    nl_inner: Any
    left_mask: jnp.ndarray
    right_mask: jnp.ndarray
    n_bar: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _bar_shape(bw: float):
    """Beam polygon + end bands (stretching.cpp:56-83): top/bottom edges
    dip by 1% of PH at mid-span to seed the neck."""
    notch = 0.01 * PH
    beam = [(0.0, -PH / 2), (0.0, PH / 2),
            (PL / 2.0, PH / 2 - notch),
            (PL, PH / 2), (PL, -PH / 2),
            (PL / 2.0, -PH / 2 + notch)]
    left = [(-bw, -PH / 2), (-bw, PH / 2), (0.0, PH / 2), (0.0, -PH / 2)]
    right = [(PL, -PH / 2), (PL, PH / 2), (PL + bw, PH / 2),
             (PL + bw, -PH / 2)]
    return G.make_multi_polygon(("add", beam), ("add", left), ("add", right))


def build_case(dx: float = PH / 15, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 40):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = NonLinearHardeningPlasticSolid(
        rho0=RHO0, youngs_modulus=YOUNGS, poisson_ratio=POISSON,
        yield_stress=YIELD_STRESS, hardening_modulus=HARDENING_MODULUS,
        saturation_flow_stress=SATURATION_FLOW,
        saturation_exponent=SATURATION_EXP)
    bw = 4 * dx
    shape = _bar_shape(bw)
    lo, hi = (-bw - 2 * dx, -PH / 2 - 2 * dx), (PL + bw + 2 * dx, PH / 2 + 2 * dx)
    pos, vol = generate_lattice(shape, lo, hi, dx)

    bar = dict(sd.make_elastic_solid_state(pos, vol, material, dtype=dtype))
    n = len(pos)
    inv_ps, kappa = material.initial_plastic_state(n, 2, dtype)
    bar["InversePlasticStrain"] = inv_ps
    bar["HardeningParameter"] = kappa

    x = np.asarray(pos)[:, 0]
    left_mask = jnp.asarray(x < 0.0)
    right_mask = jnp.asarray(x > PL)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        bar["Position"], bar["NReal"])
    nl = jax.jit(partial(build_neighbor_list, grid=grid,
                         cutoff=adaptation.cutoff, k_max=k_inner,
                         include_self=False))(
        bar["Position"], bar["NReal"], bar["Position"], bar["NReal"], table)
    assert not bool(nl.overflow), "raise k_inner: frozen pairs must be exact"
    rp = sd.freeze_reference_pairs(bar["Position"], nl, adaptation.kernel, 2)
    bar["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, bar["VolumetricMeasure"])

    case = StretchingCase(dx=dx, adaptation=adaptation, material=material,
                          rp=rp, nl_inner=nl, left_mask=left_mask,
                          right_mask=right_mask, n_bar=n)
    return case, bar


def init_sim(case: StretchingCase, bar: State) -> SimState:
    dtype = bar["Position"].dtype
    return SimState(bar=bar, time=jnp.zeros((), dtype),
                    n_macro=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _constrain_x(case: StretchingCase, bar: State) -> State:
    """ConstrainXVelocity (stretching.cpp:148-164): vel_x = 0 in both
    end bands."""
    out = dict(bar)
    band = case.left_mask | case.right_mask
    vel = bar["Velocity"]
    out["Velocity"] = vel.at[:, 0].set(jnp.where(band, 0.0, vel[:, 0]))
    return out


def _macro_step(case: StretchingCase, s: SimState) -> SimState:
    """One Dt window: shift the end bands, recompute F by summation, relax
    acoustically until the KE gate closes (stretching.cpp:304-352)."""
    bar = dict(s.bar)
    kernel = case.kernel
    shift = PULL_RATE * DT_MACRO
    pos = bar["Position"]
    dxs = jnp.where(case.left_mask, -shift, 0.0) + \
        jnp.where(case.right_mask, shift, 0.0)
    bar["Position"] = pos.at[:, 0].add(dxs)
    bar = sd.deformation_gradient_by_summation(bar, case.rp)

    def cond(carry):
        b, rel, ke_norm = carry
        return (rel < DT_MACRO) & (ke_norm > KE_GATE)

    def body(carry):
        b, rel, _ = carry
        dt = sd.solid_acoustic_time_step(b, case.material.sound_speed,
                                         case.adaptation.h)
        b = sd.decomposed_plastic_integration_1st_half(
            b, case.rp, case.material, dt, case.adaptation.h)
        b = _constrain_x(case, b)
        b = dp.damping_pairwise(b, "Velocity", case.nl_inner, kernel, 2,
                                PHYSICAL_VISCOSITY, DT_MACRO)
        b = _constrain_x(case, b)
        b = sd.integration_2nd_half(b, case.rp, dt)
        ke = 0.5 * jnp.sum(b["Mass"] * jnp.sum(b["Velocity"] ** 2, axis=1))
        return b, rel + dt, ke / REFER_ENERGY

    bar, _, _ = jax.lax.while_loop(
        cond, body, (bar, jnp.zeros((), pos.dtype),
                     jnp.full((), 1.0e4, pos.dtype)))
    bad = ~jnp.all(jnp.isfinite(bar["Position"]))
    return SimState(bar=bar, time=s.time + DT_MACRO, n_macro=s.n_macro + 1,
                    overflow=s.overflow | bad)


def make_run_chunk(case: StretchingCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _macro_step(case, st), s)

    return run_chunk


def von_mises_kirchhoff(case: StretchingCase, bar: State):
    """Von Mises equivalent of the deviatoric Kirchhoff stress the radial
    return works with: |G (be - tr(be)/d I)| * sqrt(3/2)."""
    m = case.material
    nbe, _, _ = m.elastic_left_cauchy(bar["DeformationGradient"],
                                      bar["InversePlasticStrain"],
                                      bar["HardeningParameter"])
    dim = nbe.shape[-1]
    iso = jnp.trace(nbe, axis1=-2, axis2=-1) / dim
    dev = m.shear_modulus * (nbe - iso[..., None, None]
                             * jnp.eye(dim, dtype=nbe.dtype))
    return jnp.sqrt(1.5 * jnp.sum(dev * dev, axis=(-2, -1)))


def run(end_time: float = 10.0, dx: float = PH / 15, chunk: float = 1.0):
    case, bar = build_case(dx=dx)
    s = init_sim(case, bar)
    run_chunk = make_run_chunk(case)
    t = 0.0
    while t < end_time - 1e-9:
        t = min(t + chunk, end_time)
        s = run_chunk(s, jnp.asarray(t, bar["Position"].dtype))
    return case, s
