"""Lattice-stencil total-Lagrangian solid dynamics — the fast path
for solids.

The reference's device (CK) solid stack
(/root/reference/src/shared/shared_ck/particle_dynamics/solid_dynamics/
structure_dynamics.h:1-120) ports the gather-based pair sweeps to SYCL.
The XLA-native observation is stronger: total-Lagrangian pair topology is
FROZEN on the initial configuration, and every solid body in the
reference's example suite is generated on a regular dx lattice (possibly
shape-masked).  On a lattice initial configuration the frozen pair data
(e0_ij, dW0_ij, r0_ij, W0_ij) is a PER-OFFSET CONSTANT — the same for
every particle — so the pair sweep collapses into a ~80-tap stencil:

    force_i = (m_i/rho0) sum_o dW0_o V0 [ (S_i + S_{i+o}) e_o + ... ]

where the j-side "gather" is a static array slice (no index tensors, no
scatter, no neighbor lists).  Every slot-pair is a real pair (100% VPU
utilization vs ~10-30% for dense cell-block windows), kernel values are
trace-time Python constants, and XLA fuses each offset's slice+FMA chain
without materializing temporaries.

State layout: per-particle fields live on the FULL bounding lattice,
shape (nx, ny, nz[, ch...]) with a `valid` mask for shape-masked sites
(vol=0 semantics: invalid j-sites contribute nothing, matching frozen
pairs built only between in-shape particles).  The last axis rides the
VPU lanes; offset taps along it are lane shifts.

Physics identical to physics/solid.py (reference elastic_dynamics.cpp):
  integration_1st_half_pk2 / decomposed_integration_1st_half /
  integration_2nd_half — validated pairwise-equal in
  tests/test_solid_lattice.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

TINY = 1.0e-15


def lattice_offsets(kernel, dx: float, dim: int):
    """All nonzero integer offsets o with |o| dx < cutoff (= the frozen
    neighbor set of an interior lattice particle), plus their constant
    pair data.  Returns a list of (offset_tuple, r0, e0, W0, dW0)."""
    cutoff = kernel.cutoff if hasattr(kernel, "cutoff") else 2.0 * kernel.h
    m = int(np.floor(cutoff / dx - 1e-9))
    taps = []
    rng = range(-m, m + 1)
    for ox in rng:
        for oy in rng:
            oz_range = rng if dim == 3 else (0,)
            for oz in oz_range:
                if ox == 0 and oy == 0 and oz == 0:
                    continue
                r = dx * float(np.sqrt(ox * ox + oy * oy + oz * oz))
                if r >= cutoff - 1e-12 * dx:
                    continue
                o = (ox, oy, oz)[:dim]
                e = np.asarray(o, np.float64) * dx / r   # unit i -> ... j->i is -o/|o|
                taps.append((o, r, e))
    out = []
    for o, r, e in taps:
        rj = jnp.asarray(r)
        W0 = float(kernel.W(rj, dim))
        dW0 = float(kernel.dW(rj, dim))
        out.append((o, r, e, W0, dW0))
    return out


@dataclasses.dataclass(frozen=True)
class LatticeSolid:
    """Static description of a lattice-embedded TL solid body.

    `shape` is the lattice extent (nx, ny[, nz]); per-particle fields are
    stored flat (N, ...) in C-order of the lattice (N = prod(shape)) so
    the existing physics/solid.py state dicts work unchanged — the
    stencil ops reshape internally."""

    shape: tuple          # lattice dims
    dx: float
    dim: int
    taps: tuple           # ((offset, r0, e0(np), W0, dW0), ...)
    w0: float             # kernel W(0)

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))


def make_lattice(kernel, dx: float, shape, dim: int | None = None):
    dim = dim or len(shape)
    taps = tuple(lattice_offsets(kernel, dx, dim))
    w0 = float(kernel.W(jnp.asarray(0.0), dim))
    return LatticeSolid(shape=tuple(shape), dx=dx, dim=dim, taps=taps, w0=w0)


def _grids(lat: LatticeSolid, *arrs):
    """Flat (N, ...) -> lattice (nx, ny[, nz], ...) views."""
    return [a.reshape(lat.shape + a.shape[1:]) for a in arrs]


def _sanitize(valid, *arrs):
    """Zero out invalid rows BEFORE tapping: invalid sites may carry NaN
    (e.g. the 0/0 determinant weighting of a neighbor-less B matrix), and
    NaN * 0-mask still poisons the stencil sum."""
    out = []
    for a in arrs:
        v = valid.reshape(valid.shape + (1,) * (a.ndim - valid.ndim))
        out.append(jnp.where(v, a, 0.0))
    return out


def _tap(arr, o, pad_value=0.0):
    """j-side value at lattice offset +o of every site: a shifted view
    with out-of-bounds sites filled with `pad_value`.  arr has lattice
    dims leading; trailing channel dims pass through.  (Reference
    semantics; the fast path pre-pads once — see _pad_once/_tap_p.)"""
    d = len(o)
    pads = []
    slices = []
    for k in range(d):
        ok = o[k]
        n = arr.shape[k]
        pads.append((max(0, -ok), max(0, ok)))
        slices.append(slice(max(0, ok), max(0, ok) + n))
    pads += [(0, 0)] * (arr.ndim - d)
    slices += [slice(None)] * (arr.ndim - d)
    return jnp.pad(arr, pads, constant_values=pad_value)[tuple(slices)]


def _pad_once(arr, m: int, d: int):
    """Pad the d leading lattice dims by m zeros each side, ONCE.  Taps
    then become pure static slices of this buffer (XLA fuses slice +
    FMA with no per-tap copies — the difference between ~9e7 and >1e9
    pair-updates/s at 1M particles)."""
    pads = [(m, m)] * d + [(0, 0)] * (arr.ndim - d)
    return jnp.pad(arr, pads)


def _tap_p(arrp, o, m: int, shape):
    """Slice the +o-shifted window out of a _pad_once buffer."""
    sl = tuple(slice(m + ok, m + ok + n) for ok, n in zip(o, shape))
    return arrp[sl + (Ellipsis,)]


def integration_1st_half_pk2_lattice(solid: dict, lat: LatticeSolid,
                                     material, dt,
                                     smoothing_length: float,
                                     numerical_dissipation_factor: float = 0.25,
                                     active_stress_fn=None,
                                     pk1_fn=None) -> dict:
    """Stencil twin of solid.integration_1st_half_pk2 (reference
    elastic_dynamics.cpp Integration1stHalfPK2).  `solid` is the standard
    flat state dict + a boolean "LatticeValid" channel (True = in-shape
    real particle)."""
    out = dict(solid)
    dim = lat.dim
    rho0 = material.rho0
    c0 = material.sound_speed
    ndf = numerical_dissipation_factor

    pos_f = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F_f = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    rho = rho0 / jnp.linalg.det(F_f)
    B = solid["LinearGradientCorrectionMatrix"]
    if pk1_fn is not None:
        P = pk1_fn(solid, F_f)
    else:
        S2 = material.stress_PK2(F_f)
        if active_stress_fn is not None:
            S2 = S2 + active_stress_fn(solid, F_f)
        P = F_f @ S2
    S_f = P @ jnp.swapaxes(B, -1, -2)

    valid = solid["LatticeValid"]
    vol0 = lat.dx ** dim
    (pos, vel, S, F, vmask) = _grids(
        lat, pos_f, solid["Velocity"], S_f, F_f,
        valid.astype(pos_f.dtype)[:, None])
    vmask = vmask[..., 0]
    pos, vel, S, F = _sanitize(vmask.astype(bool), pos, vel, S, F)

    # channel-split + pad-once fast path: every tap is a static slice of
    # a single halo buffer; per-tap coefficients are Python constants so
    # zero e-components fold away at trace time
    m = max(abs(c) for o, *_ in lat.taps for c in o)
    shp = lat.shape
    posP = [_pad_once(pos[..., k], m, dim) for k in range(dim)]
    velP = [_pad_once(vel[..., k], m, dim) for k in range(dim)]
    SP = [[_pad_once(S[..., a, b], m, dim) for b in range(dim)]
          for a in range(dim)]
    FP = [[_pad_once(F[..., a, b], m, dim) for b in range(dim)]
          for a in range(dim)]
    mP = _pad_once(vmask, m, dim)
    posC = [pos[..., k] for k in range(dim)]
    velC = [vel[..., k] for k in range(dim)]

    force = [jnp.zeros(shp, pos.dtype) for _ in range(dim)]
    damp_c = 0.5 * rho0 * c0 * smoothing_length
    for o, r0, e0, W0, dW0 in lat.taps:
        wj = _tap_p(mP, o, m, shp)
        dWV = dW0 * vol0
        e = [-float(c) for c in np.asarray(e0)]       # e0_ij points j -> i
        dor2 = (dim / r0) ** 2
        sr = None
        for k in range(dim):
            t = (posC[k] - _tap_p(posP[k], o, m, shp))                 * (velC[k] - _tap_p(velP[k], o, m, shp))
            sr = t if sr is None else sr + t
        pd = (ndf * (W0 / lat.w0) * damp_c * dor2) * sr
        for a in range(dim):
            acc = None
            for b in range(dim):
                if e[b] == 0.0:
                    continue
                s_ab = SP[a][b]
                f_ab = FP[a][b]
                term = (S[..., a, b] + _tap_p(s_ab, o, m, shp)
                        + pd * (0.5 * (F[..., a, b]
                                       + _tap_p(f_ab, o, m, shp))))
                term = term * e[b]
                acc = term if acc is None else acc + term
            force[a] = force[a] + (dWV) * wj * acc

    force_f = (jnp.stack([f.reshape(-1) for f in force], axis=-1)
               * (solid["Mass"] / rho0)[:, None]
               * valid.astype(pos_f.dtype)[:, None])
    vel_new = solid["Velocity"] + jnp.where(
        valid[:, None],
        (solid["ForcePrior"] + force_f) / jnp.maximum(solid["Mass"], TINY)[:, None] * dt,
        0.0)
    out.update({"Position": pos_f, "DeformationGradient": F_f, "Density": rho,
                "StressPK1OnParticle": S_f, "Force": force_f,
                "Velocity": vel_new})
    return out


def decomposed_integration_1st_half_lattice(solid: dict, lat: LatticeSolid,
                                            material, dt,
                                            smoothing_length: float,
                                            correction_factor: float = 1.07
                                            ) -> dict:
    """Stencil twin of solid.decomposed_integration_1st_half (reference
    DecomposedIntegration1stHalf, elastic_dynamics.cpp:162-184)."""
    out = dict(solid)
    dim = lat.dim
    rho0 = material.rho0
    G = material.shear_modulus

    pos_f = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F_f = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    dF = solid["DeformationRate"]
    J = jnp.linalg.det(F_f)
    rho = rho0 / J
    Jm2d_f = (1.0 / (J * J)) ** (1.0 / dim)
    invFT = jnp.swapaxes(jnp.linalg.inv(F_f), -1, -2)
    trFFT = jnp.einsum("nij,nij->n", F_f, F_f)
    scalar = (material.volumetric_kirchhoff(J)
              - correction_factor * G * Jm2d_f * trFFT / dim)
    sr = 0.5 * (dF @ jnp.swapaxes(F_f, -1, -2) + F_f @ jnp.swapaxes(dF, -1, -2))
    diag = jnp.eye(dim, dtype=F_f.dtype) * sr
    damp = 0.5 * rho0 * (material.shear_wave_speed * (sr - diag)
                         + material.sound_speed * diag) * smoothing_length
    S_f = scalar[:, None, None] * invFT + damp @ invFT

    valid = solid["LatticeValid"]
    vol0 = lat.dx ** dim
    pos, S, Jm2d, vmask = _grids(lat, pos_f, S_f, Jm2d_f[:, None],
                                 valid.astype(pos_f.dtype)[:, None])
    Jm2d = Jm2d[..., 0]
    vmask = vmask[..., 0]
    pos, S, Jm2d = _sanitize(vmask.astype(bool), pos, S, Jm2d)

    m = max(abs(c) for o, *_ in lat.taps for c in o)
    shp = lat.shape
    posP = [_pad_once(pos[..., k], m, dim) for k in range(dim)]
    SP = [[_pad_once(S[..., a, b], m, dim) for b in range(dim)]
          for a in range(dim)]
    JP = _pad_once(Jm2d, m, dim)
    mP = _pad_once(vmask, m, dim)
    posC = [pos[..., k] for k in range(dim)]

    force = [jnp.zeros(shp, pos.dtype) for _ in range(dim)]
    cfG = correction_factor * G
    for o, r0, e0, W0, dW0 in lat.taps:
        wj = _tap_p(mP, o, m, shp)
        dWV = dW0 * vol0
        e = [-float(c) for c in np.asarray(e0)]
        sh = (cfG / r0) * (Jm2d + _tap_p(JP, o, m, shp))
        for a in range(dim):
            acc = sh * (posC[a] - _tap_p(posP[a], o, m, shp))
            for b in range(dim):
                if e[b] == 0.0:
                    continue
                acc = acc + e[b] * (S[..., a, b]
                                    + _tap_p(SP[a][b], o, m, shp))
            force[a] = force[a] + dWV * wj * acc

    force_f = (jnp.stack([f.reshape(-1) for f in force], axis=-1)
               * (solid["Mass"] / rho0)[:, None]
               * valid.astype(pos_f.dtype)[:, None])
    vel_new = solid["Velocity"] + jnp.where(
        valid[:, None],
        (solid["ForcePrior"] + force_f) / jnp.maximum(solid["Mass"], TINY)[:, None] * dt,
        0.0)
    out.update({"Position": pos_f, "DeformationGradient": F_f, "Density": rho,
                "Force": force_f, "Velocity": vel_new})
    return out


def integration_2nd_half_lattice(solid: dict, lat: LatticeSolid, dt) -> dict:
    """Stencil twin of solid.integration_2nd_half (reference
    Integration2ndHalf): dF/dt_i = -[sum_o (v_i - v_j) outer dW0 V0 e0] B_i."""
    out = dict(solid)
    dim = lat.dim
    pos_f = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    valid = solid["LatticeValid"]
    vol0 = lat.dx ** dim

    (vel, vmask) = _grids(lat, solid["Velocity"],
                          valid.astype(pos_f.dtype)[:, None])
    vmask = vmask[..., 0]
    (vel,) = _sanitize(vmask.astype(bool), vel)

    m = max(abs(c) for o, *_ in lat.taps for c in o)
    shp = lat.shape
    velP = [_pad_once(vel[..., k], m, dim) for k in range(dim)]
    mP = _pad_once(vmask, m, dim)
    velC = [vel[..., k] for k in range(dim)]

    dFdt = [[jnp.zeros(shp, vel.dtype) for _ in range(dim)]
            for _ in range(dim)]
    for o, r0, e0, W0, dW0 in lat.taps:
        wj = _tap_p(mP, o, m, shp)
        e = [-float(c) for c in np.asarray(e0)]
        for b in range(dim):
            if e[b] == 0.0:
                continue
            gb = dW0 * vol0 * e[b]
            for a in range(dim):
                dv = (velC[a] - _tap_p(velP[a], o, m, shp)) * wj
                dFdt[a][b] = dFdt[a][b] - gb * dv

    B = solid["LinearGradientCorrectionMatrix"]
    dFdt_flat = jnp.stack(
        [jnp.stack([dFdt[a][b].reshape(-1) for b in range(dim)], -1)
         for a in range(dim)], -2)
    dFdt_f = dFdt_flat @ B
    F_new = solid["DeformationGradient"] + dFdt_f * (0.5 * dt)
    out.update({"Position": pos_f, "DeformationRate": dFdt_f,
                "DeformationGradient": F_new})
    return out


def lattice_correction_matrix(lat: LatticeSolid, valid, dtype=jnp.float32,
                              alpha: float = 0.0, eps: float = 1.0e-8):
    """B matrices via the stencil (twin of
    solid.linear_gradient_correction_matrix): A_i = -sum_o r0 e0 outer
    (dW0 V0 e0) wj; Tikhonov-regularized inverse with determinant
    weighting."""
    dim = lat.dim
    vol0 = lat.dx ** dim
    vmask = valid.astype(dtype).reshape(lat.shape)
    A = jnp.zeros(lat.shape + (dim, dim), dtype)
    for o, r0, e0, W0, dW0 in lat.taps:
        wj = _tap(vmask, o)
        e = -np.asarray(e0)
        outer = jnp.asarray(-np.outer(r0 * e, dW0 * vol0 * e), dtype)
        A = A + wj[..., None, None] * outer[None]
    A = A.reshape(-1, dim, dim)
    det = jnp.linalg.det(A)
    eye = jnp.eye(dim, dtype=A.dtype)
    At = jnp.swapaxes(A, -1, -2)
    inv = jnp.linalg.inv(At @ A + eps * eye) @ At
    det_sqr = jnp.maximum(alpha - det, 0.0)
    w1 = det / (det + det_sqr)
    w2 = det_sqr / (det + det_sqr)
    return w1[..., None, None] * inv + w2[..., None, None] * eye
