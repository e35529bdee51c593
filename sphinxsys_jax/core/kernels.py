"""Smoothing kernels.

JAX counterpart of the reference kernel library
(/root/reference/src/shared/kernels/base_kernel.h:56-154 and the concrete
kernels under src/shared/kernels/).  Each kernel is a small frozen dataclass
of static floats; ``w(q)``/``dw(q)`` are pure jnp functions of the
normalized distance q = r/h, so they trace into fused VPU code inside any
interaction kernel — values are recomputed on the fly from positions, like
the reference CK stack (shared_ck/body_relation/neighbor_method.h:53-116),
instead of being stored per pair.

Conventions (match the reference):
  * ``h`` is the smoothing length; support radius = ``kernel_size * h``
    (2h for all kernels here).
  * ``W(r)``  has units 1/len^dim; ``dW(r)`` = dW/dr (negative).
  * dimensional normalization factors follow
    src/shared/kernels/kernel_wendland_c2.cpp:9-14 etc.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax.numpy as jnp

_PI = math.pi


@dataclasses.dataclass(frozen=True)
class SmoothingKernel:
    """Base smoothing kernel. Subclasses define _w/_dw/_d2w of q and factors."""

    h: float
    kernel_size: float = 2.0  # support = kernel_size * h

    # ---- shape functions of q = r/h (override) -------------------------
    def _w(self, q):
        raise NotImplementedError

    def _dw(self, q):
        raise NotImplementedError

    def _d2w(self, q):
        raise NotImplementedError

    # ---- normalization (override) --------------------------------------
    def _factor_w(self, dim: int) -> float:
        raise NotImplementedError

    # ---- public API -----------------------------------------------------
    @property
    def cutoff(self) -> float:
        return self.kernel_size * self.h

    def w0(self, dim: int) -> float:
        """W at r=0 (a static python float, safe to call inside jit)."""
        import jax

        with jax.ensure_compile_time_eval():
            return self._factor_w(dim) * float(self._w(jnp.asarray(0.0)))

    def W(self, r, dim: int):
        """Kernel value; zero outside support."""
        q = r / self.h
        inside = q < self.kernel_size
        return jnp.where(inside, self._factor_w(dim) * self._w(jnp.minimum(q, self.kernel_size)), 0.0)

    def dW(self, r, dim: int):
        """Radial derivative dW/dr; zero outside support."""
        q = r / self.h
        inside = q < self.kernel_size
        factor = self._factor_w(dim) / self.h
        return jnp.where(inside, factor * self._dw(jnp.minimum(q, self.kernel_size)), 0.0)

    def d2W(self, r, dim: int):
        q = r / self.h
        inside = q < self.kernel_size
        factor = self._factor_w(dim) / (self.h * self.h)
        return jnp.where(inside, factor * self._d2w(jnp.minimum(q, self.kernel_size)), 0.0)


@dataclasses.dataclass(frozen=True)
class WendlandC2(SmoothingKernel):
    """Wendland C2 kernel — the reference default
    (src/shared/kernels/kernel_wendland_c2.cpp)."""

    def _w(self, q):
        return (1.0 - 0.5 * q) ** 4 * (1.0 + 2.0 * q)

    def _dw(self, q):
        return 0.625 * (q - 2.0) ** 3 * q

    def _d2w(self, q):
        return 1.25 * (q - 2.0) ** 2 * (2.0 * q - 1.0)

    def _factor_w(self, dim: int) -> float:
        h = self.h
        if dim == 1:
            return 3.0 / (4.0 * h)
        if dim == 2:
            return 7.0 / (4.0 * _PI * h * h)
        if dim == 3:
            return 21.0 / (16.0 * _PI * h * h * h)
        raise ValueError(f"dim must be 1/2/3, got {dim}")


@dataclasses.dataclass(frozen=True)
class CubicBSpline(SmoothingKernel):
    """Cubic B-spline kernel (src/shared/kernels/kernel_cubic_B_spline.cpp)."""

    def _w(self, q):
        lo = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
        hi = (2.0 - q) ** 3 / 4.0
        return jnp.where(q < 1.0, lo, hi)

    def _dw(self, q):
        lo = 2.25 * q * q - 3.0 * q
        hi = -0.75 * (2.0 - q) ** 2
        return jnp.where(q < 1.0, lo, hi)

    def _d2w(self, q):
        lo = 4.5 * q - 3.0
        hi = 1.5 * (2.0 - q)
        return jnp.where(q < 1.0, lo, hi)

    def _factor_w(self, dim: int) -> float:
        h = self.h
        if dim == 1:
            return 2.0 / (3.0 * h)
        if dim == 2:
            return 10.0 / (7.0 * _PI * h * h)
        if dim == 3:
            return 1.0 / (_PI * h * h * h)
        raise ValueError(f"dim must be 1/2/3, got {dim}")


@dataclasses.dataclass(frozen=True)
class Quadratic(SmoothingKernel):
    """Quadratic kernel (src/shared/kernels/kernel_quadratic.cpp).

    Note: we use the consistent analytic derivative dw/dq = 15(q-2)/32 in
    every dimension (the reference's dW_1D/2D branches are inconsistent
    with its own W shape; its dW_3D matches the analytic form).  Also note
    the reference's 1D/2D normalization factors do not integrate to one —
    only the 3D kernel is properly normalized; we keep the same factors
    for parity."""

    def _w(self, q):
        return 5.0 * (3.0 * q * q - 12.0 * q + 12.0) / 64.0

    def _dw(self, q):
        return 15.0 * (q - 2.0) / 32.0

    def _d2w(self, q):
        return 15.0 / 32.0 * jnp.ones_like(q)

    def _factor_w(self, dim: int) -> float:
        h = self.h
        if dim == 1:
            return 1.0 / (7.0 * h)
        if dim == 2:
            return 1.0 / (3.0 * _PI * h * h)
        if dim == 3:
            return 1.0 / (_PI * h * h * h)
        raise ValueError(f"dim must be 1/2/3, got {dim}")


def lattice_number_density(kernel: SmoothingKernel, spacing: float, dim: int) -> float:
    """Reference number density sigma0 = sum of W over a regular lattice
    within the cutoff (src/shared/adaptations/adaptation.cpp:26-60).
    Static host-side value, safe to call inside jit."""
    import jax
    import numpy as np

    cutoff = kernel.cutoff
    depth = int(cutoff / spacing) + 1
    rng = np.arange(-depth, depth + 1)
    grids = np.meshgrid(*([rng] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1) * spacing
    dist = np.linalg.norm(pts, axis=-1)
    inside = dist < cutoff
    with jax.ensure_compile_time_eval():
        w = np.asarray(kernel.W(jnp.asarray(dist[inside], dtype=jnp.float64
                                            if jax.config.jax_enable_x64 else jnp.float32), dim))
    return float(w.sum())


@dataclasses.dataclass(frozen=True)
class LaguerreGauss(SmoothingKernel):
    """Laguerre-Gauss kernel (kernel_laguerre_gauss.cpp): a truncated
    Gaussian times a Laguerre polynomial; same shape in all dimensions."""

    def _w(self, q):
        return (1.0 - q * q + q ** 4 / 6.0) * jnp.exp(-q * q)

    def _dw(self, q):
        return (-(q ** 5) / 3.0 + 8.0 * q ** 3 / 3.0 - 4.0 * q) * jnp.exp(-q * q)

    def _d2w(self, q):
        return (2.0 * q ** 6 / 3.0 - 7.0 * q ** 4 + 16.0 * q * q - 4.0) * jnp.exp(-q * q)

    def _factor_w(self, dim: int) -> float:
        inv_h = 1.0 / self.h
        if dim == 1:
            return inv_h * 8.0 / (5.0 * math.sqrt(_PI))
        if dim == 2:
            return inv_h ** 2 * 3.0 / _PI
        return inv_h ** 3 * 8.0 / _PI ** 1.5


@dataclasses.dataclass(frozen=True)
class Hyperbolic(SmoothingKernel):
    """Hyperbolic-shaped kernel (kernel_hyperbolic.cpp): piecewise
    (6 - 6q + q^3) for q < 1 and (2 - q)^3 for 1 <= q < 2."""

    def _w(self, q):
        return jnp.where(q < 1.0, 6.0 - 6.0 * q + q ** 3, (2.0 - q) ** 3)

    def _dw(self, q):
        return jnp.where(q < 1.0, -6.0 + 3.0 * q * q, -3.0 * (2.0 - q) ** 2)

    def _d2w(self, q):
        return jnp.where(q < 1.0, 6.0 * q, 6.0 * (2.0 - q))

    def _factor_w(self, dim: int) -> float:
        inv_h = 1.0 / self.h
        if dim == 1:
            return inv_h / 7.0
        if dim == 2:
            return inv_h ** 2 / (3.0 * _PI)
        return inv_h ** 3 * 15.0 / (62.0 * _PI)


@dataclasses.dataclass(frozen=True)
class TabulatedKernel:
    """KernelTabulated<KernelType> (kernel_tabulated.h): W/dW/d2W read from
    a precomputed table by 4-point Lagrange interpolation.

    Kept for parity and for kernels that are expensive to evaluate; on an
    accelerator the table lookup is a device-memory gather while the
    analytic kernels fuse into elementwise arithmetic, so the analytic form
    is the default here, the opposite of the reference's CPU trade-off.
    API-compatible with SmoothingKernel.
    """

    base: SmoothingKernel
    resolution: int = 20

    @property
    def h(self):
        return self.base.h

    @property
    def kernel_size(self):
        return self.base.kernel_size

    @property
    def cutoff(self):
        return self.base.cutoff

    def w0(self, dim: int) -> float:
        return self.base.w0(dim)

    def _dq(self) -> float:
        return self.base.kernel_size / self.resolution

    def _table(self, fn, dim: int):
        import jax

        dq = self._dq()
        with jax.ensure_compile_time_eval():
            # the q = -dq pad point evaluates the raw shape polynomial at
            # negative q, exactly as the reference table does
            qs = jnp.arange(-1.0, self.resolution + 3.0) * dq * self.h
            return fn(qs, dim)

    def _interp(self, table, q):
        """Four-point Lagrange interpolation (kernel_tabulated.h:49-62)."""
        dq = self._dq()
        loc = jnp.floor(q / dq).astype(jnp.int32)
        loc = jnp.clip(loc, 0, self.resolution - 1)
        f1 = q - loc * dq
        f0 = f1 + dq
        f2 = f1 - dq
        f3 = f1 - 2 * dq
        d0 = (-dq) * (-2 * dq) * (-3 * dq)
        d1 = dq * (-dq) * (-2 * dq)
        d2 = (2 * dq) * dq * (-dq)
        d3 = (3 * dq) * (2 * dq) * dq
        i = loc + 1
        return (f1 * f2 * f3 / d0 * table[i - 1] + f0 * f2 * f3 / d1 * table[i]
                + f0 * f1 * f3 / d2 * table[i + 1]
                + f0 * f1 * f2 / d3 * table[i + 2])

    def W(self, r, dim: int):
        t = self._table(self.base.W, dim)
        return jnp.where(r < self.cutoff, self._interp(t, r / self.h), 0.0)

    def dW(self, r, dim: int):
        t = self._table(self.base.dW, dim)
        return jnp.where(r < self.cutoff, self._interp(t, r / self.h), 0.0)

    def d2W(self, r, dim: int):
        t = self._table(self.base.d2W, dim)
        return jnp.where(r < self.cutoff, self._interp(t, r / self.h), 0.0)


@dataclasses.dataclass(frozen=True)
class AnisotropicKernel:
    """AnisotropicKernel<KernelType> (anisotropic_kernel.{h,hpp}): the
    displacement is mapped to an isotropic space by G = diag(1/(h k_i))
    (per-axis stretch k_i), q = |G d|, and the value is scaled by det(G)
    so the kernel integrates to one over the stretched support.

    Displacement-based API: W_disp/grad_W take the displacement VECTOR
    (x_i - x_j), unlike the radial isotropic kernels — anisotropic support
    has no single radius.  grad_W returns the full gradient
    factor * w'(q) * G^T G d / q, which reduces to dW(r) e_ij when
    k = (1,...,1)."""

    base: SmoothingKernel
    kernel_vector: tuple

    @property
    def h(self):
        return self.base.h

    @property
    def kernel_size(self):
        return self.base.kernel_size

    def _G_diag(self, dtype):
        kv = jnp.asarray(self.kernel_vector, dtype)
        return 1.0 / (self.base.h * kv)

    def _det_G(self) -> float:
        det = 1.0
        for k in self.kernel_vector:
            det *= 1.0 / (self.base.h * k)
        return det

    def _factor(self, dim: int) -> float:
        # reference getFactors(): h^dim det(G) * isotropic factor (which
        # carries 1/h^dim), i.e. the shape normalization times det(G)
        return self.base._factor_w(dim) * self.base.h ** dim * self._det_G()

    def transformed_q(self, displacement):
        g = self._G_diag(displacement.dtype)
        return jnp.linalg.norm(g * displacement, axis=-1)

    def within_cutoff(self, displacement):
        return self.transformed_q(displacement) < self.kernel_size

    def W_disp(self, displacement, dim: int):
        q = self.transformed_q(displacement)
        inside = q < self.kernel_size
        return jnp.where(inside, self._factor(dim)
                         * self.base._w(jnp.minimum(q, self.kernel_size)), 0.0)

    def grad_W(self, displacement, dim: int):
        g = self._G_diag(displacement.dtype)
        gd = g * displacement
        q = jnp.linalg.norm(gd, axis=-1)
        inside = q < self.kernel_size
        dwdq = self._factor(dim) * self.base._dw(jnp.minimum(q, self.kernel_size))
        coeff = jnp.where(inside, dwdq / jnp.maximum(q, 1e-15), 0.0)
        return coeff[..., None] * (g * gd)


# ---------------------------------------------------------------------------
# Variable-smoothing-length evaluation (adaptive-h bodies).
# Mirrors Kernel::W(h_ratio, r, ...) = factor_W * W(q h_ratio) * h_ratio^d
# and dW(h_ratio, ...) * h_ratio^{d+1} (base_kernel.cpp:98-140), with
# h_ratio = h_ref / h_particle >= 1 for refined particles.
# ---------------------------------------------------------------------------

def _adaptive_W(kernel, r, h_ratio, dim: int):
    q = r / kernel.h * h_ratio
    inside = q < kernel.kernel_size
    val = kernel._factor_w(dim) * (h_ratio ** dim) * kernel._w(
        jnp.minimum(q, kernel.kernel_size))
    return jnp.where(inside, val, 0.0)


def _adaptive_dW(kernel, r, h_ratio, dim: int):
    q = r / kernel.h * h_ratio
    inside = q < kernel.kernel_size
    val = (kernel._factor_w(dim) / kernel.h) * (h_ratio ** (dim + 1)) * \
        kernel._dw(jnp.minimum(q, kernel.kernel_size))
    return jnp.where(inside, val, 0.0)


SmoothingKernel.W_adaptive = _adaptive_W
SmoothingKernel.dW_adaptive = _adaptive_dW
