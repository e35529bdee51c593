"""Narrow-band packaged level-set field (dimension-generic).

Counterpart of the reference's LevelSet on SparseMeshField<4>
(mesh_dynamics/level_set_dynamics/level_set.{h,hpp} + level_set_correction
+ level_set_transformation, dim-generic like
src/shared/meshes/sparse_mesh/sparse_mesh_field.h:78) and LevelSetShape
(geometries/level_set_shape.{h,cpp}).

The reference stores 4^d-cell data packages sparsely (pointer-chased,
allocated only near the interface) and runs package-local CPU kernels with
a cell-neighborhood indirection per stencil tap.  The XLA-native layout
keeps the same two-level structure — a coarse package grid whose occupied
(near-band) packages are the only ones holding data — but stores them as
ONE dense (P,) + (4,)*d array plus two constant far-field sentinel
packages (+big / -big).  Every mesh dynamic (reinitialization sweeps,
gradients, kernel integrals) first materializes a (P,) + (12,)*d halo view
by gathering each package's 3^d neighbors (pure gathers — the
package-neighbor table is precomputed), then runs dense vectorized
stencils; XLA fuses the lot.

Conventions follow the reference exactly:
  * phi < 0 inside the shape, > 0 outside;
  * kernel integrals integrate W (and grad W) over the POSITIVE-phi region
    with the cut-cell volume fraction
    sum_i g_i^2/|g|^2 H(phi/|g_i|, dx/2)   (level_set_transformation.hpp:65)
  * reinitialization: Godunov upwind
    phi -= sign (|grad phi| - dx) / d      (level_set_correction.hpp:43)
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

PKG = 4          # cells per package side (SparseMeshField<4>)
FAR = 1.0e3      # far-field sentinel magnitude (scaled by spacing later)
TINY = 1.0e-15


def _center_slices(dim, off):
    """Halo slices selecting the center package shifted by `off` (len dim)."""
    return tuple(slice(PKG + o, 2 * PKG + o) for o in off)


@dataclasses.dataclass(frozen=True)
class LevelSet:
    """Packaged level-set field.  phi has shape (P+2,) + (PKG,)*dim: the
    last two rows are the constant far-field packages (index P: +far,
    P+1: -far).  pkg_nbr (P,) + (3,)*dim holds package indices of the
    3^dim coarse neighborhood (pointing into the extended array)."""

    spacing: float
    lower: Any               # (dim,) fine-grid origin
    n_pkg: Any               # (dim,) coarse grid dims
    coarse_map: Any          # (prod n_pkg,) -> package row or sentinel
    pkg_coord: Any           # (P, dim) coarse coordinates of each package
    pkg_nbr: Any             # (P,) + (3,)*dim
    phi: Any                 # (P+2,) + (PKG,)*dim
    kernel_w: Any | None = None
    kernel_gw: Any | None = None
    kernel_g2w: Any | None = None

    @property
    def dim(self) -> int:
        return len(self.n_pkg)

    @property
    def n_inner(self) -> int:
        return self.phi.shape[0] - 2

    # ------------------------------------------------------------------
    def halo(self, field=None):
        """(P+2,) + (3*PKG,)*dim [+ (c,)] halo view: each inner package
        tiled with its 3^dim package neighborhood (the XLA replacement for
        the reference's per-tap CellNeighborhood indirection); the two
        far-field sentinel rows are tiled constants so probes landing in
        far packages read the correct far value."""
        dim = self.dim
        f = self.phi if field is None else field
        g = f[self.pkg_nbr]             # (P,) + (3,)*d + (PKG,)*d + extra
        # interleave (n_k, c_k) axis pairs: target axes P, n1,c1, n2,c2, ...
        perm = [0]
        for k in range(dim):
            perm += [1 + k, 1 + dim + k]
        perm += list(range(1 + 2 * dim, g.ndim))
        g = jnp.transpose(g, perm)
        extra = f.shape[1 + dim:]
        inner = g.reshape((g.shape[0],) + (3 * PKG,) * dim + extra)
        reps = (3,) * dim + (1,) * len(extra)
        far = jnp.stack([jnp.tile(f[-2], reps), jnp.tile(f[-1], reps)])
        return jnp.concatenate([inner, far], axis=0)

    # -- probes ---------------------------------------------------------
    def _locate(self, pts):
        """query points -> (package row, in-package cell float coords)."""
        dim = self.dim
        rel = (pts - self.lower) / self.spacing
        cell = jnp.floor(rel).astype(jnp.int32)
        pkg = jnp.clip(jnp.floor_divide(cell, PKG), 0,
                       jnp.asarray(self.n_pkg) - 1)
        flat = pkg[..., 0]
        for k in range(1, dim):
            flat = flat * self.n_pkg[k] + pkg[..., k]
        row = self.coarse_map[flat]
        local = rel - pkg * PKG
        return row, local

    def _multilinear(self, field, pts):
        """dim-linear interpolation on the halo view."""
        dim = self.dim
        row, local = self._locate(pts)
        h = self.halo(field)[row]              # (..., 12^d [, c])
        extra = field.ndim - 1 - dim
        x = [local[..., k] + PKG - 0.5 for k in range(dim)]
        x0 = [jnp.clip(jnp.floor(c).astype(jnp.int32), 0, 3 * PKG - 2)
              for c in x]
        fr = [jnp.clip(c - c0, 0.0, 1.0) for c, c0 in zip(x, x0)]
        if extra:
            fr = [f[..., None] for f in fr]
        b = jnp.arange(row.shape[0]) if row.ndim == 1 else None
        out = 0.0
        for corner in itertools.product((0, 1), repeat=dim):
            idx = tuple(c0 + o for c0, o in zip(x0, corner))
            v = h[(b,) + idx] if b is not None else h[idx]
            w = 1.0
            for f, o in zip(fr, corner):
                w = w * (f if o else (1.0 - f))
            out = out + w * v
        return out

    def probe_signed_distance(self, pts):
        """probeSignedDistance (level_set.h:64)."""
        return self._multilinear(self.phi, pts)

    def probe_normal_direction(self, pts):
        """probeNormalDirection: normalized interpolated phi gradient."""
        g = self.gradient()
        gv = self._multilinear(g, pts)
        return gv / (jnp.linalg.norm(gv, axis=-1, keepdims=True) + TINY)

    def probe_kernel_integral(self, pts):
        return self._multilinear(self.kernel_w, pts)

    def probe_kernel_gradient_integral(self, pts):
        return self._multilinear(self.kernel_gw, pts)

    def probe_kernel_second_gradient_integral(self, pts):
        """computeKernelSecondGradientIntegral probe: (…, dim, dim) matrix
        integral of d2W(r) e e^T over the positive-phi region
        (level_set_transformation.hpp:128-138)."""
        dim = self.dim
        g2 = self.kernel_g2w.reshape(self.kernel_g2w.shape[:1 + dim]
                                     + (dim * dim,))
        out = self._multilinear(g2, pts)
        return out.reshape(out.shape[:-1] + (dim, dim))

    # -- mesh dynamics --------------------------------------------------
    def _shift(self, h, axis, off):
        """Center package of the halo shifted by `off` cells along `axis`."""
        dim = self.dim
        sl = [slice(None)]
        for k in range(dim):
            sl.append(slice(PKG + (off if k == axis else 0),
                            2 * PKG + (off if k == axis else 0)))
        return h[tuple(sl)]

    def gradient(self):
        """Central-difference phi gradient per cell,
        (P+2,) + (PKG,)*d + (d,)."""
        h = self.halo()[:self.n_inner]
        comps = [(self._shift(h, k, 1) - self._shift(h, k, -1))
                 / (2.0 * self.spacing) for k in range(self.dim)]
        g = jnp.stack(comps, axis=-1)
        pad = jnp.zeros((2,) + g.shape[1:], g.dtype)
        return jnp.concatenate([g, pad], axis=0)

    def reinitialize(self, iterations: int = 30) -> "LevelSet":
        """ReinitializeLevelSet (level_set_correction.hpp:20-68): Godunov
        upwind iteration toward |grad phi| = 1, interface anchored by the
        smoothed sign."""
        dx = self.spacing
        dim = self.dim

        def body(phi, _):
            ls = dataclasses.replace(self, phi=phi)
            h = ls.halo()[:ls.n_inner]
            p0 = self._shift(h, 0, 0)
            sign = p0 / jnp.sqrt(p0 * p0 + dx * dx)

            def upwind(sign, dp, dm):
                # upwindDifference (level_set_correction.hpp:20-38)
                both_p = (sign * dp >= 0.0) & (sign * dm >= 0.0)
                both_m = (sign * dp <= 0.0) & (sign * dm <= 0.0)
                mixed_out = (sign * dp > 0.0) & (sign * dm < 0.0)
                ss = sign * (jnp.abs(dp) - jnp.abs(dm)) / \
                    jnp.where(jnp.abs(dp - dm) > TINY, dp - dm, TINY)
                inward = jnp.where(ss > 0.0, dm, dp)
                return jnp.where(both_p, dm,
                                 jnp.where(both_m, dp,
                                           jnp.where(mixed_out, 0.0, inward)))

            norm2 = TINY
            for k in range(dim):
                dp = (self._shift(h, k, 1) - p0) / dx
                dm = (p0 - self._shift(h, k, -1)) / dx
                gk = upwind(sign, dp, dm)
                norm2 = norm2 + gk * gk
            norm = jnp.sqrt(norm2)
            upd = p0 - sign * (norm * dx - dx) / float(dim)
            phi = phi.at[:-2].set(upd)
            return phi, None

        phi, _ = jax.lax.scan(body, self.phi, None, length=iterations)
        return dataclasses.replace(self, phi=phi)

    def update_kernel_integrals(self, kernel, dim: int | None = None
                                ) -> "LevelSet":
        """UpdateKernelIntegrals (level_set_transformation.hpp:50-130):
        per cell, integral of W (and grad W) over the positive-phi region
        within the kernel cutoff, with cut-cell volume fractions."""
        dim = dim or self.dim
        dx = self.spacing
        cutoff = float(kernel.cutoff) / dx       # support radius in cells
        m = int(np.ceil(cutoff))
        assert m <= PKG, "kernel support exceeds one package halo"
        h = self.halo()[:self.n_inner]
        grad = self.halo(self.gradient())[:self.n_inner]

        phi_c = h[(slice(None),) + _center_slices(dim, (0,) * dim)]
        wsum = jnp.zeros_like(phi_c)
        gsum = jnp.zeros(phi_c.shape + (dim,), phi_c.dtype)
        g2sum = jnp.zeros(phi_c.shape + (dim, dim), phi_c.dtype)
        offs = [o for o in itertools.product(range(-m, m + 1), repeat=dim)
                if sum(c * c for c in o) <= (cutoff + 1e-9) ** 2]
        for off in offs:
            sl = (slice(None),) + _center_slices(dim, off)
            pn = h[sl]
            gn = grad[sl]
            g2 = jnp.sum(gn * gn, axis=-1) + TINY
            frac = jnp.zeros_like(pn)
            for ax in range(dim):
                hv = jnp.clip(0.5 + 0.5 * (pn / (jnp.abs(gn[..., ax]) + TINY))
                              / (0.5 * dx), 0.0, 1.0)
                frac = frac + gn[..., ax] ** 2 / g2 * hv
            frac = jnp.where(pn > -dx, frac, 0.0)
            r = float(np.linalg.norm(off)) * dx
            w = float(kernel.W(jnp.asarray(r), dim))
            wsum = wsum + w * frac
            if r > TINY:
                e = jnp.asarray(np.asarray([-c * dx for c in off]) / r,
                                phi_c.dtype)
                dw = float(kernel.dW(jnp.asarray(r), dim))
                gsum = gsum + (dw * frac)[..., None] * e
                d2w = float(kernel.d2W(jnp.asarray(r), dim))
                ee = np.outer(np.asarray(e), np.asarray(e))
                g2sum = g2sum + (d2w * frac)[..., None, None] \
                    * jnp.asarray(ee, phi_c.dtype)
        scale = dx ** dim
        deep = phi_c > cutoff * dx
        kw = jnp.where(deep, 1.0, wsum * scale)
        kg = jnp.where(deep[..., None], 0.0, gsum * scale)
        kg2 = jnp.where(deep[..., None, None], 0.0, g2sum * scale)
        pad = jnp.zeros((2,) + kw.shape[1:], kw.dtype)
        padg = jnp.zeros((2,) + kg.shape[1:], kg.dtype)
        padg2 = jnp.zeros((2,) + kg2.shape[1:], kg2.dtype)
        # far-field positive package: full support in positive region
        kw_full = jnp.concatenate([kw, pad.at[0].set(1.0)], axis=0)
        kg_full = jnp.concatenate([kg, padg], axis=0)
        kg2_full = jnp.concatenate([kg2, padg2], axis=0)
        return dataclasses.replace(self, kernel_w=kw_full, kernel_gw=kg_full,
                                   kernel_g2w=kg2_full)

    def clean_interface(self, repeat: int = 2) -> "LevelSet":
        """cleanInterface (level_set.h:62): re-distance the field around
        the interface (the reference additionally re-marks cut interfaces;
        with a well-formed initial phi the reinitialization sweeps do the
        smoothing work)."""
        return self.reinitialize(iterations=10 * repeat)


def build_levelset(shape, lower, upper, spacing: float,
                   band_width: float | None = None,
                   dtype=jnp.float32) -> LevelSet:
    """Build the packaged field from a Shape (LevelSetShape ctor +
    FinishDataPackages): packages whose center is within `band_width`
    (default 6 spacings + package diagonal) of the interface hold data;
    everything else maps to the +/- far-field sentinels.  Dimension comes
    from len(lower) (2 or 3)."""
    from sphinxsys_jax.utils.hosteval import host_eval

    lo = np.asarray(lower, np.float64)
    hi = np.asarray(upper, np.float64)
    dim = len(lo)
    n_cells = np.ceil((hi - lo) / spacing).astype(int)
    n_pkg = -(-n_cells // PKG)          # ceil division
    band = band_width or (6.0 + PKG) * spacing

    # package centers
    grids = np.meshgrid(*[np.arange(n) for n in n_pkg], indexing="ij")
    coords = np.stack(grids, -1).reshape(-1, dim)
    centers = lo + (coords + 0.5) * (PKG * spacing)
    sd_c = np.asarray(host_eval(shape.signed_distance, jnp.asarray(centers)))
    occupied = np.abs(sd_c) < band
    pkg_rows = np.nonzero(occupied)[0]
    P = len(pkg_rows)

    coarse_map = np.where(sd_c >= 0, P, P + 1).astype(np.int64)  # far +/-
    coarse_map[pkg_rows] = np.arange(P)

    pkg_coord = coords[pkg_rows]
    strides = np.array([int(np.prod(n_pkg[k + 1:])) for k in range(dim)])

    # neighbor package table (clamped at the domain edge)
    nbr = np.empty((P,) + (3,) * dim, np.int64)
    for off in itertools.product((-1, 0, 1), repeat=dim):
        c = [np.clip(pkg_coord[:, k] + off[k], 0, n_pkg[k] - 1)
             for k in range(dim)]
        flat = sum(c[k] * strides[k] for k in range(dim))
        nbr[(slice(None),) + tuple(o + 1 for o in off)] = coarse_map[flat]

    # fine phi for occupied packages
    cell = np.meshgrid(*[np.arange(PKG)] * dim, indexing="ij")
    pts = np.stack([
        lo[k] + (pkg_coord[:, k][(slice(None),) + (None,) * dim] * PKG
                 + cell[k][None] + 0.5) * spacing
        for k in range(dim)], axis=-1).reshape(-1, dim)
    phi_in = np.asarray(host_eval(shape.signed_distance, jnp.asarray(pts)))
    phi = np.empty((P + 2,) + (PKG,) * dim)
    phi[:P] = phi_in.reshape((P,) + (PKG,) * dim)
    far = FAR * spacing
    phi[P] = far
    phi[P + 1] = -far

    return LevelSet(spacing=float(spacing), lower=jnp.asarray(lo, dtype),
                    n_pkg=tuple(int(x) for x in n_pkg),
                    coarse_map=jnp.asarray(coarse_map, jnp.int32),
                    pkg_coord=jnp.asarray(pkg_coord, jnp.int32),
                    pkg_nbr=jnp.asarray(nbr, jnp.int32),
                    phi=jnp.asarray(phi, dtype))


@dataclasses.dataclass(frozen=True)
class LevelSetShape:
    """LevelSetShape (geometries/level_set_shape.h): a Shape backed by the
    packaged level set — contains / signed distance / normals answered by
    mesh probes, plus the kernel-integral probes the wall-BC and
    relaxation dynamics consume."""

    levelset: LevelSet
    name: str = "LevelSetShape"

    def signed_distance(self, pos):
        return self.levelset.probe_signed_distance(pos)

    def contains(self, pos):
        return self.signed_distance(pos) < 0.0

    def find_normal_direction(self, pos):
        return self.levelset.probe_normal_direction(pos)

    def compute_kernel_integral(self, pos):
        return self.levelset.probe_kernel_integral(pos)

    def compute_kernel_gradient_integral(self, pos):
        return self.levelset.probe_kernel_gradient_integral(pos)

    def bounds(self):
        ls = self.levelset
        lo = np.asarray(ls.lower)
        return lo, lo + np.asarray(ls.n_pkg) * PKG * ls.spacing
