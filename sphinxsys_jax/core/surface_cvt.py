"""Parametric-surface shell particle generation with CVT relaxation.

Counterpart of the reference's per-case parametric surface generators +
pre-relaxed vertex files (test_3d_roof_parametric_cvt.cpp:53-232 builds
`ParticleGenerator<SurfaceParticles, ShellRoof/Cylinder>` from CVT-relaxed
positions; test_3d_shell_stability_half_sphere reads
input/shell_sphere_half_*.txt produced by an offline CVT).  Here the whole
pipeline is in-framework and device-resident:

  1. quasi-uniform seeding: Fibonacci spiral on spheres/hemispheres (a
     near-CVT distribution by construction), or a (u, v) lattice on
     general parametric patches;
  2. tangential Lloyd/CVT relaxation: kernel-gradient pair repulsion
     (the same first-order relaxation force as relax_dynamics,
     relax_dynamics.cpp ParticleRelaxation), displacement projected onto
     the local tangent plane, position re-projected onto the surface
     each sweep — a jitted lax.scan, dense pairwise (generation-time
     N^2 is trivial next to one simulation step);
  3. boundary handling by a user clamp (e.g. hemisphere equator).

The output feeds sh.make_shell_state directly: positions, outward
normals, per-particle area = total_area / n (the reference's convention,
test_3d_shell_stability_half_sphere.cpp:132).
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def fibonacci_sphere(n: int, radius: float = 1.0,
                     hemisphere: bool = False) -> np.ndarray:
    """Fibonacci-spiral points on the (hemi)sphere — quasi-uniform with
    ~0.1 dp discrepancy, the standard low-energy spherical seeding."""
    ga = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(n, dtype=np.float64)
    if hemisphere:
        z = (i + 0.5) / n                # z in (0, 1): upper hemisphere
    else:
        z = 1.0 - 2.0 * (i + 0.5) / n    # z in (-1, 1)
    r_xy = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    th = ga * i
    return radius * np.stack([r_xy * np.cos(th), r_xy * np.sin(th), z], -1)


def sphere_projector(radius: float, hemisphere: bool = False,
                     min_z: float = 0.0):
    """(pos) -> (projected pos, outward normal) for a (hemi)sphere centred
    at the origin.  Hemisphere: points pushed below the equator clamp to
    the equator circle."""

    def project(p):
        if hemisphere:
            p = p.at[:, 2].set(jnp.maximum(p[:, 2], min_z))
        r = jnp.linalg.norm(p, axis=-1, keepdims=True)
        n = p / jnp.maximum(r, 1e-30)
        return radius * n, n

    return project


def cylinder_projector(r_mid: float, axis: int = 1):
    """Projector for a cylindrical mid-surface about the given axis."""

    def project(p):
        mask = jnp.ones((3,), p.dtype).at[axis].set(0.0)
        radial = p * mask
        rn = jnp.linalg.norm(radial, axis=-1, keepdims=True)
        n = radial / jnp.maximum(rn, 1e-30)
        return p * (1.0 - mask) + r_mid * n, n

    return project


def cvt_relax_on_surface(pos0, project: Callable, dp: float,
                         n_iter: int = 200, step_factor: float = 0.2,
                         kernel_h_ratio: float = 1.3):
    """Tangential CVT/Lloyd relaxation.  pos0 (N, 3) seeds; `project` maps
    arbitrary points to (surface point, outward unit normal); dp is the
    target spacing.  Returns (pos, normal) as numpy arrays.

    The relaxation force is the WendlandC2 kernel-gradient repulsion of
    relax_dynamics (each sweep moves a particle by step_factor * dp *
    normalized residual, projected tangentially) — the same fixed-point
    as the reference's level-set-free surface relaxation."""
    h = kernel_h_ratio * dp
    cutoff = 2.0 * h
    pos0 = jnp.asarray(pos0, jnp.float64 if jax.config.jax_enable_x64
                       else jnp.float32)

    def pair_force(p):
        d = p[:, None, :] - p[None, :, :]               # (N, N, 3)
        r2 = jnp.sum(d * d, -1) + 1e-30
        r = jnp.sqrt(r2)
        q = jnp.minimum(r / h, 2.0)
        # dW/dr of Wendland C2 (up to a constant): (q-2)^3 q
        dw = -((q - 2.0) ** 3) * q
        w = dw / r
        w = w * (1.0 - jnp.eye(p.shape[0], dtype=p.dtype))
        return jnp.sum(w[..., None] * d, axis=1)        # repulsion

    def sweep(p, _):
        f = pair_force(p)
        _, n = project(p)
        f = f - jnp.sum(f * n, -1, keepdims=True) * n   # tangential
        norm = jnp.linalg.norm(f, axis=-1, keepdims=True)
        stepv = (step_factor * dp) * f / jnp.maximum(norm, 1e-30) \
            * jnp.minimum(norm, 1.0)
        p2, _ = project(p + stepv)
        return p2, None

    p_fin, _ = jax.lax.scan(sweep, pos0, None, length=n_iter)
    p_fin, n_fin = project(p_fin)
    return np.asarray(p_fin), np.asarray(n_fin)


def min_pair_distance(pos) -> float:
    p = np.asarray(pos)
    d = np.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float(d.min())
