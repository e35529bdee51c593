"""Geometry: shapes as signed-distance functions with CSG composition.

JAX counterpart of /root/reference/src/shared/geometries/
(Shape ABC base_geometry.h:69-90, BinaryShapes CSG :106, GeometricShapeBox/
Ball geometric_shape.h, TransformShape transform_geometry.h, 2D
MultiPolygon for_2D_build/geometries/multi_polygon_shape.h).

Instead of virtual checkContain/findClosestPoint methods, every shape is a
dataclass exposing vectorizable pure functions:
    contains(pos)         -> bool per point   (exact)
    signed_distance(pos)  -> negative inside  (exact for primitives,
                             max/min CSG approximation for composites)
    normal(pos)           -> unit gradient of the SDF, pointing outward
                             when outside / toward the surface sign
                             convention of the reference
    bounds()              -> (lower, upper) numpy arrays

The reference convention (base_geometry.cpp findNormalDirection): the
returned normal points from the query point TOWARD the far side of the
surface — i.e. for a point inside the shape it points outward to the
closest surface, for a point outside it points inward.  We reproduce that:
``normal = -grad(|sd|) direction to surface``; see `find_normal_direction`.
Its `findSignedDistance` is negative inside; we match that.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Transform:
    """Rigid transform: x_global = R @ x_local + t (transform_geometry.h)."""

    translation: Tuple[float, ...]
    rotation: Tuple[Tuple[float, ...], ...] | None = None  # row tuples

    def to_local(self, pos):
        t = jnp.asarray(self.translation, dtype=pos.dtype)
        x = pos - t
        if self.rotation is not None:
            R = jnp.asarray(self.rotation, dtype=pos.dtype)
            x = x @ R  # R^T @ x, batched: x @ R == (R.T @ x.T).T
        return x

    def to_global(self, pos):
        x = pos
        if self.rotation is not None:
            R = jnp.asarray(self.rotation, dtype=pos.dtype)
            x = x @ R.T
        t = jnp.asarray(self.translation, dtype=pos.dtype)
        return x + t


class Shape:
    """Base shape interface. Positions are (..., dim) arrays."""

    name: str = "Shape"

    def signed_distance(self, pos):
        raise NotImplementedError

    def contains(self, pos):
        return self.signed_distance(pos) < 0.0

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def find_normal_direction(self, pos):
        """Reference-convention normal (see module docstring): unit gradient
        of the signed distance (points outward everywhere the SDF is exact)."""
        sd_sum = lambda p: jnp.sum(self.signed_distance(p))
        g = jax.grad(sd_sum)(pos)
        return g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-30)


@dataclasses.dataclass(frozen=True)
class Box(Shape):
    """Axis-aligned (optionally transformed) box given by halfsize, local
    center at origin (GeometricShapeBox, geometric_shape.h)."""

    transform: Transform
    halfsize: Tuple[float, ...]
    name: str = "Box"

    def signed_distance(self, pos):
        x = self.transform.to_local(pos)
        hs = jnp.asarray(self.halfsize, dtype=pos.dtype)
        d = jnp.abs(x) - hs
        d_pos = jnp.maximum(d, 0.0)
        sq = jnp.sum(d_pos * d_pos, axis=-1)
        # safe norm: keeps the gradient finite at interior points (sq == 0)
        outside = jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1.0)), 0.0)
        inside = jnp.minimum(jnp.max(d, axis=-1), 0.0)
        return outside + inside

    def bounds(self):
        hs = np.asarray(self.halfsize, dtype=np.float64)
        t = np.asarray(self.transform.translation, dtype=np.float64)
        if self.transform.rotation is not None:
            R = np.asarray(self.transform.rotation, dtype=np.float64)
            hs = np.abs(R) @ hs
        return t - hs, t + hs


@dataclasses.dataclass(frozen=True)
class Ball(Shape):
    """Sphere/circle (GeometricShapeBall)."""

    center: Tuple[float, ...]
    radius: float
    name: str = "Ball"

    def signed_distance(self, pos):
        c = jnp.asarray(self.center, dtype=pos.dtype)
        d = pos - c
        sq = jnp.sum(d * d, axis=-1)
        # safe sqrt: keeps the gradient finite at the exact center
        r = jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1.0)), 0.0)
        return r - self.radius

    def bounds(self):
        c = np.asarray(self.center, dtype=np.float64)
        r = self.radius
        return c - r, c + r


@dataclasses.dataclass(frozen=True)
class Ellipsoid(Shape):
    """Axis-aligned ellipsoid (the procedural stand-in for STL organ
    geometries): the standard first-order SDF approximation
    sd = k0 (k0 - 1) / k1 with k0 = |p/r|, k1 = |p/r^2| — exact sign
    everywhere, distance accurate near the surface (where generators and
    network growth use it)."""

    center: Tuple[float, ...]
    semi_axes: Tuple[float, ...]
    name: str = "Ellipsoid"

    def signed_distance(self, pos):
        c = jnp.asarray(self.center, dtype=pos.dtype)
        r = jnp.asarray(self.semi_axes, dtype=pos.dtype)
        p = pos - c
        k0 = jnp.sqrt(jnp.sum((p / r) ** 2, axis=-1) + 1e-30)
        k1 = jnp.sqrt(jnp.sum((p / (r * r)) ** 2, axis=-1) + 1e-30)
        return k0 * (k0 - 1.0) / k1

    def bounds(self):
        c = np.asarray(self.center, dtype=np.float64)
        r = np.asarray(self.semi_axes, dtype=np.float64)
        return c - r, c + r


@dataclasses.dataclass(frozen=True)
class Cylinder(Shape):
    """Finite circular cylinder (TriangleMeshShapeCylinder analog):
    `axis` is the symmetry direction (unit-normalized), `halflength` the
    half-height.  Exact SDF from the (radial, axial) 2D box distance."""

    center: Tuple[float, ...]
    axis: Tuple[float, ...]
    radius: float
    halflength: float
    name: str = "Cylinder"

    def signed_distance(self, pos):
        c = jnp.asarray(self.center, dtype=pos.dtype)
        a = np.asarray(self.axis, dtype=np.float64)
        a = jnp.asarray(a / np.linalg.norm(a), dtype=pos.dtype)
        p = pos - c
        ax = jnp.sum(p * a, axis=-1)
        rad_vec = p - ax[..., None] * a
        rad = jnp.sqrt(jnp.sum(rad_vec * rad_vec, axis=-1) + 1e-30)
        dr = rad - self.radius
        dz = jnp.abs(ax) - self.halflength
        outside = jnp.sqrt(jnp.maximum(dr, 0.0) ** 2
                           + jnp.maximum(dz, 0.0) ** 2)
        inside = jnp.minimum(jnp.maximum(dr, dz), 0.0)
        return outside + inside

    def bounds(self):
        c = np.asarray(self.center, dtype=np.float64)
        ext = self.radius + self.halflength  # loose box (any axis tilt)
        return c - ext, c + ext


@dataclasses.dataclass(frozen=True)
class HalfSpace(Shape):
    """Half space {x : (x - point) . normal < 0}; useful for open walls."""

    point: Tuple[float, ...]
    outward_normal: Tuple[float, ...]
    name: str = "HalfSpace"

    def signed_distance(self, pos):
        p = jnp.asarray(self.point, dtype=pos.dtype)
        n = jnp.asarray(self.outward_normal, dtype=pos.dtype)
        n = n / jnp.linalg.norm(n)
        return (pos - p) @ n

    def bounds(self):
        big = 1e30
        d = len(self.point)
        return -big * np.ones(d), big * np.ones(d)


@dataclasses.dataclass(frozen=True)
class InverseShape(Shape):
    """Sign-flipped wrapper (InverseShape<>, base_geometry.h): inside and
    outside swap — used to confine a fluid OUTSIDE an obstacle
    (static_confinement.cpp:147)."""

    base: Shape
    name: str = "InverseShape"

    def signed_distance(self, pos):
        return -self.base.signed_distance(pos)

    def contains(self, pos):
        return ~self.base.contains(pos)

    def bounds(self):
        return self.base.bounds()


@dataclasses.dataclass(frozen=True)
class Polygon(Shape):
    """2D simple polygon by vertex list (counter-clockwise), counterpart of
    MultiPolygonShape (for_2D_build/geometries/multi_polygon_shape.h).
    Exact SDF by edge-distance + winding parity."""

    vertices: Tuple[Tuple[float, float], ...]
    name: str = "Polygon"

    def signed_distance(self, pos):
        v = jnp.asarray(self.vertices, dtype=pos.dtype)  # (M, 2)
        w = jnp.roll(v, -1, axis=0)  # next vertex
        p = pos[..., None, :]  # (..., 1, 2)
        e = w - v  # (M, 2)
        pv = p - v  # (..., M, 2)
        t = jnp.clip(jnp.sum(pv * e, -1) / (jnp.sum(e * e, -1) + 1e-30), 0.0, 1.0)
        proj = v + t[..., None] * e
        dist = jnp.linalg.norm(p - proj, axis=-1)  # (..., M)
        d = jnp.min(dist, axis=-1)
        # crossing-number parity for inside test
        x, y = pos[..., 0:1], pos[..., 1:2]
        cond = (v[:, 1] <= y) != (w[:, 1] <= y)
        xcross = v[:, 0] + (y - v[:, 1]) * e[:, 0] / jnp.where(e[:, 1] == 0, 1e-30, e[:, 1])
        crossings = jnp.sum(jnp.where(cond & (x < xcross), 1, 0), axis=-1)
        inside = crossings % 2 == 1
        return jnp.where(inside, -d, d)

    def bounds(self):
        v = np.asarray(self.vertices, dtype=np.float64)
        return v.min(0), v.max(0)


@dataclasses.dataclass(frozen=True)
class ComplexShape(Shape):
    """CSG add/subtract composition (BinaryShapes, base_geometry.h:106).
    `ops` parallel to `shapes`: +1 add, -1 subtract, applied left to right.
    Containment is exact (sequential fold); the SDF is the usual
    max/min CSG approximation (exact away from CSG seams)."""

    shapes: Tuple[Shape, ...]
    ops: Tuple[int, ...]
    name: str = "ComplexShape"

    def contains(self, pos):
        inside = jnp.zeros(pos.shape[:-1], dtype=bool)
        for s, op in zip(self.shapes, self.ops):
            si = s.contains(pos)
            inside = jnp.where(jnp.asarray(op > 0), inside | si, inside & ~si)
        return inside

    def signed_distance(self, pos):
        sd = jnp.full(pos.shape[:-1], 1e30, dtype=pos.dtype)
        for s, op in zip(self.shapes, self.ops):
            si = s.signed_distance(pos)
            sd = jnp.minimum(sd, si) if op > 0 else jnp.maximum(sd, -si)
        return sd

    def bounds(self):
        los, his = [], []
        for s, op in zip(self.shapes, self.ops):
            if op > 0:
                lo, hi = s.bounds()
                los.append(lo)
                his.append(hi)
        return np.min(np.stack(los), 0), np.max(np.stack(his), 0)


def make_multi_polygon(*parts: Tuple[str, Sequence]) -> ComplexShape:
    """MultiPolygonShape (for_2D_build/geometries/multi_polygon_shape.h):
    a CSG chain of 2D polygons from ("add"|"sub", vertex_list) pairs —
    the reference's addAPolygon(..., GeometricOps::add/sub) sequence.
    Each polygon uses the exact edge-distance SDF; no triangulation
    (earcut) is needed because containment is computed by crossing
    parity, not by triangle decomposition."""
    return make_complex(*[(op, Polygon(vertices=tuple(map(tuple, v))))
                          for op, v in parts])


def make_complex(*parts: Tuple[str, Shape]) -> ComplexShape:
    """Build a ComplexShape from ("add"|"sub", shape) pairs, mirroring the
    reference's `add<>`/`subtract<>` API (ComplexShape, complex_geometry.h)."""
    shapes, ops = [], []
    for op, s in parts:
        shapes.append(s)
        ops.append(+1 if op == "add" else -1)
    return ComplexShape(tuple(shapes), tuple(ops))
