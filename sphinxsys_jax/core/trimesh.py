"""Triangle-mesh 3D geometry (STL) — vectorized signed distance.

Counterpart of /root/reference/src/for_3D_build/geometries/
triangle_mesh_shape.{h,cpp} (TriangleMeshShapeSTL/Brick/Sphere/Cylinder,
stl_reader.h, TriangleMeshDistance.h): the reference wraps SimTK contact
geometry plus a BVH point-mesh distance.

XLA-first design: a BVH tree walk is branchy, pointer-chasing work that
XLA cannot vectorize.  Instead the signed distance is a DENSE batched
point-to-triangle computation — an (N_points, N_triangles) problem tiled
through the vectorized closest-point formula, with the sign
from the generalized winding number (Jacobson et al. 2013, robust for
arbitrary watertight meshes and exact for the solid angle of closed
surfaces).  For the mesh sizes SPH scenes use (1e3-1e5 triangles) this is
regular data-parallel work with no branching, and it is differentiable
like every other SDF in core/geometry.py.

Shapes created here implement the same Shape protocol (signed_distance /
contains / bounds) so lattice generation, level-set probes, relaxation
and normal_direction_from_shape all work unchanged.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.geometry import Shape

TINY = 1.0e-15


# ---------------------------------------------------------------------------
# STL parsing (stl_reader.h counterpart; binary + ascii, numpy only)
# ---------------------------------------------------------------------------

def load_stl(path: str, scale: float = 1.0, offset=(0.0, 0.0, 0.0)):
    """Return (V, F): vertices (M,3) float64 and faces (T,3) int32."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    if head[:5] == b"solid" and b"facet" in data[:500]:
        tris = _parse_ascii_stl(data.decode("ascii", errors="ignore"))
    else:
        tris = _parse_binary_stl(data)
    tris = tris * scale + np.asarray(offset)
    verts, inv = np.unique(tris.reshape(-1, 3).round(12), axis=0,
                           return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts, faces


def _parse_binary_stl(data: bytes) -> np.ndarray:
    n = struct.unpack_from("<I", data, 80)[0]
    rec = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
    rec = rec.reshape(n, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
    return tri.astype(np.float64)


def _parse_ascii_stl(text: str) -> np.ndarray:
    pts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            pts.append([float(v) for v in line.split()[1:4]])
    tri = np.asarray(pts, np.float64)
    return tri.reshape(-1, 3, 3)


# ---------------------------------------------------------------------------
# Dense point-to-mesh signed distance
# ---------------------------------------------------------------------------

def _closest_point_on_triangles(p, a, b, c):
    """Vectorized Ericson closest-point-on-triangle: p (..., 1, 3) against
    triangles a/b/c (T, 3).  Returns squared distances (..., T)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = jnp.sum(ab * ap, -1)
    d2 = jnp.sum(ac * ap, -1)
    bp = p - b
    d3 = jnp.sum(ab * bp, -1)
    d4 = jnp.sum(ac * bp, -1)
    cp = p - c
    d5 = jnp.sum(ab * cp, -1)
    d6 = jnp.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc

    # barycentric candidates, clamped per Ericson's region tests
    v_ab = jnp.clip(d1 / (d1 - d3 + TINY), 0.0, 1.0)
    w_ac = jnp.clip(d2 / (d2 - d6 + TINY), 0.0, 1.0)
    w_bc = jnp.clip((d4 - d3) / ((d4 - d3) + (d5 - d6) + TINY), 0.0, 1.0)
    v_in = vb / (denom + TINY)
    w_in = vc / (denom + TINY)

    # region selection
    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = (~in_vert_a) & (~in_vert_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = (~in_vert_a) & (~in_vert_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = (~in_vert_b) & (~in_vert_c) & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    q_in = a + v_in[..., None] * ab + w_in[..., None] * ac
    q = q_in
    q = jnp.where(in_edge_bc[..., None], b + w_bc[..., None] * (c - b), q)
    q = jnp.where(in_edge_ac[..., None], a + w_ac[..., None] * ac, q)
    q = jnp.where(in_edge_ab[..., None], a + v_ab[..., None] * ab, q)
    q = jnp.where(in_vert_c[..., None], c, q)
    q = jnp.where(in_vert_b[..., None], b, q)
    q = jnp.where(in_vert_a[..., None], a, q)
    d = p - q
    return jnp.sum(d * d, -1)


def _winding_number(p, a, b, c):
    """Generalized winding number via the van Oosterom-Strackee solid
    angle of each triangle; sums to ~1 inside a watertight mesh."""
    ra = a - p
    rb = b - p
    rc = c - p
    la = jnp.linalg.norm(ra, axis=-1)
    lb = jnp.linalg.norm(rb, axis=-1)
    lc = jnp.linalg.norm(rc, axis=-1)
    num = jnp.sum(ra * jnp.cross(rb, rc), -1)
    den = (la * lb * lc + jnp.sum(ra * rb, -1) * lc
           + jnp.sum(rb * rc, -1) * la + jnp.sum(rc * ra, -1) * lb)
    omega = 2.0 * jnp.arctan2(num, den)
    return jnp.sum(omega, -1) / (4.0 * jnp.pi)


@dataclasses.dataclass(frozen=True)
class TriangleMesh(Shape):
    """Watertight triangle-mesh shape (TriangleMeshShapeSTL counterpart)."""

    vertices: Tuple[Tuple[float, float, float], ...]
    faces: Tuple[Tuple[int, int, int], ...]
    name: str = "TriangleMesh"

    @staticmethod
    def from_arrays(verts, faces, name: str = "TriangleMesh"):
        return TriangleMesh(vertices=tuple(map(tuple, np.asarray(verts))),
                            faces=tuple(map(tuple, np.asarray(faces))),
                            name=name)

    @staticmethod
    def from_stl(path: str, scale: float = 1.0, offset=(0.0, 0.0, 0.0)):
        v, f = load_stl(path, scale, offset)
        return TriangleMesh.from_arrays(v, f, name=path)

    def _tris(self, dtype):
        v = jnp.asarray(self.vertices, dtype)
        f = jnp.asarray(self.faces, jnp.int32)
        return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    def signed_distance(self, pos):
        squeeze = pos.ndim == 1
        p = jnp.atleast_2d(pos)[:, None, :]           # (N, 1, 3)
        a, b, c = self._tris(pos.dtype)
        d2 = _closest_point_on_triangles(p, a, b, c)  # (N, T)
        dist = jnp.sqrt(jnp.min(d2, axis=-1) + TINY)
        wn = _winding_number(p, a, b, c)              # (N,)
        sd = jnp.where(wn > 0.5, -dist, dist)
        return sd[0] if squeeze else sd

    def bounds(self):
        v = np.asarray(self.vertices)
        return v.min(0), v.max(0)


def box_mesh(halfsize=(0.5, 0.5, 0.5), center=(0.0, 0.0, 0.0)):
    """12-triangle brick (TriangleMeshShapeBrick counterpart)."""
    hx, hy, hz = halfsize
    cx, cy, cz = center
    v = np.asarray([[sx * hx + cx, sy * hy + cy, sz * hz + cz]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    # outward-oriented faces of the unit cube (vertex index = 4sx+2sy+sz bits)
    f = np.asarray([
        [0, 1, 3], [0, 3, 2],   # -x
        [4, 6, 7], [4, 7, 5],   # +x
        [0, 4, 5], [0, 5, 1],   # -y
        [2, 3, 7], [2, 7, 6],   # +y
        [0, 2, 6], [0, 6, 4],   # -z
        [1, 5, 7], [1, 7, 3],   # +z
    ], np.int32)
    return TriangleMesh.from_arrays(v, f, name="Brick")


def icosphere_mesh(radius: float = 0.5, center=(0.0, 0.0, 0.0),
                   subdivisions: int = 2):
    """Subdivided icosahedron (TriangleMeshShapeSphere counterpart)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        verts = list(map(tuple, v))
        index = {w: i for i, w in enumerate(verts)}
        new_f = []

        def mid(i, j):
            m = tuple((v[i] + v[j]) / np.linalg.norm(v[i] + v[j]))
            if m not in index:
                index[m] = len(verts)
                verts.append(m)
            return index[m]

        for (i, j, k) in f:
            ij, jk, ki = mid(i, j), mid(j, k), mid(k, i)
            new_f += [(i, ij, ki), (j, jk, ij), (k, ki, jk), (ij, jk, ki)]
            v = np.asarray(verts)
        f = new_f
    v = v * radius + np.asarray(center)
    return TriangleMesh.from_arrays(v, np.asarray(f, np.int32), name="Sphere")
