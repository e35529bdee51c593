"""Image-based geometry: shapes from voxel distance maps.

JAX counterpart of /root/reference/src/for_3D_build/geometries/
image_shape.h + image_mhd.h (ImageShape / ImageShapeFromFile, used by
tests/3d_examples/test_3d_load_image/): the geometry is a 3D voxel image
whose voxels hold a signed distance map; `checkContain` and
`findClosestPoint` interpolate the image trilinearly
(image_mhd.hpp findValueAndGradientAtPoint).

Here the shape is a dataclass whose `signed_distance` is a pure jittable
trilinear interpolation, so the image gradient used by the reference for
normals comes for free through `Shape.find_normal_direction` (autodiff of
the interpolant).  Outside the voxel lattice the interpolant is clamped to
the border cell and the Euclidean distance to that cell is added, keeping
lattice generation over a padded domain sane.

MetaImage (.mhd header + .raw payload) reading/writing supports the
reference's on-disk format (image_mhd.hpp read/write): ASCII key = value
header with NDims/DimSize/ElementSpacing/Offset/ElementType/
ElementDataFile, raw little-endian voxel payload, x fastest-varying.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Tuple

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.geometry import Shape

_MET_TYPES = {"MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
              "MET_SHORT": np.int16, "MET_UCHAR": np.uint8}


@dataclasses.dataclass(frozen=True, eq=False)
class ImageShape(Shape):
    """Voxel signed-distance-map shape.  `data` is (nx, ny, nz) with
    data[i, j, k] the signed distance at
    origin + (i, j, k) * spacing (negative inside)."""

    data: Any
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    name: str = "ImageShape"

    def signed_distance(self, pos):
        img = jnp.asarray(np.asarray(self.data))
        img = img.astype(pos.dtype)
        sp = jnp.asarray(self.spacing, pos.dtype)
        org = jnp.asarray(self.origin, pos.dtype)
        u = (pos - org) / sp
        hi = jnp.asarray(img.shape, pos.dtype) - 1.0
        uc = jnp.clip(u, 0.0, hi - 1e-5)
        i0 = jnp.floor(uc).astype(jnp.int32)
        f = uc - i0

        def corner(di, dj, dk):
            return img[i0[..., 0] + di, i0[..., 1] + dj, i0[..., 2] + dk]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        c00 = corner(0, 0, 0) * (1 - fx) + corner(1, 0, 0) * fx
        c10 = corner(0, 1, 0) * (1 - fx) + corner(1, 1, 0) * fx
        c01 = corner(0, 0, 1) * (1 - fx) + corner(1, 0, 1) * fx
        c11 = corner(0, 1, 1) * (1 - fx) + corner(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        sd = c0 * (1 - fz) + c1 * fz
        # out-of-lattice queries: add the distance to the clamped point
        # (safe norm: zero with a finite gradient for interior points)
        d = (u - uc) * sp
        sq = jnp.sum(d * d, axis=-1)
        outside = jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1.0)), 0.0)
        return sd + outside

    def bounds(self):
        org = np.asarray(self.origin, np.float64)
        ext = (np.asarray(np.asarray(self.data).shape, np.float64) - 1.0) \
            * np.asarray(self.spacing, np.float64)
        return org, org + ext


def sphere_distance_image(shape=(50, 50, 50), spacing=(1.0, 1.0, 1.0),
                          origin=(-24.5, -24.5, -24.5), radius=20.0,
                          center=(0.0, 0.0, 0.0)) -> ImageShape:
    """Procedural analog of the reference's shipped sphere.mhd distance
    image (test_3d_load_image/data/sphere.mhd: 50^3 voxels holding the
    signed distance to a sphere)."""
    ax = [origin[d] + spacing[d] * np.arange(shape[d]) for d in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    c = center
    sd = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - radius
    return ImageShape(data=sd.astype(np.float32), spacing=spacing,
                      origin=origin)


def save_mhd(path: str, image: ImageShape) -> None:
    """Write the MetaImage pair (<path>.mhd + <path>.raw)."""
    base = path[:-4] if path.endswith(".mhd") else path
    data = np.asarray(image.data, np.float32)
    raw_name = os.path.basename(base) + ".raw"
    # MetaImage stores x fastest-varying: transpose (i,j,k)->(k,j,i) order
    with open(base + ".raw", "wb") as f:
        f.write(np.ascontiguousarray(data.transpose(2, 1, 0)).tobytes())
    with open(base + ".mhd", "w") as f:
        f.write("ObjectType = Image\nNDims = 3\nBinaryData = True\n"
                "BinaryDataByteOrderMSB = False\n"
                f"DimSize = {data.shape[0]} {data.shape[1]} {data.shape[2]}\n"
                f"ElementSpacing = {image.spacing[0]} {image.spacing[1]} "
                f"{image.spacing[2]}\n"
                f"Offset = {image.origin[0]} {image.origin[1]} "
                f"{image.origin[2]}\n"
                "ElementType = MET_FLOAT\n"
                f"ElementDataFile = {raw_name}\n")


def load_mhd(path: str) -> ImageShape:
    """Read a MetaImage .mhd header + .raw distance map into an
    ImageShape (image_mhd.hpp ImageMHD<float, 3>::ImageMHD)."""
    header = {}
    with open(path) as f:
        for line in f:
            if "=" in line:
                k, v = line.split("=", 1)
                header[k.strip()] = v.strip()
    if int(header.get("NDims", "3")) != 3:
        raise ValueError("only 3D MetaImages supported")
    dims = tuple(int(x) for x in header["DimSize"].split())
    spacing = tuple(float(x) for x in
                    header.get("ElementSpacing", "1 1 1").split())
    origin = tuple(float(x) for x in
                   header.get("Offset", header.get("Origin", "0 0 0")).split())
    dtype = _MET_TYPES[header.get("ElementType", "MET_FLOAT")]
    if header.get("BinaryDataByteOrderMSB", "False") == "True":
        dtype = np.dtype(dtype).newbyteorder(">")
    raw_path = os.path.join(os.path.dirname(path), header["ElementDataFile"])
    data = np.fromfile(raw_path, dtype=dtype)
    if data.size != dims[0] * dims[1] * dims[2]:
        raise ValueError(f"raw payload size {data.size} != DimSize {dims}")
    # stored x fastest-varying -> our (i,j,k) = (x,y,z) index order
    data = data.reshape(dims[2], dims[1], dims[0]).transpose(2, 1, 0)
    return ImageShape(data=np.asarray(data, np.float32), spacing=spacing,
                      origin=origin)
