"""Image-based geometry (tests/3d_examples/test_3d_load_image/ +
src/for_3D_build/geometries/image_shape.h): voxel distance-map shapes
with trilinear interpolation, MetaImage .mhd/.raw IO, and body-fitted
particle generation from the image."""

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import image as I
from sphinxsys_jax.core.generators import generate_lattice

RADIUS = 20.0


def test_mhd_roundtrip(tmp_path):
    img = I.sphere_distance_image(radius=RADIUS)
    I.save_mhd(str(tmp_path / "sphere.mhd"), img)
    back = I.load_mhd(str(tmp_path / "sphere.mhd"))
    assert np.allclose(np.asarray(back.data), np.asarray(img.data))
    assert back.spacing == img.spacing and back.origin == img.origin


def test_trilinear_sdf_and_normals():
    """Interpolated distances match the analytic sphere SDF to O(h^2)
    inside the image and degrade gracefully outside its lattice."""
    img = I.sphere_distance_image(radius=RADIUS)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-24.0, 24.0, (500, 3)).astype(np.float32)
    sd = np.asarray(img.signed_distance(jnp.asarray(pts)))
    exact = np.linalg.norm(pts, axis=1) - RADIUS
    assert np.abs(sd - exact).max() < 0.05  # h = 1, curvature-bounded

    # image-gradient normal (findValueAndGradientAtPoint) ~ radial
    surf = pts / np.linalg.norm(pts, axis=1, keepdims=True) * RADIUS
    n = np.asarray(img.find_normal_direction(jnp.asarray(surf)))
    radial = surf / RADIUS
    assert np.abs(np.sum(n * radial, axis=1) - 1.0).max() < 1e-2

    # far outside the voxel lattice: clamped + euclidean fallback stays
    # positive and monotone
    far = np.array([[40.0, 0.0, 0.0], [80.0, 0.0, 0.0]], np.float32)
    sd_far = np.asarray(img.signed_distance(jnp.asarray(far)))
    assert sd_far[0] > 0 and sd_far[1] > sd_far[0]


def test_lattice_generation_from_image():
    """The load_image pipeline: lattice particles inside the image shape
    fill the analytic sphere volume (generateParticles<Lattice> over
    the ImageShape level set)."""
    img = I.sphere_distance_image(radius=RADIUS)
    dx = 2.0
    pos, vol = generate_lattice(img, (-24.0, -24.0, -24.0),
                                (24.0, 24.0, 24.0), dx)
    n = len(pos)
    v_total = n * float(np.asarray(vol).reshape(-1)[0]) if np.ndim(vol) \
        else n * float(vol)
    v_exact = 4.0 / 3.0 * np.pi * RADIUS ** 3
    assert abs(v_total - v_exact) / v_exact < 0.05
    r = np.linalg.norm(np.asarray(pos), axis=1)
    assert r.max() < RADIUS + dx
