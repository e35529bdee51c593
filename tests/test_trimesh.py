"""Triangle-mesh (STL) geometry tests (TriangleMeshShape counterpart)."""

import os

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import trimesh as tm


def test_box_mesh_signed_distance_matches_analytic():
    box = tm.box_mesh(halfsize=(0.5, 0.4, 0.3))
    pts = jnp.asarray([
        [0.0, 0.0, 0.0],     # center: -min(halfsize)
        [0.45, 0.0, 0.0],    # near +x face inside
        [0.8, 0.0, 0.0],     # outside +x
        [0.0, 0.0, 0.6],     # outside +z
        [0.9, 0.8, 0.0],     # outside edge region
    ])
    sd = np.asarray(box.signed_distance(pts))
    np.testing.assert_allclose(sd[0], -0.3, atol=1e-6)
    np.testing.assert_allclose(sd[1], -0.05, atol=1e-6)
    np.testing.assert_allclose(sd[2], 0.3, atol=1e-6)
    np.testing.assert_allclose(sd[3], 0.3, atol=1e-6)
    np.testing.assert_allclose(sd[4], np.hypot(0.4, 0.4), atol=1e-6)


def test_icosphere_sdf_and_lattice_fill():
    sph = tm.icosphere_mesh(radius=0.5, subdivisions=3)
    r = np.linspace(0.05, 0.95, 10)
    pts = jnp.asarray(np.stack([r, np.zeros(10), np.zeros(10)], -1))
    sd = np.asarray(sph.signed_distance(pts))
    # icosphere slightly under-approximates the ball; 1% tolerance
    np.testing.assert_allclose(sd, r - 0.5, atol=6e-3)

    # shape protocol works with the lattice generator
    from sphinxsys_jax.core.generators import generate_lattice

    pos, vol = generate_lattice(sph, (-0.6, -0.6, -0.6), (0.6, 0.6, 0.6), 0.1)
    count = len(pos)
    expect = 4.0 / 3.0 * np.pi * 0.5**3 / 0.1**3
    assert abs(count - expect) / expect < 0.1


def test_stl_roundtrip_binary_and_ascii(tmp_path):
    box = tm.box_mesh(halfsize=(0.5, 0.5, 0.5))
    v = np.asarray(box.vertices)
    f = np.asarray(box.faces)
    tris = v[f]  # (12, 3, 3)

    # binary STL
    bpath = os.path.join(tmp_path, "box.stl")
    with open(bpath, "wb") as fh:
        fh.write(b"\0" * 80)
        import struct
        fh.write(struct.pack("<I", len(tris)))
        for t in tris:
            fh.write(np.zeros(3, "<f4").tobytes())
            fh.write(t.astype("<f4").tobytes())
            fh.write(b"\0\0")
    mesh = tm.TriangleMesh.from_stl(bpath)
    assert len(mesh.faces) == 12
    sd = float(mesh.signed_distance(jnp.asarray([0.0, 0.0, 0.0])))
    np.testing.assert_allclose(sd, -0.5, atol=1e-6)

    # ascii STL
    apath = os.path.join(tmp_path, "box_ascii.stl")
    with open(apath, "w") as fh:
        fh.write("solid box\n")
        for t in tris:
            fh.write(" facet normal 0 0 0\n  outer loop\n")
            for p in t:
                fh.write(f"   vertex {p[0]} {p[1]} {p[2]}\n")
            fh.write("  endloop\n endfacet\n")
        fh.write("endsolid box\n")
    mesh2 = tm.TriangleMesh.from_stl(apath)
    sd2 = float(mesh2.signed_distance(jnp.asarray([0.0, 0.0, 0.7])))
    np.testing.assert_allclose(sd2, 0.2, atol=1e-6)


def test_winding_number_inside_outside():
    sph = tm.icosphere_mesh(radius=0.5, subdivisions=2)
    a, b, c = sph._tris(jnp.float64)
    inside = jnp.asarray([[0.1, 0.1, 0.1]])[:, None, :]
    outside = jnp.asarray([[1.0, 0.0, 0.0]])[:, None, :]
    wn_in = float(tm._winding_number(inside, a, b, c)[0])
    wn_out = float(tm._winding_number(outside, a, b, c)[0])
    np.testing.assert_allclose(wn_in, 1.0, atol=1e-6)
    np.testing.assert_allclose(wn_out, 0.0, atol=1e-6)
