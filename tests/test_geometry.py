"""Shape / CSG / lattice-generator tests (counterpart of the geometry
contain/distance unit tests in the reference tests/unit_tests_src)."""

import numpy as np
import jax.numpy as jnp

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.generators import generate_lattice


def test_box_contains_and_sdf():
    box = G.Box(G.Transform(translation=(1.0, 2.0)), halfsize=(1.0, 0.5))
    pts = jnp.asarray([[1.0, 2.0], [2.5, 2.0], [1.9, 2.4], [1.0, 2.6]])
    inside = np.asarray(box.contains(pts))
    assert list(inside) == [True, False, True, False]
    sd = np.asarray(box.signed_distance(pts))
    np.testing.assert_allclose(sd[0], -0.5, atol=1e-6)
    np.testing.assert_allclose(sd[1], 0.5, atol=1e-6)


def test_box_normal_direction():
    box = G.Box(G.Transform(translation=(0.0, 0.0)), halfsize=(1.0, 1.0))
    # inside point near the right face: outward normal = +x
    n = np.asarray(box.find_normal_direction(jnp.asarray([[0.9, 0.0]])))
    np.testing.assert_allclose(n, [[1.0, 0.0]], atol=1e-6)


def test_ball():
    ball = G.Ball(center=(0.0, 0.0, 0.0), radius=2.0)
    sd = float(ball.signed_distance(jnp.asarray([1.0, 0.0, 0.0])))
    assert abs(sd + 1.0) < 1e-6


def test_complex_shape_dambreak_wall():
    """The dambreak wall: outer box minus inner box (Dambreak.cpp:39-47)."""
    DL, DH, BW = 5.366, 5.366, 0.1
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + BW, DH / 2 + BW))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall = G.make_complex(("add", outer), ("sub", inner))
    pts = jnp.asarray([
        [-BW / 2, DH / 2],   # in the left wall band
        [DL / 2, DH / 2],    # middle of the tank: not wall
        [DL / 2, -BW / 2],   # floor band
        [-2 * BW, DH / 2],   # outside everything
    ])
    inside = np.asarray(wall.contains(pts))
    assert list(inside) == [True, False, True, False]


def test_polygon():
    tri = G.Polygon(vertices=((0.0, 0.0), (2.0, 0.0), (0.0, 2.0)))
    pts = jnp.asarray([[0.5, 0.5], [1.5, 1.5], [0.1, 0.1]])
    inside = np.asarray(tri.contains(pts))
    assert list(inside) == [True, False, True]
    sd = float(tri.signed_distance(jnp.asarray([0.5, -0.5])))
    assert abs(sd - 0.5) < 1e-6


def test_lattice_generator_counts():
    """Particle count for a box fill matches area/dx^2 (lattice generator,
    particle_generator_lattice_2d.cpp:12-24)."""
    dx = 0.05
    box = G.Box(G.Transform(translation=(1.0, 0.5)), halfsize=(1.0, 0.5))
    pos, vol = generate_lattice(box, (0.0, 0.0), (2.0, 1.0), dx)
    assert vol == dx * dx
    expected = round(2.0 / dx) * round(1.0 / dx)
    assert abs(len(pos) - expected) <= 0.02 * expected
    assert pos.min() > 0.0 and pos[:, 0].max() < 2.0


def test_surface_lattice_generator_ring():
    """Surface (shell) lattice generator on a 2D circular ring
    (ParticleGenerator<SurfaceParticles, Lattice>,
    particle_generator_lattice_2d.cpp:26-70): the planned count equals
    shell volume / (spacing^(d-1) * thickness), every particle lies within
    the thin volume, the volumetric measure is the AREA spacing^(d-1), and
    normals are radial after one-side orientation."""
    from sphinxsys_jax.core.generators import (
        generate_surface_lattice, consistent_shell_normals)

    R, t, dx = 1.0, 0.05, 0.025
    ring = G.make_complex(
        ("add", G.Ball(center=(0.0, 0.0), radius=R + 0.5 * t)),
        ("sub", G.Ball(center=(0.0, 0.0), radius=R - 0.5 * t)))
    lo, hi = (-1.2, -1.2), (1.2, 1.2)
    pos, normals, area = generate_surface_lattice(ring, lo, hi, dx, t)

    assert area == dx  # spacing^(d-1)
    planned = 2 * np.pi * R * t / (dx * t)  # ~ perimeter / spacing
    assert abs(len(pos) - planned) < 0.08 * planned
    r = np.linalg.norm(pos, axis=1)
    assert r.min() >= R - 0.5 * t - 1e-12 and r.max() <= R + 0.5 * t + 1e-12

    # raw normals are unit and radial (either side of the mid-surface)
    assert np.allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5)
    rhat = pos / r[:, None]
    align = np.sum(normals * rhat, axis=1)
    assert np.all(np.abs(align) > 0.97)
    # one-side orientation makes them all point outward
    n_out = consistent_shell_normals(pos, normals, lambda p: p)
    assert np.all(np.sum(n_out * rhat, axis=1) > 0.97)

    # determinism: same seed -> identical distribution
    pos2, _, _ = generate_surface_lattice(ring, lo, hi, dx, t)
    assert np.array_equal(pos, pos2)


def test_multi_polygon_shape():
    """make_multi_polygon: the reference's MultiPolygonShape add/sub chain
    — an L-shape built as square minus corner square, exact containment."""
    L = G.make_multi_polygon(
        ("add", [(0, 0), (2, 0), (2, 2), (0, 2)]),
        ("sub", [(1, 1), (2, 1), (2, 2), (1, 2)]))
    pts = jnp.asarray([[0.5, 0.5], [1.5, 0.5], [1.5, 1.5], [0.5, 1.5],
                       [2.5, 0.5]])
    inside = np.asarray(L.contains(pts))
    assert list(inside) == [True, True, False, True, False]
