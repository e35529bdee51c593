"""Packaged narrow-band level set (meshes/levelset.py) vs the reference's
LevelSet/LevelSetShape semantics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.kernels import WendlandC2
from sphinxsys_jax.meshes import LevelSetShape, build_levelset

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

DX = 0.05


def _circle_ls(spacing=DX):
    circle = G.Ball(center=(0.0, 0.0), radius=1.0)
    return build_levelset(circle, (-2.0, -2.0), (2.0, 2.0), spacing=spacing)


def test_narrow_band_sparsity_and_probes():
    """Only packages near the interface hold data (SparseMeshField<4>);
    probes reproduce the circle's signed distance and radial normals to
    grid accuracy inside the band and the +/- far-field values outside."""
    ls = _circle_ls()
    assert ls.n_inner < 0.5 * ls.n_pkg[0] * ls.n_pkg[1]

    th = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    for rr in (0.85, 1.0, 1.15):
        pts = jnp.asarray(np.stack([rr * np.cos(th), rr * np.sin(th)], -1),
                          jnp.float32)
        sd = np.asarray(ls.probe_signed_distance(pts))
        assert np.abs(sd - (rr - 1.0)).max() < 0.02 * DX * 20
        n = np.asarray(ls.probe_normal_direction(pts))
        rhat = np.stack([np.cos(th), np.sin(th)], -1)
        assert (np.sum(n * rhat, axis=1) > 0.999).all()
    # far-field sentinels
    far = np.asarray(ls.probe_signed_distance(
        jnp.asarray([[1.9, 1.9], [0.0, 0.0]], jnp.float32)))
    assert far[0] > 10.0 and far[1] < -10.0


def test_reinitialization_recovers_distance():
    """Godunov reinitialization (ReinitializeLevelSet): starting from a
    3x-stretched field, |grad phi| returns to 1 in the band and the zero
    level set stays on the circle."""
    ls = _circle_ls()
    bad = dataclasses.replace(ls, phi=ls.phi * 3.0)
    fixed = bad.reinitialize(60)

    g = np.asarray(fixed.gradient())[:fixed.n_inner]
    gn = np.linalg.norm(g, axis=-1)
    phi = np.asarray(fixed.phi)[:fixed.n_inner]
    band = np.abs(phi) < 0.3
    assert abs(gn[band].mean() - 1.0) < 0.02
    assert gn[band].max() < 1.1 and gn[band].min() > 0.9

    th = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    pts = jnp.asarray(np.stack([1.2 * np.cos(th), 1.2 * np.sin(th)], -1),
                      jnp.float32)
    sd = np.asarray(fixed.probe_signed_distance(pts))
    assert np.abs(sd - 0.2).max() < 0.5 * DX


def test_kernel_integrals_half_space():
    """UpdateKernelIntegrals cut-cell quadrature against the flat-wall
    closed forms: W-integral = 1 deep in the positive region, 1/2 on the
    interface, 0 deep inside; the gradient integral points toward the
    positive side and peaks at the interface."""
    half = G.HalfSpace(point=(0.0, 0.0), outward_normal=(-1.0, 0.0))
    ls = build_levelset(half, (-2.0, -2.0), (2.0, 2.0), spacing=DX)
    ls = ls.update_kernel_integrals(WendlandC2(h=DX), dim=2)

    xs = np.asarray([-0.5, -0.15, 0.0, 0.15, 0.5])
    pts = jnp.asarray(np.stack([xs, np.zeros_like(xs)], -1), jnp.float32)
    kw = np.asarray(ls.probe_kernel_integral(pts))
    kg = np.asarray(ls.probe_kernel_gradient_integral(pts))
    assert kw[0] == pytest.approx(1.0, abs=1e-3)     # deep positive
    assert kw[1] == pytest.approx(1.0, abs=0.03)
    assert kw[2] == pytest.approx(0.5, abs=0.03)     # on the interface
    assert kw[4] == pytest.approx(0.0, abs=1e-3)     # deep inside
    assert kg[2, 0] < -1.0 / DX * 0.3                # toward positive x<0
    assert abs(kg[2, 1]) < 1e-3
    assert abs(kg[0, 0]) < 1e-3 and abs(kg[4, 0]) < 1e-3


def test_levelset_shape_drives_relaxation():
    """LevelSetShape is a drop-in Shape: particle relaxation against the
    mesh-probed geometry keeps particles inside and the surface bounded
    (the reference's level-set-backed RelaxationStepInner use)."""
    from sphinxsys_jax.core.generators import generate_lattice
    from sphinxsys_jax.physics.relax import relax_shape
    from sphinxsys_jax.core.adaptation import SPHAdaptation
    from sphinxsys_jax.neighbors import grid_from_bounds

    ls = _circle_ls()
    shape = LevelSetShape(ls)
    sd = np.asarray(shape.signed_distance(
        jnp.asarray([[0.5, 0.5]], jnp.float32)))[0]
    assert sd < 0
    pos, vol = generate_lattice(shape, (-1.2, -1.2), (1.2, 1.2), 0.1)
    area = np.pi * 1.0 ** 2
    assert abs(len(pos) * vol - area) < 0.05 * area

    adaptation = SPHAdaptation(spacing=0.1, dim=2)
    grid = grid_from_bounds((-1.3, -1.3), (1.3, 1.3), adaptation.cutoff)
    relaxed = relax_shape(shape, jnp.asarray(pos, jnp.float32), float(vol),
                          adaptation, grid, n_iterations=20,
                          surface_correction=False)
    sd_r = np.asarray(shape.signed_distance(relaxed))
    assert sd_r.max() < 0.5 * 0.1      # bounded by the (probed) surface
    assert np.isfinite(np.asarray(relaxed)).all()


def test_levelset_3d_sphere_probes():
    """3D packaged level set of a sphere: signed-distance and normal
    probes match the analytic SDF; reinitialization keeps them."""
    from sphinxsys_jax.core import geometry as G

    R = 1.0
    sphere = G.Ball(center=(0.0, 0.0, 0.0), radius=R)
    ls = build_levelset(sphere, (-1.6, -1.6, -1.6), (1.6, 1.6, 1.6),
                        spacing=0.08)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-1.3, 1.3, (64, 3)), jnp.float32)
    want = np.linalg.norm(np.asarray(pts), axis=1) - R
    sd = np.asarray(ls.probe_signed_distance(pts))
    sel = np.abs(want) < 0.4           # inside the narrow band
    assert np.abs(sd[sel] - want[sel]).max() < 0.02
    n = np.asarray(ls.probe_normal_direction(pts))
    e = np.asarray(pts) / np.linalg.norm(np.asarray(pts), axis=1,
                                         keepdims=True)
    assert np.abs((n - e)[sel]).max() < 0.1

    fixed = ls.reinitialize(iterations=20)
    sd2 = np.asarray(fixed.probe_signed_distance(pts))
    assert np.abs(sd2[sel] - want[sel]).max() < 0.03


def test_levelset_3d_kernel_integral_half_space():
    """3D cut-cell kernel integrals against the half-space analytic limit:
    deep inside the positive region the W-integral is 1, at the flat
    interface it is 1/2, deep negative it is 0."""
    from sphinxsys_jax.core import geometry as G
    from sphinxsys_jax.core.kernels import WendlandC2

    DX = 0.1
    # half-space x > 0 via a large box: phi = -x
    half = G.Box(G.Transform(translation=(-2.0, 0.0, 0.0)),
                 halfsize=(2.0, 4.0, 4.0))
    ls = build_levelset(half, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0),
                        spacing=DX)
    ls = ls.update_kernel_integrals(WendlandC2(h=DX), dim=3)
    pts = jnp.asarray([[-0.5, 0.0, 0.0], [0.0, 0.0, 0.0],
                       [0.5, 0.0, 0.0]], jnp.float32)
    kw = np.asarray(ls.probe_kernel_integral(pts))
    assert abs(kw[2] - 1.0) < 0.05     # deep positive (outside the box)
    assert abs(kw[1] - 0.5) < 0.06     # on the interface
    assert abs(kw[0]) < 0.05           # deep negative (inside)
    kg = np.asarray(ls.probe_kernel_gradient_integral(pts))
    assert kg[1, 0] > 0.1              # gradient points out of the body
    assert abs(kg[1, 1]) < 1e-2 and abs(kg[1, 2]) < 1e-2


def test_levelset_3d_body_fitted_relaxation():
    """test_3d_particle_relaxation analog: relax a lattice inside a
    3D level-set sphere — particles stay inside the probed surface and
    the configuration stays finite (reload-ready)."""
    from sphinxsys_jax.core import geometry as G
    from sphinxsys_jax.core.generators import generate_lattice
    from sphinxsys_jax.core.adaptation import SPHAdaptation
    from sphinxsys_jax.neighbors import grid_from_bounds
    from sphinxsys_jax.physics.relax import relax_shape

    R = 1.0
    dx = 0.125
    sphere = G.Ball(center=(0.0, 0.0, 0.0), radius=R)
    ls = build_levelset(sphere, (-1.6, -1.6, -1.6), (1.6, 1.6, 1.6),
                        spacing=dx)
    shape = LevelSetShape(ls)
    pos, vol = generate_lattice(shape, (-1.2, -1.2, -1.2), (1.2, 1.2, 1.2),
                                dx)
    volume = 4.0 / 3.0 * np.pi * R ** 3
    assert abs(len(pos) * vol - volume) < 0.05 * volume

    adaptation = SPHAdaptation(spacing=dx, dim=3)
    grid = grid_from_bounds((-1.4, -1.4, -1.4), (1.4, 1.4, 1.4),
                            adaptation.cutoff)
    relaxed = relax_shape(shape, jnp.asarray(pos, jnp.float32), float(vol),
                          adaptation, grid, n_iterations=15,
                          surface_correction=False)
    sd_r = np.asarray(shape.signed_distance(relaxed))
    assert sd_r.max() < 0.5 * dx
    assert np.isfinite(np.asarray(relaxed)).all()


def test_trimesh_to_levelset_scaling_path():
    """STL/triangle-mesh bodies at scale: the dense O(N_query * faces)
    trimesh signed distance runs ONCE at level-set build; every runtime
    probe (SDF / normals / kernel integrals / relaxation) is then an O(1)
    package lookup — the XLA answer to the reference's BVH
    (TriangleMeshDistance.h)."""
    from sphinxsys_jax.core.trimesh import icosphere_mesh

    mesh = icosphere_mesh(radius=1.0, subdivisions=3)  # 1280 faces
    ls = build_levelset(mesh, (-1.6, -1.6, -1.6), (1.6, 1.6, 1.6),
                        spacing=0.1)
    rng = np.random.default_rng(3)
    pts = jnp.asarray(rng.uniform(-1.4, 1.4, (48, 3)), jnp.float32)
    want = np.linalg.norm(np.asarray(pts), axis=1) - 1.0
    sd = np.asarray(ls.probe_signed_distance(pts))
    band = np.abs(want) < 0.4
    # icosphere(3) deviates from the true sphere by ~1e-3; grid adds O(dx)
    assert np.abs(sd[band] - want[band]).max() < 0.03
    n = np.asarray(ls.probe_normal_direction(pts))
    e = np.asarray(pts) / np.linalg.norm(np.asarray(pts), axis=1,
                                         keepdims=True)
    assert np.abs((n - e)[band]).max() < 0.12
