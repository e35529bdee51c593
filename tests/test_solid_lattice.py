"""Lattice-stencil TL solid engine (physics/solid_lattice.py) vs the
gather-path reference implementation (physics/solid.py): identical frozen
topology on a lattice initial configuration, so one integration step must
agree to floating-point accumulation tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.physics import solid_lattice as sl


def _box_case(nx=14, ny=6, nz=6, dx=0.1, valid_fn=None):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=1100.0, youngs_modulus=1.7e7,
                               poisson_ratio=0.45)
    xs = np.arange(nx) * dx
    ys = np.arange(ny) * dx
    zs = np.arange(nz) * dx
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    valid = np.ones(len(pos), bool) if valid_fn is None else valid_fn(pos)

    solid = dict(sd.make_elastic_solid_state(pos, dx ** 3, material,
                                             dtype=jnp.float64))
    # a nontrivial smooth initial velocity + pre-strain
    vel = np.stack([0.3 * np.sin(2 * pos[:, 1]),
                    0.2 * np.cos(3 * pos[:, 0]) * pos[:, 2],
                    0.1 * pos[:, 0] * pos[:, 1]], -1)
    solid["Velocity"] = jnp.asarray(vel * valid[:, None])
    F0 = (np.eye(3)[None] + 0.02 * np.stack(
        [np.sin(pos * 1.7), np.cos(pos * 1.1), np.sin(pos * 0.7 + 1.0)], -2))
    solid["DeformationGradient"] = jnp.asarray(F0 * valid[:, None, None]
                                               + ~valid[:, None, None] * np.eye(3))
    solid["DeformationRate"] = jnp.asarray(
        0.01 * np.sin(pos)[..., None] * np.eye(3) * valid[:, None, None])
    solid["LatticeValid"] = jnp.asarray(valid)
    # park invalid sites far away for the gather path and zero their volume
    park = 1.0e6 + np.arange(len(pos))[:, None] * np.asarray([dx, 0.0, 0.0])
    solid["Position"] = jnp.where(jnp.asarray(valid)[:, None],
                                  solid["Position"], jnp.asarray(park))
    solid["VolumetricMeasure"] = solid["VolumetricMeasure"] * valid
    solid["Mass"] = solid["Mass"] * valid + ~valid  # avoid 0-divide
    solid["NReal"] = jnp.asarray(len(pos), jnp.int32)

    lat = sl.make_lattice(adaptation.kernel, dx, (nx, ny, nz))

    grid = grid_from_bounds((-4 * dx,) * 3,
                            (max(nx, ny, nz) * dx + 4 * dx,) * 3,
                            adaptation.cutoff)
    vmask = jnp.asarray(valid)
    table = build_cell_table(solid["Position"], vmask, grid, cap=64)
    nl = build_neighbor_list(solid["Position"], vmask,
                             solid["Position"], vmask, table, grid,
                             adaptation.cutoff, k_max=96, include_self=False)
    assert not bool(nl.overflow)
    rp = sd.freeze_reference_pairs(solid["Position"], nl, adaptation.kernel, 3)
    return adaptation, material, solid, lat, rp


def test_tap_count_matches_neighbor_list():
    adaptation, material, solid, lat, rp = _box_case()
    # an interior particle's frozen-pair count must equal the tap count
    valid = np.asarray(solid["LatticeValid"])
    counts = np.asarray(rp.mask.sum(axis=1))
    nx, ny, nz = lat.shape
    interior = np.zeros(lat.shape, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    interior = interior.reshape(-1) & valid
    assert interior.any()
    assert (counts[interior] == len(lat.taps)).all()


def test_correction_matrix_matches():
    adaptation, material, solid, lat, rp = _box_case()
    B_ref = sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])
    B_lat = sl.lattice_correction_matrix(lat, solid["LatticeValid"],
                                         dtype=jnp.float64)
    valid = np.asarray(solid["LatticeValid"])
    err = np.abs(np.asarray(B_ref - B_lat))[valid]
    assert err.max() < 1e-9


@pytest.mark.parametrize("masked", [False, True])
def test_pk2_first_half_matches(masked):
    valid_fn = None
    if masked:
        # shape-masked lattice: a notch cut out of the box
        def valid_fn(pos):
            return ~((pos[:, 0] > 0.55) & (pos[:, 0] < 0.95)
                     & (pos[:, 1] > 0.25))
    adaptation, material, solid, lat, rp = _box_case(valid_fn=valid_fn)
    B = sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])
    solid["LinearGradientCorrectionMatrix"] = B
    dt = 1e-5
    ref = sd.integration_1st_half_pk2(dict(solid), rp, material, dt,
                                      adaptation.h, lat.w0)
    lat_out = sl.integration_1st_half_pk2_lattice(dict(solid), lat, material,
                                                  dt, adaptation.h)
    valid = np.asarray(solid["LatticeValid"])
    f_ref = np.asarray(ref["Force"])[valid]
    f_lat = np.asarray(lat_out["Force"])[valid]
    scale = np.abs(f_ref).max() + 1e-30
    assert np.abs(f_ref - f_lat).max() < 1e-10 * scale
    v_ref = np.asarray(ref["Velocity"])[valid]
    v_lat = np.asarray(lat_out["Velocity"])[valid]
    assert np.abs(v_ref - v_lat).max() < 1e-12 * (np.abs(v_ref).max() + 1e-30)


def test_decomposed_first_half_matches():
    adaptation, material, solid, lat, rp = _box_case()
    solid["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])
    dt = 1e-5
    ref = sd.decomposed_integration_1st_half(dict(solid), rp, material, dt,
                                             adaptation.h)
    lat_out = sl.decomposed_integration_1st_half_lattice(
        dict(solid), lat, material, dt, adaptation.h)
    valid = np.asarray(solid["LatticeValid"])
    f_ref = np.asarray(ref["Force"])[valid]
    f_lat = np.asarray(lat_out["Force"])[valid]
    assert np.abs(f_ref - f_lat).max() < 1e-10 * (np.abs(f_ref).max() + 1e-30)


def test_second_half_matches():
    adaptation, material, solid, lat, rp = _box_case()
    solid["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])
    dt = 1e-5
    ref = sd.integration_2nd_half(dict(solid), rp, dt)
    lat_out = sl.integration_2nd_half_lattice(dict(solid), lat, dt)
    valid = np.asarray(solid["LatticeValid"])
    d_ref = np.asarray(ref["DeformationRate"])[valid]
    d_lat = np.asarray(lat_out["DeformationRate"])[valid]
    assert np.abs(d_ref - d_lat).max() < 1e-10 * (np.abs(d_ref).max() + 1e-30)


def test_twisting_column_engines_agree():
    """cases/twisting_column_3d with engine="lattice" must track the
    gather engine step-for-step (identical dt sequence and physics)."""
    from sphinxsys_jax.cases import twisting_column_3d as tc

    case_g, col_g = tc.build_case(dtype=jnp.float64)
    case_l, col_l = tc.build_case(dtype=jnp.float64, engine="lattice")
    s_g = tc.init_sim(case_g, col_g)
    s_l = tc.init_sim(case_l, col_l)
    run_g = tc.make_run_chunk(case_g)
    run_l = tc.make_run_chunk(case_l)
    t = 0.004
    s_g = run_g(s_g, jnp.asarray(t, jnp.float64))
    s_l = run_l(s_l, jnp.asarray(t, jnp.float64))
    assert int(s_g.n_steps) == int(s_l.n_steps)
    dp = np.abs(np.asarray(s_g.column["Position"])
                - np.asarray(s_l.column["Position"]))
    assert dp.max() < 1e-8
