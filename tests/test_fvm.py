"""FVM front end: Fluent .msh parsing, mesh compilation geometry, and the
face-based Eulerian WCSPH solver (fvm/ package) vs the reference's
unstructured_mesh.{h,cpp} + FVM_flow_around_cylinder_2d_def.h."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.fvm import (compile_mesh, cylinder_ogrid, read_fluent_msh,
                               write_fluent_msh)
from sphinxsys_jax.fvm import dynamics as fv
from sphinxsys_jax.fvm.mesh import RawMesh

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

# a hand-written 2x1 quad mesh: 6 nodes, 2 unit cells, 7 faces
#   3--4--5
#   |  |  |
#   0--1--2
TINY_MSH = """(0 "hand-written fixture")
(2 2)
(10 (0 1 6 0 2))
(10 (1 1 6 1 2)(
0 0
1 0
2 0
0 1
1 1
2 1
))
(12 (0 1 2 0))
(13 (0 1 7 0))
(13 (4 1 1 2 2)(
2 5 1 2
))
(13 (5 2 7 3 2)(
1 2 1 0
2 3 2 0
3 6 2 0
6 5 2 0
5 4 1 0
4 1 1 0
))
(0 "Zone Sections")
"""


def test_parser_hand_written_fixture():
    """Node/face/cell extraction against a mesh small enough to verify by
    hand (format per unstructured_mesh_2d.cpp:9-93)."""
    path = os.path.join(tempfile.mkdtemp(), "tiny.msh")
    with open(path, "w") as f:
        f.write(TINY_MSH)
    raw = read_fluent_msh(path)
    assert raw.dim == 2
    assert raw.nodes.shape == (6, 2)
    assert len(raw.face_nodes) == 7
    # the single interior face joins cells 0 and 1 through nodes 1-4
    interior = raw.face_btype == 2
    assert interior.sum() == 1
    f0 = np.nonzero(interior)[0][0]
    assert sorted(raw.face_nodes[f0].tolist()) == [1, 4]
    assert sorted(raw.face_cells[f0].tolist()) == [0, 1]
    # boundary faces carry bc-type 3 and one -1 cell
    assert (raw.face_cells[raw.face_btype == 3].min(axis=1) == -1).all()

    mesh = compile_mesh(raw)
    assert mesh.n_cells == 2
    assert np.allclose(mesh.volumes, 1.0)
    assert np.allclose(sorted(mesh.centroids[:, 0].tolist()), [0.5, 1.5])
    assert np.allclose(mesh.centroids[:, 1], 0.5)
    # interior face: r_eff = center-to-center distance = 1
    assert mesh.r_eff[np.nonzero(mesh.neigh >= 0)[0][0]] == pytest.approx(1.0)
    # boundary face: twice the center-to-face distance = 1
    b = np.nonzero(mesh.neigh < 0)[0][0]
    assert mesh.r_eff[b] == pytest.approx(1.0)


def test_ogrid_roundtrip_and_geometry():
    """Writer -> parser -> compile: exact node roundtrip, annulus volume,
    outward normals, full 4-face incidence."""
    raw = cylinder_ogrid(r0=1.0, r1=10.0, nr=12, nt=24)
    path = os.path.join(tempfile.mkdtemp(), "cyl.msh")
    write_fluent_msh(path, raw)
    raw2 = read_fluent_msh(path)
    assert np.allclose(raw.nodes, raw2.nodes)
    assert len(raw2.face_nodes) == len(raw.face_nodes)

    mesh = compile_mesh(raw2)
    exact = np.pi * (10.0 ** 2 - 1.0 ** 2)
    assert mesh.volumes.sum() == pytest.approx(exact, rel=0.02)
    assert (mesh.volumes > 0).all()
    assert mesh.cell_faces.shape[1] == 4
    # every wall face normal points INTO the cylinder (outward of the owner
    # cell, which lies outside radius 1)
    wall = mesh.btype == 3
    rad = mesh.midpoint[wall] / np.linalg.norm(
        mesh.midpoint[wall], axis=1, keepdims=True)
    assert (np.sum(mesh.normal[wall] * rad, axis=1) < -0.9).all()
    # incidence closes: signed face-area vectors of each cell sum to zero
    av = mesh.normal * mesh.area[:, None]
    closure = (av[mesh.cell_faces] * mesh.cell_sign[..., None]).sum(axis=1)
    assert np.abs(closure).max() < 1e-9


def _mini_sim(nr=10, nt=20, r_far=8.0):
    from sphinxsys_jax.cases import fvm_cylinder_2d as fc

    case, fluid = fc.build_case(nr=nr, nt=nt, r_far=r_far)
    return fc, case, fc.init_sim(case, fluid)


def test_uniform_flow_conservation():
    """A step on uniform freestream: mass exactly conserved, and cells away
    from the cylinder stay exactly at the freestream state (flux balance)."""
    fc, case, s = _mini_sim()
    run = fc.make_run_chunk(case)
    m0 = float(jnp.sum(s.fluid["Density"] * case.dm.volumes))
    s1 = run(s, jnp.asarray(0.05, s.time.dtype))
    m1 = float(jnp.sum(s1.fluid["Density"] * case.dm.volumes))
    assert m1 == pytest.approx(m0, rel=1e-6)
    r_c = np.linalg.norm(case.mesh.centroids, axis=1)
    dv = np.abs(np.asarray(s1.fluid["Velocity"]) - np.asarray([1.0, 0.0]))
    assert dv[r_c > 5.0].max() < 1e-4


def test_cylinder_drag_develops():
    """Re=100 flow around the cylinder: stable, wake forms (velocity
    deficit behind, speed-up at the sides), positive O(1) drag from the
    pressure+viscous force reduction (2d_FVM_flow_around_cylinder.cpp:131
    regression quantity)."""
    fc, case, s = _mini_sim(nr=16, nt=32, r_far=10.0)
    run = fc.make_run_chunk(case)
    s = run(s, jnp.asarray(20.0, s.time.dtype))
    v = np.asarray(s.fluid["Velocity"])
    rho = np.asarray(s.fluid["Density"])
    assert np.isfinite(v).all() and np.isfinite(rho).all()
    assert np.abs(rho - 1.0).max() < 0.1  # weakly compressible
    c = case.mesh.centroids
    behind = (np.abs(c[:, 1]) < 1.0) & (c[:, 0] > 1.5) & (c[:, 0] < 4.0)
    side = (np.abs(c[:, 0]) < 1.0) & (np.abs(c[:, 1]) > 1.2) & (np.abs(c[:, 1]) < 3.0)
    assert v[behind, 0].mean() < 0.75      # wake deficit
    assert np.linalg.norm(v[side], axis=1).mean() > 1.0   # side speed-up
    cd = fc.drag_coefficient(case, s)
    # coarse mini-mesh with strong blockage (r_far = 10R): the early-time
    # drag overshoots the literature Cd ~ 1.35; the production O-grid
    # settles to mean Cd ~ 1.6 with Cl shedding (run log in PROGRESS.md)
    assert 0.5 < cd < 6.0


def test_supersonic_cylinder_bow_shock():
    """Mach-2 cylinder (2d_eulerian_supersonic_flow_around_cylinder.h):
    a steady bow shock forms — freestream preserved far upstream, the
    nose stagnation density matches normal-shock + isentropic compression
    (rho_stag ~ 3.1 rho_inf at M = 2, gamma = 1.4), and the shock sits a
    fraction of a radius upstream."""
    from sphinxsys_jax.cases import supersonic_cylinder_2d as sc

    case, fluid = sc.build_case(nr=28, nt=72)
    s = sc.init_sim(case, fluid)
    run = sc.make_run_chunk(case)
    s = run(s, jnp.asarray(15.0, s.time.dtype))

    rho = np.asarray(s.fluid["Density"])
    p = np.asarray(s.fluid["Pressure"])
    assert np.isfinite(rho).all() and (rho > 0).all() and (p > 0).all()

    nose_rho, nose_p = sc.stagnation_state(case, s)
    assert nose_rho == pytest.approx(3.1, rel=0.12)
    # stagnation pressure: p2 * isentropic factor ~ 5.64 * p_inf
    assert nose_p == pytest.approx(5.64 * sc.P_FAR, rel=0.15)

    c = case.mesh.centroids
    upstream = (np.abs(c[:, 1]) < 0.3) & (c[:, 0] < -4.0) & (c[:, 0] > -8.0)
    assert np.abs(rho[upstream] - 1.0).max() < 0.05   # pre-shock freestream
    # shock crossing on the stagnation line within [-2.5, -1.1]
    line = (np.abs(c[:, 1]) < 0.15) & (c[:, 0] < -1.0)
    xs, rr = c[line, 0], rho[line]
    order = np.argsort(xs)
    xs, rr = xs[order], rr[order]
    crossing = xs[np.nonzero(rr > 1.8)[0][0]]
    assert -2.5 < crossing < -1.1


def test_muscl_sharper_than_first_order():
    """Sod shock tube on the quasi-1D quad strip: the MUSCL-reconstructed
    HLLC step (Green-Gauss gradients + Barth-Jespersen limiter) beats the
    first-order step's L1(rho) error, with no over/undershoots beyond the
    initial plateaus (limiter at work)."""
    import sys

    sys.path.insert(0, "tests")
    from test_compressible_eulerian import sod_exact

    from sphinxsys_jax.core.materials import CompressibleFluid
    from sphinxsys_jax.fvm.mesh import compile_mesh
    from sphinxsys_jax.fvm.meshgen import rect_grid

    mesh = compile_mesh(rect_grid(200, 4, 1.0, 0.02))
    dm = fv.to_device(mesh)
    gas = CompressibleFluid(gamma=1.4)
    x = np.asarray(dm.centroids[:, 0])
    rho0 = np.where(x < 0.5, 1.0, 0.125)
    p0 = np.where(x < 0.5, 1.0, 0.1)
    far = fv.FarField(rho=1.0, vel=(0.0, 0.0), p=1.0)

    def run(step_fn, t_end=0.2):
        st = {"Density": jnp.asarray(rho0, jnp.float32),
              "Velocity": jnp.zeros((dm.n_cells, 2), jnp.float32),
              "Pressure": jnp.asarray(p0, jnp.float32)}
        st["TotalEnergyDensity"] = st["Pressure"] / (gas.gamma - 1.0)

        @jax.jit
        def adv(st, t):
            def body(c):
                s, tt = c
                dt = fv.compressible_time_step_fvm(s, gas, dm, cfl=0.3)
                return (step_fn(s, dm, gas, far, dt), tt + dt)

            return jax.lax.while_loop(lambda c: c[1] < t, body,
                                      (st, jnp.zeros((), jnp.float32)))

        return adv(st, t_end)[0]

    exact = np.asarray(sod_exact(x, 0.2))
    l1_first = np.abs(np.asarray(
        run(fv.compressible_step)["Density"]) - exact).mean()
    st2 = run(fv.compressible_step_muscl)
    rho2 = np.asarray(st2["Density"])
    l1_muscl = np.abs(rho2 - exact).mean()
    assert l1_muscl < 0.85 * l1_first      # measured 0.023 vs 0.031
    assert l1_muscl < 0.027
    assert rho2.min() > 0.124 and rho2.max() < 1.001   # limited, no wiggles


def test_double_mach_reflection_pattern():
    """Mach-10 double Mach reflection (2d_FVM_double_mach_reflection.h):
    at t = 0.2 the Mach stem foot reaches x ~ 2.8 on the wall (the
    self-similar position in the Woodward-Colella configuration), the
    density peaks strongly under the stem, and the pre-shock region stays
    undisturbed."""
    from sphinxsys_jax.cases import double_mach_reflection_2d as dmr

    case, fluid = dmr.build_case(nx=240, ny=60)
    s = dmr.init_sim(case, fluid)
    run = dmr.make_run_chunk(case)
    s = run(s, jnp.asarray(0.2, s.time.dtype))

    rho = np.asarray(s.fluid["Density"])
    assert np.isfinite(rho).all() and rho.min() > 1.35
    stem = dmr.wall_shock_position(case, s)
    assert 2.55 < stem < 3.05
    assert 15.0 < rho.max() < 35.0       # stem density peak
    # pre-shock quiet zone ahead of the top shock position
    c = case.mesh.centroids
    x_s_top = dmr.X0 + 0.2 * dmr.SHOCK_SPEED_X + dmr.DH / dmr.TAN60
    quiet = (c[:, 0] > x_s_top + 0.3)
    if quiet.any():
        assert np.abs(rho[quiet] - dmr.RHO_PRE).max() < 0.05


def test_fvm_3d_mesh_compiles_reference_icem():
    """3D face compilation on the reference's shipped ICEM tet mesh:
    positive volumes, closed cells (face-area vectors sum to ~0), domain
    volume below the bounding box (the channel has a bump)."""
    import numpy as np
    from sphinxsys_jax.fvm.mesh import compile_mesh, read_fluent_msh

    raw = read_fluent_msh(
        "/root/reference/tests/3d_examples/"
        "test_3d_FVM_incompressible_channel_flow/data/Channel_ICEM.msh")
    assert raw.dim == 3
    m = compile_mesh(raw)
    assert m.n_cells == 5143
    assert (m.volumes > 0).all()
    box = (0.469846 + 0.3) * 0.5 * 0.03
    assert 0.8 * box < m.volumes.sum() < box
    # closedness: per-cell sum of signed area vectors ~ 0
    av = m.normal * m.area[:, None]
    acc = np.zeros((m.n_cells, 3))
    for side, sgn in ((m.owner, 1.0), (m.neigh, -1.0)):
        sel = side >= 0
        np.add.at(acc, side[sel], sgn * av[sel])
    rel = np.abs(acc).max() / m.area.mean()
    assert rel < 1e-9, rel


def test_fvm_3d_channel_conserves_mass_and_speeds_up():
    """3D inviscid channel flow (velocity inlet vs pressure outlet, slip
    walls): inlet mass flux equals U A_in; the outlet flux balances it to
    a few % once the transient passes; the bump accelerates the flow.

    Physics oracles instead of the reference DB: the shipped
    regression DB (test_3d_FVM_incompressible_channel_flow/
    regression_test_tool/WaveBody_MaximumSpeed_ensemble_averaged_mean_
    variance.xml) is degenerate — it holds only TWO snapshots (0 and
    1000) and records MaximumSpeed 8.25 at snapshot 0 and 13.33 at
    snapshot 1000, while the case's inlet speed is U_f = 1.0 with
    c_f = 10 (.h:26-27): a subsonic bump channel cannot reach Mach 1.3,
    and the t=0 field is initialized AT U_f = 1, not 8.25.  The values
    are physically impossible for the stated setup, so the curve cannot
    gate a correct implementation."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from sphinxsys_jax.cases import fvm_channel_3d as ch

    case, state = ch.build_case()
    s = ch.init_sim(case, state)
    run = ch.make_run_chunk(case)
    s = run(s, jnp.asarray(1.0, s.time.dtype))
    f_in = ch.boundary_flux(case, s, 10)
    f_out = ch.boundary_flux(case, s, 5)
    assert abs(-f_in - 0.015) < 0.001          # U * A_in = 1 * 0.5 * 0.03
    assert abs(f_out + f_in) < 0.15 * abs(f_in)
    v = ch.max_speed(s)
    assert 1.2 < v < 3.0                       # bump speedup, subsonic
    assert not np.isnan(np.asarray(s.state["Velocity"])).any()
