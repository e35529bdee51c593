"""3D elastic ball / rigid shell collision (headline benchmark
test_3d_elasticSolid_shell_collision counterpart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.physics import contact as ct

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_shell_contact_factor_monotone_in_penetration():
    """A solid particle approaching a flat shell sheet: the factor must be
    zero beyond one spacing and grow monotonically as it approaches."""
    from sphinxsys_jax.core.adaptation import SPHAdaptation
    from sphinxsys_jax.core.state import make_solid_state
    from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list

    dx = 0.1
    ad = SPHAdaptation(spacing=dx, dim=3)
    xs = np.arange(-0.6, 0.6 + dx / 2, dx)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    pos_sh = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1)
    shell = dict(make_solid_state(pos_sh, dx * dx, 1e3))

    grid = grid_from_bounds((-1, -1, -1), (1, 1, 1), ad.cutoff)
    table = build_cell_table(shell["Position"], shell["NReal"], grid, cap=32)

    def factor_at(d):
        solid = dict(make_solid_state(np.asarray([[0.0, d, 0.0]]), dx**3, 1e3))
        nl = build_neighbor_list(solid["Position"], solid["NReal"],
                                 shell["Position"], shell["NReal"], table,
                                 grid, ad.cutoff, k_max=64, include_self=True)
        return float(ct.shell_contact_factor(solid, shell, nl, ad.kernel, 3,
                                             dx)[0])

    f = [factor_at(d) for d in (1.2 * dx, dx, 0.75 * dx, 0.5 * dx, 0.25 * dx)]
    assert f[0] == 0.0          # outside the corrected support
    assert f[1] < 1e-9          # touches exactly at the offset
    assert 0 < f[2] < f[3] < f[4]
    assert f[4] < 0.2           # heuristic limiter keeps it small


@pytest.fixture(scope="module")
def collision_run():
    from sphinxsys_jax.cases import ball_shell_collision_3d as bs

    case, ball = bs.build_case(dx=0.1)
    s = bs.init_sim(case, ball)
    run = bs.make_run_chunk(case)
    zs, vzs, rmaxs, ts = [], [], [], []
    for i in range(1, 17):
        s = run(s, jnp.asarray(i * 0.25, s.time.dtype))
        ts.append(float(s.time))
        zs.append(bs.ball_center_z(s))
        vzs.append(float(jnp.mean(s.ball["Velocity"][:, 2])))
        rmaxs.append(bs.max_radial_extent(s))
    return case, s, tuple(np.asarray(a) for a in (ts, zs, vzs, rmaxs))


def test_free_fall_then_contact(collision_run):
    case, s, (t, z, vz, rmax) = collision_run
    assert not bool(s.overflow)
    assert np.isfinite(z).all()
    # free-fall phase: z(t) = -g t^2 / 2 with g = 1
    i = np.argmin(np.abs(t - 1.0))
    np.testing.assert_allclose(z[i], -0.5 * t[i] ** 2, rtol=3e-2)
    # the shell arrests the fall: terminal center height is bounded by the
    # cylinder interior (never below the bottom at -2)
    assert z.min() > -2.0
    # and the fall reversed/stopped: final speed far below free-fall value
    assert abs(vz[-1]) < 0.3


def test_no_penetration_through_shell(collision_run):
    case, s, (t, z, vz, rmax) = collision_run
    # every sampled instant: all ball particles stay inside radius 2.0
    assert rmax.max() < 2.0 + case.dx / 2


def test_ball_deforms_on_impact(collision_run):
    from sphinxsys_jax.physics import solid as sd

    case, s, _ = collision_run
    vm = np.asarray(sd.von_mises_strain(s.ball))
    assert vm.max() > 1e-3       # genuinely elastic impact
    assert vm.max() < 0.5        # but no collapse
