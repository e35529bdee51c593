"""Surface-contact machinery (physics/surface_contact.py): solid/shell
dynamic contact builders, repulsion factor/force, shell self contact.
Reference: neighborhood.cpp:162-529, repulsion_factor_summation.cpp,
contact_repulsion.cpp."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import shell as sh
from sphinxsys_jax.physics import surface_contact as sc

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

DP = 0.25


def _strip(y, n=21, normal_up=True):
    xs = (np.arange(n) - n // 2) * DP
    pos = np.stack([xs, np.full_like(xs, y)], -1)
    normal = np.tile([0.0, 1.0 if normal_up else -1.0], (n, 1))
    mat = NeoHookeanSolid(rho0=1.0, youngs_modulus=1e3, poisson_ratio=0.125)
    return sh.make_shell_state(pos, normal, DP, 4 * DP, mat, dtype=jnp.float64)


def _nl(pos_q, target, grid, cutoff, k_max=16):
    nq = jnp.int32(pos_q.shape[0])
    nt = jnp.int32(target["Position"].shape[0])
    table = build_cell_table(target["Position"], nt, grid, cap=16)
    return build_neighbor_list(pos_q, nq, target["Position"], nt, table,
                               grid, cutoff, k_max=k_max, include_self=True)


@pytest.fixture(scope="module")
def setup():
    ad = SPHAdaptation(spacing=DP, dim=2)
    grid = grid_from_bounds((-4, -4), (4, 4), ad.kernel.cutoff)
    return ad, grid


def test_solid_offset_vanishes_at_rest_separation(setup):
    """NeighborBuilderSurfaceContactFromSolid: W is reduced by W(dp_avg),
    so two flat solid surfaces at exactly one-spacing separation produce
    zero repulsion factor (no rest-state ghost force)."""
    ad, grid = setup
    a = _strip(0.0)
    b = _strip(DP)  # exactly one spacing away
    b["VolumetricMeasure"] = b["VolumetricMeasure"] * DP  # pretend volume
    kern = sc.surface_kernel(ad.h, ad.h)
    nl = _nl(a["Position"], b, grid, kern.cutoff)
    pairs = sc.solid_surface_pairs(a["Position"], b, nl, kern, 2, DP, DP)
    sigma = sc.repulsion_factor([pairs])
    # mid-strip particle: only the directly-opposite particle is at dp_avg;
    # diagonal ones are farther (W < offset clamps to 0)
    assert float(sigma[10]) == pytest.approx(0.0, abs=1e-12)
    # approaching closer -> factor turns on
    b_close = dict(b)
    b_close["Position"] = b["Position"] - jnp.asarray([0.0, 0.4 * DP])
    nl2 = _nl(a["Position"], b_close, grid, kern.cutoff)
    pairs2 = sc.solid_surface_pairs(a["Position"], b_close, nl2, kern, 2,
                                    DP, DP)
    assert float(sc.repulsion_factor([pairs2])[10]) > 0.0


def test_shell_shell_contact_forces_separate_and_balance(setup):
    """Two shell strips closing on each other: the repulsion forces point
    apart and (by symmetry of the pair sums) balance to near-zero total
    momentum flux."""
    ad, grid = setup
    a = _strip(0.0, normal_up=True)         # normals point +y (toward b)
    b = _strip(0.3 * DP, normal_up=False)   # normals point -y (toward a)
    kern = sc.surface_kernel(ad.h, ad.h)
    k0 = jnp.zeros(a["Position"].shape[0])

    nl_ab = _nl(a["Position"], b, grid, kern.cutoff)
    nl_ba = _nl(b["Position"], a, grid, kern.cutoff)
    # normals point TOWARD the other body -> normal_correction=True flips
    # them away (the dummy stack must extend through the neighbor's body)
    pairs_ab = sc.shell_surface_pairs(a["Position"], b, k0, k0, nl_ab, kern,
                                      2, DP, normal_correction=True)
    pairs_ba = sc.shell_surface_pairs(b["Position"], a, k0, k0, nl_ba, kern,
                                      2, DP, normal_correction=True)
    sig_a = sc.repulsion_factor([pairs_ab])
    sig_b = sc.repulsion_factor([pairs_ba])
    assert float(sig_a[10]) > 0 and float(sig_b[10]) > 0

    K = 1.0e3
    pv_a = a["VolumetricMeasure"] * a["Thickness"]
    pv_b = b["VolumetricMeasure"] * b["Thickness"]
    f_a = sc.repulsion_force(a, sig_a, [(pairs_ab, sig_b, K)],
                             particle_volume=pv_a)
    f_b = sc.repulsion_force(b, sig_b, [(pairs_ba, sig_a, K)],
                             particle_volume=pv_b)
    # a is below b: pushed down; b pushed up
    assert float(f_a[10, 1]) < 0.0 < float(f_b[10, 1])
    # interior particles: action ~ reaction (boundary truncation aside)
    assert abs(float(f_a[10, 1] + f_b[10, 1])) < 0.15 * abs(float(f_a[10, 1]))


def test_shell_self_contact_excludes_reference_neighbors(setup):
    """NeighborBuilderShellSelfContact: pairs CLOSE in the initial
    configuration never produce self-contact; a folded strip (far ends
    brought together) does."""
    ad, grid = setup
    a = _strip(0.0)
    kern = ad.kernel  # UNreduced own kernel (neighborhood.cpp:410-412)
    nl = _nl(a["Position"], a, grid, kern.cutoff)
    k1 = jnp.zeros(a["Position"].shape[0])
    pairs0 = sc.shell_self_pairs(a, k1, k1, nl, kern, 2, DP)
    assert float(jnp.max(sc.repulsion_factor([pairs0]))) == pytest.approx(
        0.0, abs=1e-12)

    # fold: move the last 5 particles just above the first 5
    pos = np.asarray(a["Position"]).copy()
    pos[-5:] = pos[:5] + np.asarray([0.0, 0.5 * DP])
    folded = dict(a)
    folded["Position"] = jnp.asarray(pos)
    nl2 = _nl(folded["Position"], folded, grid, kern.cutoff)
    pairs = sc.shell_self_pairs(folded, k1, k1, nl2, kern, 2, DP)
    sigma = sc.repulsion_factor([pairs])
    assert float(jnp.max(sigma)) > 0.0
    f = sc.self_repulsion_force(folded, sigma, pairs, 1e3, 1.0,
                                folded["VolumetricMeasure"]
                                * folded["Thickness"])
    # the folded-over tail is pushed UP away from the base strip
    assert float(jnp.sum(f[-5:, 1])) > 0.0


def test_three_ring_impact_smoke():
    """Short three-ring drive: the small ring flies, contacts propagate
    forces, everything stays finite (the full t=1 trajectory is gated vs
    the reference DB in test_golden_regression / the offline run)."""
    from sphinxsys_jax.cases import three_ring_impact_2d as tr

    case, s = tr.build_case(relax=False)  # lattice large ring: fast build
    run = tr.make_run_chunk(case)
    s = run(s, jnp.asarray(0.05, s.time.dtype))
    assert not bool(s.overflow)
    for ring in (s.ring_l, s.ring_m, s.ring_s):
        assert np.isfinite(np.asarray(ring["Position"])).all()
    # the small ring moved along its initial velocity
    com_s = np.asarray(s.ring_s["Position"]).mean(0)
    assert com_s[0] < tr.CENTER_S[0] - 1.0 and com_s[1] > tr.CENTER_S[1] + 1.0
