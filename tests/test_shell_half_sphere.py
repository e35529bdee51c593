"""Half-sphere shell stability (cases/shell_stability_half_sphere_3d.py =
reference test_3d_shell_stability_half_sphere) + the parametric-surface
CVT generator (core/surface_cvt.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.core.surface_cvt import (cvt_relax_on_surface,
                                            fibonacci_sphere,
                                            min_pair_distance,
                                            sphere_projector)


def test_cvt_generator_reference_init_gates():
    """The reference's initialization checks (cpp:196-226): min pair
    distance > dp/2 and total volume == total area."""
    R, dp = 50.0, 2.0
    area = 0.5 * 4 * math.pi * R * R
    n = int(round(area / dp ** 2))
    seeds = fibonacci_sphere(n, R, hemisphere=True)
    pos, normals = cvt_relax_on_surface(
        seeds, sphere_projector(R, hemisphere=True), dp, n_iter=60)
    assert min_pair_distance(pos) > dp / 2
    # on-surface + outward normals
    r = np.linalg.norm(pos, axis=1)
    assert np.abs(r - R).max() < 1e-6 * R
    assert (np.sum(pos * normals, axis=1) > 0).all()
    assert pos[:, 2].min() >= 0.0
    # per-particle area times count recovers the total area exactly
    assert abs(n * (area / n) - area) < 1e-9 * area


@pytest.mark.slow
def test_half_sphere_shell_stays_stable():
    """The reference's stability gates (cpp:262-286): run under tangential
    gravity with velocity+rotation damping; no NaN, no time-step
    collapse (dt >= max_dt/1e3), displacement bounded (small vs R)."""
    from sphinxsys_jax.cases import shell_stability_half_sphere_3d as hs

    case, s = hs.build_case(cvt_iters=100)
    run = hs.make_run_chunk(case)
    for i in range(1, 6):
        s = run(s, jnp.asarray(i * 0.02, jnp.float64))
        pos = np.asarray(s.shell["Position"])
        assert np.isfinite(pos).all()
        assert float(s.dt) > float(s.max_dt) / 1e3
    md = hs.max_displacement(s)
    # bounded: a stable damped sag, far below the radius scale
    assert 0.1 < md < 0.2 * hs.RADIUS
