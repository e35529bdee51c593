"""Rotating square patch (cases/rotation_patch_2d.py): kinetic energy
conservation while the patch deforms — the reference DB holds
0.0830-0.0837 over t=0..8 (test_2d_rotation_patch)."""

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import rotation_patch_2d as rp


def test_rotating_patch_conserves_kinetic_energy():
    case, fluid = rp.build_case(dx=rp.LL / 50.0)
    s = rp.init_sim(case, fluid)
    ke0 = rp.kinetic_energy(s)
    # exact initial KE: 0.5 rho omega^2 \iint (x^2+y^2) = 1/12
    np.testing.assert_allclose(ke0, 1.0 / 12.0, rtol=0.02)

    run = rp.make_run_chunk(case)
    s = run(s, jnp.asarray(1.5, s.time.dtype))
    assert not bool(s.overflow)
    ke = rp.kinetic_energy(s)
    # the patch rotates ~a quarter turn and the corners stretch outward;
    # KE must stay near 1/12 (reference band 0.0830-0.0837; coarser
    # dx=LL/50 run gets 4%)
    np.testing.assert_allclose(ke, 1.0 / 12.0, rtol=0.06)

    # the patch deformed: max radius grows beyond the initial sqrt(2)/2
    f = s.fluid
    valid = np.arange(f["Position"].shape[0]) < int(f["NReal"])
    r = np.linalg.norm(np.asarray(f["Position"])[valid], axis=1)
    assert r.max() > 0.75
    # and the core still rotates: angular momentum is conserved too
    pos = np.asarray(f["Position"])[valid]
    vel = np.asarray(f["Velocity"])[valid]
    m = np.asarray(f["Mass"])[valid]
    lz = np.sum(m * (pos[:, 0] * vel[:, 1] - pos[:, 1] * vel[:, 0]))
    lz0 = -rp.OMEGA * np.sum(m * (pos[:, 0] ** 2 + pos[:, 1] ** 2))
    assert lz < 0  # same sense as the initial clockwise rotation
