"""Purkinje-LV electro-contraction composition
(cases/pkj_lv_electrocontraction_3d.py = test_3d_pkj_lv_electrocontraction):
tree conduction -> leaf stimulation -> monodomain wave -> active
contraction."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_network_driven_activation_and_contraction():
    from sphinxsys_jax.cases import pkj_lv_electrocontraction_3d as pkj

    case, s = pkj.build_case()
    assert case.n_pkj > 30          # the tree grew over the inner surface
    r_tree = np.linalg.norm(np.asarray(case.pkj_pos)
                            / np.asarray(pkj.INNER), axis=1)
    assert np.abs(r_tree - 1.0).max() < 0.05   # tree lives ON the surface

    r0 = pkj.midwall_ring_radius(case, s)
    run = pkj.make_run_chunk(case)
    s = run(s, jnp.asarray(6.0, s.time.dtype))

    v = np.asarray(s.myo["Voltage"])
    assert np.isfinite(v).all() and np.isfinite(np.asarray(s.pkj_v)).all()
    # the apex sits ~2.4 units of tissue path from the base stimulus; pure
    # tissue diffusion covers only sqrt(D t) ~ 0.55 by t = 6 — apex
    # activation this early PROVES the fast network pathway
    assert pkj.apex_voltage(case, s) > 0.9
    act = float((v > 0.5).mean())
    assert 0.15 < act < 0.95        # wave mid-passage
    # excitation-contraction: Ta developed and the wall squeezed
    assert float(np.asarray(s.myo["ActiveContractionStress"]).max()) > 1.0
    r1 = pkj.midwall_ring_radius(case, s)
    assert r1 < 0.98 * r0
    # mechanics stays sane
    assert np.isfinite(np.asarray(s.myo["Velocity"])).all()
