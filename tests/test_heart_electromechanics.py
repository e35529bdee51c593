"""Heart electromechanics + ventricle volume change
(tests/3d_examples/test_3d_heart_electromechanics/ +
test_3d_heart_volume_change/): fiber generation by transmural Phi
diffusion + Rodrigues helix rotation, fiber-biased monodomain
activation, Holzapfel orthotropic active contraction, and the
SurfaceOperationsVentricle cavity flow-rate integral."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import heart_electromechanics_3d as hm

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


@pytest.fixture(scope="module")
def run_result():
    case, sim = hm.build_case()
    run = hm.make_run_chunk(case)
    snaps = {}
    for t in (2.0, 5.0):
        sim = run(sim, jnp.asarray(t, sim.time.dtype))
        snaps[t] = sim
    return case, snaps


def test_fiber_pipeline(run_result):
    """Fibers are unit helices tangent to the wall: orthogonal to the
    transmural sheet direction (excitation_contraction.h:142-154)."""
    case, snaps = run_result
    sim = snaps[2.0]
    f = np.asarray(sim.myo["Fiber"])
    s = np.asarray(sim.myo["Sheet"])
    assert np.allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-3)
    assert np.abs(np.sum(f * s, axis=1)).max() < 1e-3


def test_activation_wave(run_result):
    """The apex stimulus reaches the base as a traveling wave: the base
    ring is quiescent at t=2 and fully depolarized by t=5."""
    case, snaps = run_result
    assert hm.base_voltage(case, snaps[2.0]) < 0.1
    assert hm.base_voltage(case, snaps[5.0]) > 0.9
    ta = np.asarray(snaps[5.0].myo["ActiveContractionStress"])
    # Ta saturates near k_a * 100 = 20 a0[0] (the reference ratio)
    assert 0.7 * hm.K_A * 100.0 < ta.max() < 1.1 * hm.K_A * 100.0


def test_ejection(run_result):
    """Contraction ejects cavity volume: dV < 0, growing in magnitude,
    reaching a physiological fraction of the initial cavity volume
    (heart_volume_change.cpp update_flow_rate/update_flow_acc)."""
    case, snaps = run_result
    v0 = hm.cavity_volume0()
    dv2 = float(snaps[2.0].dv) / v0
    dv5 = float(snaps[5.0].dv) / v0
    assert dv2 < -0.005
    assert dv5 < dv2
    assert -0.45 < dv5 < -0.08

    for sim in snaps.values():
        pos = np.asarray(sim.myo["Position"])
        assert not np.isnan(pos).any()
        # base constraint holds
        base = np.asarray(case.base_mask)
        p0 = np.asarray(sim.myo["InitialPosition"])
        assert np.abs(pos[base] - p0[base]).max() < 1e-6
