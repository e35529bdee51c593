"""2D dynamic self contact (test_2d_self_contact): the initial-distance
pair filter, the resting-lattice zero-force invariant, and early tip
trajectory parity against the reference's committed BeamObserver DB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import self_contact_2d as sc
from sphinxsys_jax.io import regression as rg
from sphinxsys_jax.neighbors import build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import contact as ct

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

REF_DB = ("/root/reference/tests/2d_examples/test_2d_self_contact/"
          "regression_test_tool/BeamObserver_Position_Run_0_result.xml")


@pytest.fixture(scope="module")
def case_beam():
    return sc.build_case()


def test_filter_removes_all_material_pairs_at_rest(case_beam):
    """NeighborBuilderSelfContact keeps only pairs whose INITIAL distance
    exceeds the cutoff — on the undeformed lattice that is none, so the
    self-contact factor and force are identically zero."""
    case, beam = case_beam
    cutoff = case.adaptation.cutoff
    table = build_cell_table(beam["Position"], beam["NReal"], case.grid,
                             cap=case.cell_cap)
    nl = build_neighbor_list(beam["Position"], beam["NReal"],
                             beam["Position"], beam["NReal"], table,
                             case.grid, cutoff, k_max=case.k_contact,
                             include_self=False)
    nl_self = ct.filter_self_contact_pairs(nl, beam["InitialPosition"],
                                           cutoff)
    assert int(jnp.sum(nl_self.count)) == 0
    factor = ct.repulsion_factor_self(beam, nl_self, case.kernel, 2, case.dx)
    beam2 = ct.repulsion_force_self(beam, nl_self, case.kernel, 2, factor,
                                    sc.RHO0,
                                    ct.contact_stiffness(case.material))
    np.testing.assert_allclose(np.asarray(beam2["RepulsionForce"]), 0.0)


def test_early_tip_trajectory_matches_reference_db(case_beam):
    """First-mode whip: tip position at t=0.05 / 0.10 vs the reference DB
    snapshots 5 / 10 (output_interval 0.01, self_contact.cpp:181).  The
    committed full-curve comparison (DTW vs the DB's 3 runs) is generated
    by benchmarks/run_refdb_parity.py self_contact."""
    case, beam = case_beam
    s = sc.init_sim(case, beam)
    run = sc.make_run_chunk(case)
    idx, w = sc.tip_observer(case, beam)
    ref = rg.read_result_xml(REF_DB)[0]  # (100 snaps, 2)

    np.testing.assert_allclose(sc.observe_tip(s, idx, w), ref[0], atol=1e-3)
    for snap in (5, 10):
        s = run(s, jnp.asarray(snap * 0.01, s.time.dtype))
        assert not bool(s.overflow)
        tip = sc.observe_tip(s, idx, w)
        np.testing.assert_allclose(tip, ref[snap], atol=0.012)
