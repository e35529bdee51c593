"""fsi2 production validation run (VERDICT r1 item 3).

Runs fsi2 at the reference resolution (dx = global_resolution = 0.1,
fsi2.h:18) to t_end = 200 (fsi2.cpp:191), recording the beam-tip Position
through the frozen-weight observer at ~107 snapshots (matching the
committed DB length), then DTW-compares against the reference database
/root/reference/tests/2d_examples/test_2d_fsi2/regression_test_tool/.

Writes our curve to tests/golden/fsi2/BeamObserver_Position_Run_0_result.xml
for the fast CI test (tests/test_fsi.py).
"""

from __future__ import annotations

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import fsi2
from sphinxsys_jax.io import regression as rg

REF_DB = "/root/reference/tests/2d_examples/test_2d_fsi2/regression_test_tool"
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "fsi2")

T_END = float(os.environ.get("FSI2_T_END", "200.0"))
N_SNAP = int(os.environ.get("FSI2_N_SNAP", "107"))
DX = float(os.environ.get("FSI2_DX", "0.1"))


def main():
    case, fluid, solid = fsi2.build_case(dx=DX)
    s = fsi2.init_sim(case, fluid, solid)
    idx, w = fsi2.tip_observer(case, solid)
    print(f"n_fluid={case.n_fluid} n_solid={case.n_solid} "
          f"tip observer: {len(idx)} frozen neighbors")
    run = fsi2.make_run_chunk(case)

    tips = []
    t0 = time.time()
    for i in range(1, N_SNAP + 1):
        s = run(s, jnp.asarray(i * T_END / N_SNAP, s.time.dtype))
        tip = np.asarray(fsi2.observe_tip(s, idx, w))
        tips.append(tip)
        if i % 10 == 0 or i == 1:
            print(f"t={float(s.time):7.2f}  tip=({tip[0]:.4f},{tip[1]:.4f})  "
                  f"overflow={bool(s.overflow)}  [{time.time()-t0:.0f}s]",
                  flush=True)
        assert not bool(s.overflow), "neighbor overflow"
    tips = np.asarray(tips)          # (N_SNAP, 2)

    os.makedirs(OUT_DIR, exist_ok=True)
    rg.write_result_xml(
        os.path.join(OUT_DIR, "BeamObserver_Position_Run_0_result.xml"),
        tips[None, :, :])

    y = tips[:, 1]
    n_half = len(y) // 2
    amp = 0.5 * (y[n_half:].max() - y[n_half:].min())
    print(f"\ntip y-range (2nd half): [{y[n_half:].min():.3f}, "
          f"{y[n_half:].max():.3f}]  amplitude={amp:.3f}")

    test = rg.DTWRegressionTest(REF_DB, "BeamObserver", "Position")
    dists = [d[0] for d in test.distances(tips[None, :, :])]
    print(f"DTW vs stored runs: {['%.1f' % d for d in dists]}")
    print(f"stored runs pairwise spread: 15.7 - 42.3; stored threshold "
          f"{test.threshold[0]} (internally inconsistent with its own runs)")


if __name__ == "__main__":
    main()
