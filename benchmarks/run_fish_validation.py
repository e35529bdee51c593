"""Fish FSI production run (VERDICT r1 item 4): flow_stream_around_fish at
the reference resolution (dx=0.0025, 2d_flow_stream_around_fish.h:10) to
End_Time=1.7 (cpp:198).  Records the fish center of mass (self-propulsion
curve) and water total kinetic energy; writes the COM curve to
tests/golden/fish/FishBody_CenterOfMass.xml (our result-XML format)."""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import fish_fsi_2d as ff
from sphinxsys_jax.io import regression as rg

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "fish")
T_END = float(os.environ.get("FISH_T_END", "1.7"))
N_SNAP = int(os.environ.get("FISH_N_SNAP", "85"))
DX = float(os.environ.get("FISH_DX", "0.0025"))


def main():
    case, fluid, fish = ff.build_case(dx=DX)
    print(f"n_fluid={case.n_fluid} n_fish={case.n_fish}", flush=True)
    s = ff.init_sim(case, fluid, fish)
    run = ff.make_run_chunk(case)
    coms, kes = [], []
    t0 = time.time()
    for i in range(1, N_SNAP + 1):
        s = run(s, jnp.asarray(i * T_END / N_SNAP, s.time.dtype))
        com = ff.fish_center_of_mass(s)
        m = np.asarray(s.fluid["Alive"])
        ke = float(np.sum(0.5 * np.asarray(s.fluid["Mass"])[m]
                          * np.sum(np.asarray(s.fluid["Velocity"])[m] ** 2, -1)))
        coms.append(com)
        kes.append(ke)
        if i % 5 == 0 or i == 1:
            print(f"t={float(s.time):6.3f} com=({com[0]:.4f},{com[1]:.4f}) "
                  f"KE={ke:.4e} ovf={bool(s.overflow)} [{time.time()-t0:.0f}s]",
                  flush=True)
        assert not bool(s.overflow), "overflow"
    coms = np.asarray(coms)
    os.makedirs(OUT_DIR, exist_ok=True)
    rg.write_result_xml(os.path.join(OUT_DIR, "FishBody_CenterOfMass_Run_0_result.xml"),
                        coms[None, :, :])
    rg.write_result_xml(os.path.join(OUT_DIR, "WaterBody_TotalKineticEnergy_Run_0_result.xml"),
                        np.asarray(kes)[None, :])
    dx_total = coms[-1, 0] - coms[0, 0]
    print(f"\nfish displacement over t={T_END}: dx={dx_total:+.4f} "
          f"dy={coms[-1,1]-coms[0,1]:+.4f}")
    print(f"mean forward speed (2nd half): "
          f"{(coms[-1,0]-coms[len(coms)//2,0])/(T_END/2):+.4f}")


if __name__ == "__main__":
    main()
