"""Full hydrostatic fluid-shell validation at the reference dp_2 CI
resolution (dx = 0.025, t_end = 0.2): gate mid-span deflection vs the
clamped-clamped analytic solution (reference gtest asserts 15%,
test_2d_hydrostatic_fluid_shell.cpp:395-409).

Run: PYTHONPATH=/root/repo python benchmarks/run_hydrofsi_validation.py
"""
import os
import sys
import time

import jax

if os.environ.get("HF_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import hydrostatic_fsi_2d as hf

dx = float(os.environ.get("HF_DX", "0.025"))
t_end = float(os.environ.get("HF_TEND", "0.2"))
case, fluid, gate = hf.build_case(dx=dx)
print(f"n_fluid={case.n_fluid} n_gate={case.n_gate} "
      f"analytic={hf.ANALYTIC_DISP:.4e}", flush=True)
s = hf.init_sim(case, fluid, gate)
run = hf.make_run_chunk(case)
t0 = time.time()
hist = []
for i in range(1, 21):
    s = run(s, jnp.asarray(i * t_end / 20, s.time.dtype))
    d = hf.center_displacement(case, s)
    hist.append((float(s.time), d))
    print(f"t={float(s.time):.4f} disp={d:.4e} ratio={d/-hf.ANALYTIC_DISP:.3f}"
          f" n_ac={int(s.n_ac)} ovf={bool(s.overflow)} "
          f"wall={time.time()-t0:.0f}s", flush=True)
err = abs(abs(hist[-1][1]) - hf.ANALYTIC_DISP) / hf.ANALYTIC_DISP
print(f"FINAL disp={hist[-1][1]:.4e} analytic={hf.ANALYTIC_DISP:.4e} "
      f"err={err*100:.1f}%", flush=True)
np.save(os.path.join(os.path.dirname(__file__), "hydrofsi_disp.npy"),
        np.asarray(hist))
sys.exit(0 if err < 0.15 else 1)
