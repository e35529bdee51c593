"""3D poiseuille-flow-shell validation: run to t = 2.0 (the reference CI
end time) and compare the radial velocity profile at y = L/2 to the
analytic parabola (poiseuille_flow_shell.cpp:375-399 asserts 10% U_max).

  PYTHONPATH=/root/repo python benchmarks/run_pipe_shell_validation.py
"""
import os
import time

import jax

if os.environ.get("PIPE_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.cases import poiseuille_flow_shell_3d as pf

t_end = float(os.environ.get("PIPE_TEND", "2.0"))
t0 = time.time()
case, fluid = pf.build_case()
s = pf.init_sim(case, fluid)
run = pf.make_run_chunk(case)
obs = pf.radial_observation_points()
ana = pf.analytic_profile(obs)
for i in range(1, int(t_end / 0.25) + 1):
    s = run(s, jnp.asarray(i * 0.25, s.time.dtype))
    v = np.asarray(pf.observed_velocity(case, s, obs))
    err = np.abs(v[:, 1] - ana) / pf.U_MAX
    print(f"t={float(s.time):.3f} ovf={bool(s.overflow)} "
          f"max_err={err.max():.3f} vy_center={v[0, 1]:.4f} "
          f"(ana {ana[0]:.4f}) wall={time.time()-t0:.0f}s", flush=True)
print("axial:")
obs_a = pf.axial_observation_points()
va = np.asarray(pf.observed_velocity(case, s, obs_a))
err_a = np.abs(va[:, 1] - pf.U_MAX) / pf.U_MAX
print(f"max axial err {err_a.max():.3f} at y={obs_a[np.argmax(err_a), 1]:.4f}")
