"""Full solid-to-shell coupling validation (test_3d_solid_to_shell_coupling).

Runs the dp_1 configuration until the semi-steady state (the reference's
termination: u_max < 5e-4 after t >= 5, capped at t = 100) and checks the
shell center deflection against the reference oracle -0.46 +- 10%
(test_3d_solid_to_shell_coupling.cpp:254-255).

Recorded result (2026-08, CPU f64): defl(t=30) = -0.4500, defl(t=40) =
-0.4524 with umax 3.8e-3 and decaying — 1.7% from the reference value.

Usage: python benchmarks/run_solid_shell_validation.py [t_end]
"""

import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

from sphinxsys_jax.cases import solid_shell_coupling_3d as m  # noqa: E402


def main():
    t_end = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    case, s = m.build_case()
    run = m.make_run_chunk(case)
    t0 = time.time()
    t = 0.0
    while t < t_end:
        t = min(t + 5.0, t_end)
        s = run(s, t)
        defl = m.center_deflection(case, s)
        umax = m.u_max(s)
        print(f"t={float(s.time):7.3f}  defl={defl:+.4f}  umax={umax:.2e}"
              f"  wall={time.time() - t0:.0f}s", flush=True)
        if t >= 5.0 and umax < 5e-4:
            break
    err = abs(defl - (-0.46)) / 0.46
    print(f"final deflection {defl:+.4f} vs reference -0.46 "
          f"(error {100 * err:.1f}%, gate 10%)")
    assert err < 0.10, "deflection outside the reference band"


if __name__ == "__main__":
    main()
