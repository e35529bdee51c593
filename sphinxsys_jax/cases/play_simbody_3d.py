"""Triple-pendulum multibody play case (test_3d_play_simbody).

Counterpart of /root/reference/tests/3d_examples/test_3d_play_simbody/
play_simbody.cpp: three identical links (mass 1, unit inertia, COM at the
body origin) chained by pin mobilizers — the joint sits at (0,-1,0) in
each parent's frame and (0,1,0) in the child's — with all three joint
angles PRESCRIBED by ramped sinusoids (UdfMotion.h) and the state written
to step-indexed XML snapshots (SimbodyStateEngine).  Gravity is disabled
(the reference comments its gravity force out, play_simbody.cpp:22).

Ten unit-time steps, states saved each step, restartable from any saved
step (play_simbody.cpp:51-68).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.physics import articulated as art

N_LINKS = 3
NUM_STEPS = 10           # play_simbody.cpp:63
DT = 0.05                # RK4 substep; reference's RKM is adaptive
PI = math.pi


def build_tree(dtype=jnp.float64) -> art.ArticulatedTree:
    n = N_LINKS
    return art.ArticulatedTree(
        parent=np.arange(-1, n - 1),
        axis=jnp.tile(jnp.asarray([0.0, 0.0, 1.0], dtype), (n, 1)),
        r_parent=jnp.tile(jnp.asarray([0.0, -1.0, 0.0], dtype), (n, 1)),
        r_child=jnp.tile(jnp.asarray([0.0, 1.0, 0.0], dtype), (n, 1)),
        mass=jnp.ones(n, dtype),
        inertia=jnp.tile(jnp.eye(3, dtype=dtype), (n, 1, 1)),
        com=jnp.zeros((n, 3), dtype),
    )


def build_motions() -> art.MotionSet:
    """play_simbody.cpp:34-44 motion parameters."""
    return art.MotionSet.build([
        art.sinusoid_motion(PI / 40.0, 10.0, 2.0 * PI, 0.0),
        art.sinusoid_motion(PI / 30.0, 10.0, 2.0 * PI, -0.5 * PI),
        art.sinusoid_motion(PI / 20.0, 10.0, 2.0 * PI, -0.8 * PI),
    ])


class SimState(NamedTuple):
    t: jnp.ndarray
    q: jnp.ndarray
    u: jnp.ndarray


def init_sim(dtype=jnp.float64) -> SimState:
    z = jnp.zeros(N_LINKS, dtype)
    return SimState(t=jnp.zeros((), dtype), q=z, u=z)


def make_run_step(tree: art.ArticulatedTree, motions: art.MotionSet):
    """Advance one unit-time step (ts.stepTo(step) analog) with fixed-dt
    RK4 substeps."""
    step = art.make_articulated_step(tree, gravity=(0.0, 0.0, 0.0),
                                     motions=motions)
    n_sub = int(round(1.0 / DT))

    @jax.jit
    def run(s: SimState) -> SimState:
        def body(i, carry):
            t, q, u = carry
            q, u = step(t, q, u, jnp.asarray(DT, q.dtype), jnp.zeros_like(q))
            return t + DT, q, u
        t, q, u = jax.lax.fori_loop(0, n_sub, body, (s.t, s.q, s.u))
        return SimState(t=t, q=q, u=u)

    return run


def run_case(output_dir: str, restart_step: int = 0):
    """The reference main loop: step to each integer time, write the state
    snapshot; on restart, read the saved state and continue."""
    tree = build_tree()
    motions = build_motions()
    run = make_run_step(tree, motions)
    if restart_step:
        t, q, u = art.read_state_xml(output_dir, restart_step)
        dtype = tree.axis.dtype
        s = SimState(t=jnp.asarray(t, dtype), q=jnp.asarray(q, dtype),
                     u=jnp.asarray(u, dtype))
    else:
        s = init_sim()
    for step_i in range(restart_step + 1, NUM_STEPS + 1):
        s = run(s)
        art.write_state_xml(output_dir, step_i, s.t, s.q, s.u)
    return s
