"""2D depolarization — monodomain PDE-ODE benchmark on a unit square.

Counterpart of /root/reference/tests/2d_examples/test_2d_depolarization/
depolarization.cpp: a 1x1 muscle block (dx=1/50) with directional
monodomain diffusion (d=1, bias 0 along (1,0)) closed by the
Aliev-Panfilow reaction (k=8, a=0.15, b=0, mu1=0.2, mu2=0.3, eps=0.04),
initialized with a Gaussian depolarization bump at the (1,0) corner
(V = exp(-4((x-1)^2 + y^2))) and integrated by Strang splitting
(reaction half / diffusion RK2 / reaction half, depolarization.cpp:
155-160) to t=16.  The depolarization wave sweeps the square; the
observer at (0.3, 0.7) reads Voltage through frozen kernel weights and is
checked against the reference's ensemble-averaged DB.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import diffusion as df

L = 1.0
H = 1.0
DX = H / 50.0
MODEL = df.AlievPanfilowModel(k_a=0.0, c_m=1.0, k=8.0, a=0.15, b=0.0,
                              mu_1=0.2, mu_2=0.3, epsilon=0.04)
DIFFUSION = df.DirectionalDiffusion(d_coeff=1.0, bias_coeff=0.0,
                                    bias_direction=(1.0, 0.0))
OBSERVER = (0.3, 0.7)


class SimState(NamedTuple):
    body: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DepolarizationCase:
    dx: float
    adaptation: SPHAdaptation
    nl: Any
    n: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 16,
               k_inner: int = 32):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(dx / 2, L, dx)
    ys = np.arange(dx / 2, H, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    v0 = np.exp(-4.0 * ((pos[:, 0] - 1.0) ** 2 + pos[:, 1] ** 2))
    body = {
        "Position": jnp.asarray(pos, dtype),
        "VolumetricMeasure": jnp.full((n,), dx * dx, dtype),
        "NReal": jnp.asarray(n, jnp.int32),
        "Voltage": jnp.asarray(v0, dtype),
        "GateVariable": jnp.zeros((n,), dtype),
    }
    grid = grid_from_bounds((0.0, 0.0), (L, H), adaptation.cutoff)
    table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        body["Position"], body["NReal"])
    nl = jax.jit(partial(
        build_neighbor_list, grid=grid, cutoff=adaptation.cutoff,
        k_max=k_inner, include_self=False))(
        body["Position"], body["NReal"], body["Position"], body["NReal"],
        table)
    assert not bool(nl.overflow)
    # the reference diffusion uses CorrectedKernelGradientInner
    # (electro_physiology.h:125 + depolarization.cpp correct_configuration)
    from sphinxsys_jax.physics.fluid import kernel_correction_matrix

    body = kernel_correction_matrix(body, nl, adaptation.kernel, 2)
    case = DepolarizationCase(dx=dx, adaptation=adaptation, nl=nl, n=n)
    return case, body


def init_sim(case: DepolarizationCase, body) -> SimState:
    return SimState(body=body, time=jnp.zeros((), jnp.float32),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def make_run_chunk(case: DepolarizationCase):
    dt = df.diffusion_time_step(case.adaptation.h, DIFFUSION, 2)

    def step(s: SimState) -> SimState:
        body = df.electrophysiology_step(s.body, case.nl, case.kernel, 2,
                                         DIFFUSION, MODEL, dt)
        return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                        overflow=s.overflow)

    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target, step, s)

    return run_chunk


def voltage_observer(case: DepolarizationCase, body):
    """Frozen-weight observer at OBSERVER (depolarization.cpp:17,117)."""
    pos = np.asarray(body["Position"])
    r = np.linalg.norm(pos - np.asarray(OBSERVER), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(jnp.asarray(ri, np.float32), 2))
                    for ri in r[idx]])
    w = w * np.asarray(body["VolumetricMeasure"])[idx]
    return jnp.asarray(idx), jnp.asarray(w / w.sum(), body["Voltage"].dtype)


def observe_voltage(s: SimState, idx, weights) -> float:
    return float(jnp.sum(s.body["Voltage"][idx] * weights))
