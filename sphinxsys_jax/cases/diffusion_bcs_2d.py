"""2D diffusion in a unit square with Dirichlet + Neumann / Robin BCs.

Mirrors the reference cases
/root/reference/tests/2d_examples/test_2d_diffusion_NeumannBC/ and
test_2d_diffusion_RobinBC/ (shared scene, diffusion_NeumannBC.h:15-57):
  * 1 x 1 thermal domain, dx = H/100, d = 1, Phi0 = 100
  * Dirichlet patches ABOVE the top edge: x in [0.3, 0.4] -> 300 and
    x in [0.6, 0.7] -> 350 (2*dx thick boundary bands)
  * mode="neumann": bottom patch x in [0.45, 0.55] prescribes diffusive
    flux PhiFlux = 900 (diffusion_NeumannBC.h:31,155-160)
  * mode="robin":   same patch prescribes convection 100 against
    T_infinity = 400 (diffusion_RobinBC.h:31-32,150-160)
  * RK2 diffusion relaxation to t = 1, observers on the x = 0.5 midline
    (5 points), recorded every 0.1 against the reference's
    TemperatureObserver_Phi ensemble DB.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import diffusion as dfn
from sphinxsys_jax.physics import general as gd

L = 1.0
H = 1.0
DIFFUSION_COEFF = 1.0
INITIAL_T = 100.0
LEFT_T = 300.0
RIGHT_T = 350.0
HEAT_FLUX = 900.0
CONVECTION = 100.0
T_INFINITY = 400.0


class SimState(NamedTuple):
    body: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DiffusionBCCase:
    mode: str                  # "neumann" | "robin"
    dx: float
    adaptation: SPHAdaptation
    dt: float
    body0: Any
    wall_d: Any                # Dirichlet boundary body
    wall_n: Any                # Neumann/Robin boundary body
    nl_inner: Any
    nl_d: Any
    nl_n: Any
    obs_idx: Any               # nearest-particle observers (midline)
    obs_w: Any

    @property
    def kernel(self):
        return self.adaptation.kernel


def _observer_weights(pos, obs_points, kernel, vol, cutoff, dim=2):
    """Frozen kernel-interpolation weights (ObservedQuantityRecording:
    normalized W(r) V_j over the contact support)."""
    pos = np.asarray(pos)
    idx_list, w_list = [], []
    for pt in obs_points:
        r = np.linalg.norm(pos - np.asarray(pt), axis=1)
        idx = np.nonzero(r < cutoff)[0]
        w = np.asarray([float(kernel.W(jnp.asarray(ri, jnp.float64), dim))
                        for ri in r[idx]]) * np.asarray(vol)[idx]
        idx_list.append(idx)
        w_list.append(w / (w.sum() + 1e-15))
    k = max(len(i) for i in idx_list)
    n = pos.shape[0]
    idx_a = np.full((len(obs_points), k), 0, np.int32)
    w_a = np.zeros((len(obs_points), k))
    for i, (ix, w) in enumerate(zip(idx_list, w_list)):
        idx_a[i, :len(ix)] = ix
        w_a[i, :len(ix)] = w
    return jnp.asarray(idx_a), jnp.asarray(w_a)


def build_case(mode: str = "neumann", dx: float = H / 100.0,
               dtype=jnp.float64, cell_cap: int = 16, k_inner: int = 48,
               k_contact: int = 32):
    assert mode in ("neumann", "robin")
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = 2.0 * dx

    domain = G.Box(G.Transform(translation=(L / 2, H / 2)),
                   halfsize=(L / 2, H / 2))
    left = G.Box(G.Transform(translation=(0.35 * L, H + bw / 2)),
                 halfsize=(0.05 * L, bw / 2))
    right = G.Box(G.Transform(translation=(0.65 * L, H + bw / 2)),
                  halfsize=(0.05 * L, bw / 2))
    dirichlet_shape = G.make_complex(("add", left), ("add", right))
    flux_patch = G.Box(G.Transform(translation=(0.5 * L, -bw / 2)),
                       halfsize=(0.05 * L, bw / 2))

    lo, hi = (-bw, -bw), (L + bw, H + bw)
    pos_b, vol = generate_lattice(domain, lo, hi, dx)
    pos_d, _ = generate_lattice(dirichlet_shape, lo, hi, dx)
    pos_n, _ = generate_lattice(flux_patch, lo, hi, dx)

    def mkstate(pos):
        n = len(pos)
        return {"Position": jnp.asarray(pos, dtype),
                "VolumetricMeasure": jnp.full((n,), vol, dtype),
                "NReal": jnp.asarray(n, jnp.int32)}

    body = mkstate(pos_b)
    body["Phi"] = jnp.full((len(pos_b),), INITIAL_T, dtype)
    body = gd.normal_direction_from_shape(body, domain)

    wall_d = mkstate(pos_d)
    xd = np.asarray(pos_d)[:, 0]
    wall_d["Phi"] = jnp.asarray(np.where(xd < 0.5 * L, LEFT_T, RIGHT_T), dtype)

    wall_n = mkstate(pos_n)
    wall_n["Phi"] = jnp.zeros((len(pos_n),), dtype)
    if mode == "neumann":
        wall_n["PhiFlux"] = jnp.full((len(pos_n),), HEAT_FLUX, dtype)
    else:
        wall_n["PhiConvection"] = jnp.full((len(pos_n),), CONVECTION, dtype)
    wall_n = gd.normal_direction_from_shape(wall_n, flux_patch)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    nb, nd, nn = body["NReal"], wall_d["NReal"], wall_n["NReal"]

    @jax.jit
    def topo():
        tb = build_cell_table(body["Position"], nb, grid, cap=cell_cap)
        td = build_cell_table(wall_d["Position"], nd, grid, cap=cell_cap)
        tn = build_cell_table(wall_n["Position"], nn, grid, cap=cell_cap)
        nl_inner = build_neighbor_list(body["Position"], nb, body["Position"],
                                       nb, tb, grid, adaptation.cutoff,
                                       k_max=k_inner, include_self=False)
        nl_d = build_neighbor_list(body["Position"], nb, wall_d["Position"],
                                   nd, td, grid, adaptation.cutoff,
                                   k_max=k_contact, include_self=True)
        nl_n = build_neighbor_list(body["Position"], nb, wall_n["Position"],
                                   nn, tn, grid, adaptation.cutoff,
                                   k_max=k_contact, include_self=True)
        return nl_inner, nl_d, nl_n

    nl_inner, nl_d, nl_n = topo()
    assert not bool(nl_inner.overflow | nl_d.overflow | nl_n.overflow)

    dt = dfn.diffusion_time_step(adaptation.h,
                                 dfn.IsotropicDiffusion(DIFFUSION_COEFF), 2)
    obs_points = [(0.5 * L, H * i / 4.0) for i in range(5)]
    obs_idx, obs_w = _observer_weights(pos_b, obs_points, adaptation.kernel,
                                       np.full(len(pos_b), vol),
                                       adaptation.cutoff)
    return DiffusionBCCase(mode=mode, dx=dx, adaptation=adaptation, dt=dt,
                           body0=body, wall_d=wall_d, wall_n=wall_n,
                           nl_inner=nl_inner, nl_d=nl_d, nl_n=nl_n,
                           obs_idx=obs_idx, obs_w=obs_w)


def init_sim(case: DiffusionBCCase) -> SimState:
    dtype = case.body0["Position"].dtype
    return SimState(body=dict(case.body0), time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32))


def make_run_chunk(case: DiffusionBCCase):
    diffusion = dfn.IsotropicDiffusion(DIFFUSION_COEFF)
    kernel = case.kernel
    neumann = [(case.wall_n, case.nl_n)] if case.mode == "neumann" else ()
    robin = ([(case.wall_n, case.nl_n, T_INFINITY)]
             if case.mode == "robin" else ())

    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        def body_fn(carry):
            st = carry
            b = dfn.diffusion_step_rk2(
                st.body, "Phi", case.nl_inner, kernel, 2, diffusion, case.dt,
                dirichlet_contacts=[(case.wall_d, case.nl_d)],
                neumann_contacts=neumann, robin_contacts=robin)
            return SimState(body=b, time=st.time + case.dt,
                            n_steps=st.n_steps + 1)

        return jax.lax.while_loop(lambda st: st.time < t_target, body_fn, s)

    return run_chunk


def observe_phi(case: DiffusionBCCase, s: SimState):
    """Interpolated Phi at the 5 midline observers."""
    phi = s.body["Phi"]
    return jnp.sum(phi[case.obs_idx] * case.obs_w, axis=1)
