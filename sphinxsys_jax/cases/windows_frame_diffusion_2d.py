"""2D windows-frame heat diffusion (ISO 10077-2:2012 Application 4).

Counterpart of /root/reference/tests/2d_examples/
test_2d_windows_frame_diffusion_D4/windows_frame_diffusion_D4.{h,cpp}:
a wood window-frame section with an insulation panel, EPDM gaskets, and
air cavities (per-region thermal conductivity via LocalIsotropicDiffusion),
bounded above/below by internal/external air bodies that impose ROBIN
(convective) boundaries:
  * internal air: convection 1/0.13 (1/0.20 on the two "decreased"
    junction wedges), T_infinity = 20 C
  * external air: convection 1/0.04, T_infinity = 0 C
Air-cavity conductivities follow the standard's unventilated-cavity
formula (windows_frame_diffusion_D4.h:31-72).  Phi starts at 10 C and
relaxes to the steady conduction field by t = 0.02; the shipped reference
DB (TemperatureObserver_Phi, 5 points at x = 0.028) settles at
[2.09, 5.97, 9.78, 13.64, 17.28] C.
"""

from __future__ import annotations

import dataclasses
import math
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

L = 0.3
H = 0.093
DX = 0.001

# conductivities, W/(m K) (windows_frame_diffusion_D4.h:24-29)
C1, C3, C4 = 0.025, 1.57, 2.11
WOOD_COND = 0.13
EPDM_COND = 0.25
PANE_COND = 0.035

# temperatures / convection (h:76-89)
INITIAL_T = 10.0
T_INF_E = 0.0
T_INF_I = 20.0
CONV_E = 1.0 / 0.04
CONV_I = 1.0 / 0.13
CONV_I_DECREASED = 1.0 / 0.20


def _ac_conductivity(b: float, d: float, a: float) -> float:
    """Unventilated air-cavity equivalent conductivity
    (getACConductivity, windows_frame_diffusion_D4.h:31-51)."""
    b_eq = math.sqrt(a * b / d)
    d_eq = math.sqrt(a * d / b)
    ha = C1 / d_eq if b_eq < 0.005 else max(C1 / d_eq, C3)
    hr = C4 * (1.0 - d_eq / b_eq + math.sqrt(1.0 + (d_eq / b_eq) ** 2))
    return d_eq * (ha + hr)


AC1_COND = _ac_conductivity(0.006, 0.054, 0.054 * 0.006)
AC2_COND = _ac_conductivity(0.005, 0.034, 0.034 * 0.005)
AC1_OPEN_COND = 2.0 * _ac_conductivity(0.005, 0.018, 0.018 * 0.005)
DIFF_MAX = max(WOOD_COND, EPDM_COND, PANE_COND,
               AC1_COND, AC2_COND, AC1_OPEN_COND)

# ---- polygons (windows_frame_diffusion_D4.h:96-301) ------------------------
STRUCTURE = [(0.0, 0.005), (0.0, 0.071), (0.026, 0.071), (0.026, 0.088),
             (0.11, 0.088), (0.11, 0.051), (0.3, 0.051), (0.3, 0.023),
             (0.11, 0.023), (0.11, 0.005)]
INTERNAL_AIR = [(0.0, 0.071), (0.0, 0.076), (0.009, 0.076), (0.009, 0.093),
                (0.140, 0.093), (0.140, 0.056), (0.3, 0.056), (0.3, 0.051),
                (0.11, 0.051), (0.11, 0.088), (0.026, 0.088), (0.026, 0.071)]
DECREASED_CONV_1 = [(0.009, 0.071), (0.026, 0.088), (0.026, 0.071)]
DECREASED_CONV_2 = [(0.110, 0.051), (0.110, 0.088), (0.140, 0.051)]
EXTERNAL_AIR = [(0.0, 0.0), (0.0, 0.005), (0.110, 0.005), (0.110, 0.023),
                (0.300, 0.023), (0.300, 0.018), (0.115, 0.018), (0.115, 0.0)]
EPDM_1 = [(0.026, 0.071), (0.026, 0.074), (0.042, 0.074), (0.042, 0.071)]
EPDM_2 = [(0.048, 0.020), (0.048, 0.023), (0.063, 0.023), (0.063, 0.020)]
EPDM_3 = [(0.095, 0.051), (0.095, 0.054), (0.11, 0.054), (0.11, 0.051)]
EPDM_4 = [(0.095, 0.020), (0.095, 0.023), (0.11, 0.023), (0.11, 0.020)]
PANEL = [(0.095, 0.023), (0.095, 0.051), (0.3, 0.051), (0.3, 0.023)]
AC_1 = [(0.042, 0.020), (0.042, 0.074), (0.048, 0.074), (0.048, 0.020)]
AC_2 = [(0.090, 0.020), (0.090, 0.054), (0.095, 0.054), (0.095, 0.020)]
AC_OPEN_1 = [(0.063, 0.005), (0.063, 0.023), (0.068, 0.023), (0.068, 0.005)]


class SimState(NamedTuple):
    body: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class WindowsFrameCase:
    dx: float
    adaptation: SPHAdaptation
    dt: float
    body0: Any
    air_in: Any
    air_ex: Any
    nl_inner: Any
    nl_in: Any
    nl_ex: Any
    obs_idx: Any
    obs_w: Any

    @property
    def kernel(self):
        return self.adaptation.kernel


def _contains(poly, pos):
    return np.asarray(G.Polygon(vertices=tuple(map(tuple, poly)))
                      .contains(jnp.asarray(pos)))


def observation_points():
    """5 points at x = 0.028 (createObservationPoints, h:403-418)."""
    rng, start = H - 0.02, 0.01
    return [(0.028, start + rng * i / 4.0) for i in range(5)]


def build_case(dx: float = DX, dtype=jnp.float64, cell_cap: int = 16,
               k_inner: int = 48, k_contact: int = 32):
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    frame_shape = G.Polygon(vertices=tuple(STRUCTURE))
    air_in_shape = G.Polygon(vertices=tuple(INTERNAL_AIR))
    air_ex_shape = G.Polygon(vertices=tuple(EXTERNAL_AIR))

    bw = 2.0 * dx
    lo, hi = (-bw, -bw), (L + bw, H + bw)
    pos_b, vol = generate_lattice(frame_shape, lo, hi, dx)
    pos_i, _ = generate_lattice(air_in_shape, lo, hi, dx)
    pos_e, _ = generate_lattice(air_ex_shape, lo, hi, dx)

    def mkstate(pos):
        n = len(pos)
        return {"Position": jnp.asarray(pos, dtype),
                "VolumetricMeasure": jnp.full((n,), vol, dtype),
                "NReal": jnp.asarray(n, jnp.int32)}

    # frame body: per-region conductivity (LocalDiffusivityDefinition)
    body = mkstate(pos_b)
    cond = np.full(len(pos_b), WOOD_COND)
    for poly, k in ((EPDM_1, EPDM_COND), (EPDM_2, EPDM_COND),
                    (EPDM_3, EPDM_COND), (EPDM_4, EPDM_COND),
                    (PANEL, PANE_COND), (AC_1, AC1_COND), (AC_2, AC2_COND),
                    (AC_OPEN_1, AC1_OPEN_COND)):
        cond = np.where(_contains(poly, pos_b), k, cond)
    body["ThermalConductivity"] = jnp.asarray(cond, dtype)
    body["Phi"] = jnp.full((len(pos_b),), INITIAL_T, dtype)
    body = gd.normal_direction_from_shape(body, frame_shape)

    # internal Robin boundary: convection_i, decreased on the two wedges
    air_in = mkstate(pos_i)
    conv = np.full(len(pos_i), CONV_I)
    for poly in (DECREASED_CONV_1, DECREASED_CONV_2):
        conv = np.where(_contains(poly, pos_i), CONV_I_DECREASED, conv)
    air_in["PhiConvection"] = jnp.asarray(conv, dtype)
    air_in["Phi"] = jnp.zeros((len(pos_i),), dtype)
    air_in = gd.normal_direction_from_shape(air_in, air_in_shape)

    # external Robin boundary
    air_ex = mkstate(pos_e)
    air_ex["PhiConvection"] = jnp.full((len(pos_e),), CONV_E, dtype)
    air_ex["Phi"] = jnp.zeros((len(pos_e),), dtype)
    air_ex = gd.normal_direction_from_shape(air_ex, air_ex_shape)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    nb, ni, ne = body["NReal"], air_in["NReal"], air_ex["NReal"]

    @jax.jit
    def topo():
        tb = build_cell_table(body["Position"], nb, grid, cap=cell_cap)
        ti = build_cell_table(air_in["Position"], ni, grid, cap=cell_cap)
        te = build_cell_table(air_ex["Position"], ne, grid, cap=cell_cap)
        nl_inner = build_neighbor_list(body["Position"], nb, body["Position"],
                                       nb, tb, grid, adaptation.cutoff,
                                       k_max=k_inner, include_self=False)
        nl_in = build_neighbor_list(body["Position"], nb, air_in["Position"],
                                    ni, ti, grid, adaptation.cutoff,
                                    k_max=k_contact, include_self=True)
        nl_ex = build_neighbor_list(body["Position"], nb, air_ex["Position"],
                                    ne, te, grid, adaptation.cutoff,
                                    k_max=k_contact, include_self=True)
        return nl_inner, nl_in, nl_ex

    nl_inner, nl_in, nl_ex = topo()
    assert not bool(nl_inner.overflow | nl_in.overflow | nl_ex.overflow)

    dt = dfn.diffusion_time_step(adaptation.h,
                                 dfn.IsotropicDiffusion(DIFF_MAX), 2)

    # frozen observer weights (5 points at x=0.028, frame body only)
    pts = observation_points()
    posn = np.asarray(pos_b)
    voln = np.full(len(pos_b), vol)
    idx_l, w_l = [], []
    for pt in pts:
        r = np.linalg.norm(posn - np.asarray(pt), axis=1)
        ix = np.nonzero(r < adaptation.cutoff)[0]
        w = np.asarray([float(adaptation.kernel.W(jnp.asarray(ri, jnp.float64), 2))
                        for ri in r[ix]]) * voln[ix]
        idx_l.append(ix)
        w_l.append(w / (w.sum() + 1e-15))
    k = max(len(i) for i in idx_l)
    obs_idx = np.zeros((len(pts), k), np.int32)
    obs_w = np.zeros((len(pts), k))
    for i, (ix, w) in enumerate(zip(idx_l, w_l)):
        obs_idx[i, :len(ix)] = ix
        obs_w[i, :len(ix)] = w

    return WindowsFrameCase(dx=dx, adaptation=adaptation, dt=dt, body0=body,
                            air_in=air_in, air_ex=air_ex, nl_inner=nl_inner,
                            nl_in=nl_in, nl_ex=nl_ex,
                            obs_idx=jnp.asarray(obs_idx),
                            obs_w=jnp.asarray(obs_w, dtype))


def init_sim(case: WindowsFrameCase) -> SimState:
    dtype = case.body0["Position"].dtype
    return SimState(body=dict(case.body0), time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32))


def make_run_chunk(case: WindowsFrameCase):
    diffusion = dfn.IsotropicDiffusion(DIFF_MAX)
    kernel = case.kernel
    robin = [(case.air_in, case.nl_in, T_INF_I),
             (case.air_ex, case.nl_ex, T_INF_E)]

    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        def body_fn(st):
            b = dfn.diffusion_step_local_rk2(
                st.body, "Phi", case.nl_inner, kernel, 2, diffusion, case.dt,
                local_diff="ThermalConductivity", robin_contacts=robin)
            return SimState(body=b, time=st.time + case.dt,
                            n_steps=st.n_steps + 1)

        return jax.lax.while_loop(lambda st: st.time < t_target, body_fn, s)

    return run_chunk


def observe_phi(case: WindowsFrameCase, s: SimState):
    return jnp.sum(s.body["Phi"][case.obs_idx] * case.obs_w, axis=1)
