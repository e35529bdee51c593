"""Face-based FVM dynamics (jax).

Counterpart of the reference's Eulerian-WCSPH-in-FVM op set
(FVM_flow_around_cylinder_2d_def.h + eulerian_fluid_dynamics/*): the
reference reuses the SPH pair kernels over an FVM "neighborhood" whose
dW_ij = -A_f / (2 V_i V_j) encodes the face area
(unstructured_mesh_2d.cpp:212) — with that substitution the SPH sums ARE
exact finite-volume flux divergences.  Here we drop the kernel disguise and
compute the fluxes directly per face, then reduce them per cell through the
dense (C, K) incidence table: two gathers and a small-axis sum, no
scatters.

Boundary conditions are ghost states evaluated per boundary face from the
owner state (fvm_ghost_boundary.h BoundaryConditionSetupInFVM):
  wall(3)      non-slip reflection   vel_g = -vel_i
  symmetry(7)  normal reflection     vel_g = vel_i - 2 (vel_i.n) n
  far-field(9) prescribed freestream
  otherwise    zero-gradient copy
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from sphinxsys_jax.fvm.mesh import FVMesh
from sphinxsys_jax.physics.eulerian import interface_state

TINY = 1.0e-15


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    n_cells: int
    volumes: Any
    owner: Any
    neigh: Any            # boundary faces clamped to owner (masked by interior)
    interior: Any         # (F+1,) bool
    area: Any             # (F+1,) with a zero-area dummy face at index F
    normal: Any
    midpoint: Any
    r_eff: Any
    btype: Any
    cell_faces: Any       # (C, K) padded with the dummy face
    cell_sign: Any
    centroids: Any        # (C, d)
    min_edge: float

    def __hash__(self):
        return hash((self.n_cells, self.min_edge))

    def __eq__(self, other):
        return self is other


def to_device(mesh: FVMesh, dtype=jnp.float32) -> DeviceMesh:
    """Append the zero-area dummy face (incidence padding target) and move
    everything to device arrays."""
    import numpy as np

    F = len(mesh.area)
    pad_v = lambda a, fill: np.concatenate([a, np.full((1,) + a.shape[1:],
                                                       fill, a.dtype)])
    area = pad_v(mesh.area, 0.0)
    normal = pad_v(mesh.normal, 0.0)
    midpoint = pad_v(mesh.midpoint, 0.0)
    r_eff = pad_v(np.maximum(mesh.r_eff, 1e-12), 1.0)
    owner = pad_v(mesh.owner, 0)
    neigh_raw = pad_v(mesh.neigh, 0)
    btype = pad_v(mesh.btype, 2)
    interior = neigh_raw >= 0
    interior[F] = True
    neigh = np.where(neigh_raw >= 0, neigh_raw, owner)
    return DeviceMesh(
        n_cells=mesh.n_cells,
        volumes=jnp.asarray(mesh.volumes, dtype),
        owner=jnp.asarray(owner, jnp.int32),
        neigh=jnp.asarray(neigh, jnp.int32),
        interior=jnp.asarray(interior),
        area=jnp.asarray(area, dtype),
        normal=jnp.asarray(normal, dtype),
        midpoint=jnp.asarray(midpoint, dtype),
        r_eff=jnp.asarray(r_eff, dtype),
        btype=jnp.asarray(btype, jnp.int32),
        cell_faces=jnp.asarray(mesh.cell_faces, jnp.int32),
        cell_sign=jnp.asarray(mesh.cell_sign, dtype),
        centroids=jnp.asarray(mesh.centroids, dtype),
        min_edge=float(mesh.min_edge))


def make_fvm_state(dm: DeviceMesh, rho0: float, vel0, p0: float,
                   dtype=jnp.float32):
    C = dm.n_cells
    dim = dm.normal.shape[1]
    vel = jnp.broadcast_to(jnp.asarray(vel0, dtype), (C, dim))
    return {"Density": jnp.full((C,), rho0, dtype),
            "Velocity": jnp.asarray(vel),
            "Pressure": jnp.full((C,), p0, dtype)}


@dataclasses.dataclass(frozen=True)
class FarField:
    rho: float
    vel: tuple
    p: float


@dataclasses.dataclass(frozen=True)
class BCSpec:
    """Per-case ghost-state policy (BoundaryConditionSetupInFVM
    overrides, e.g. test_3d_FVM_incompressible_channel_flow.h:85-121).
    Defaults reproduce the classic cylinder setup: bc 3/4/10/36 no-slip
    walls, bc 7 symmetry mirror, bc 9/5 far field."""

    wall_slip: bool = False       # bc 3: slip (reflective) mirror instead
                                  # of no-slip — inviscid walls
    inlet_vel: tuple | None = None  # bc 10: fixed velocity, copy p/rho
    outlet_p: float | None = None   # bc 5: fixed pressure, copy vel/rho


def face_states(state, dm: DeviceMesh, far: FarField, bc: BCSpec = BCSpec()):
    """Left (owner) and right (neighbor-or-ghost) primitive states per
    face."""
    rho, vel, p = state["Density"], state["Velocity"], state["Pressure"]
    rho_l, vel_l, p_l = rho[dm.owner], vel[dm.owner], p[dm.owner]
    rho_r, vel_r, p_r = rho[dm.neigh], vel[dm.neigh], p[dm.neigh]

    bt = dm.btype
    wall = ~dm.interior & ((bt == 3) | (bt == 4) | (bt == 36))
    if bc.inlet_vel is None:
        wall = wall | (~dm.interior & (bt == 10))
    sym = ~dm.interior & (bt == 7)
    farf = ~dm.interior & (bt == 9)
    if bc.outlet_p is None:
        farf = farf | (~dm.interior & (bt == 5))

    vn = jnp.sum(vel_l * dm.normal, axis=-1, keepdims=True)
    mirror = vel_l - 2.0 * vn * dm.normal
    vel_r = jnp.where(wall[:, None], mirror if bc.wall_slip else -vel_l,
                      vel_r)
    vel_r = jnp.where(sym[:, None], mirror, vel_r)
    vel_r = jnp.where(farf[:, None],
                      jnp.asarray(far.vel, vel_l.dtype)[None, :], vel_r)
    rho_r = jnp.where(farf, far.rho, rho_r)
    p_r = jnp.where(farf, far.p, p_r)
    # non-far boundary ghosts already copy the interior rho/p: to_device
    # clamps boundary `neigh` to the owner
    if bc.inlet_vel is not None:
        inlet = ~dm.interior & (bt == 10)
        vel_r = jnp.where(inlet[:, None],
                          jnp.asarray(bc.inlet_vel, vel_l.dtype)[None, :],
                          vel_r)
    if bc.outlet_p is not None:
        outlet = ~dm.interior & (bt == 5)
        vel_r = jnp.where(outlet[:, None], vel_l, vel_r)
        p_r = jnp.where(outlet, jnp.asarray(bc.outlet_p, p_l.dtype), p_r)
    return (rho_l, vel_l, p_l), (rho_r, vel_r, p_r)


def _cell_reduce(dm: DeviceMesh, face_flux):
    """Sum signed face fluxes into cells: (F+1, ...) -> (C, ...)."""
    g = face_flux[dm.cell_faces]                       # (C, K, ...)
    sign = dm.cell_sign.reshape(dm.cell_sign.shape + (1,) * (g.ndim - 2))
    return jnp.sum(g * sign, axis=1)


def wc_acoustic_dt(state, eos, dm: DeviceMesh, cfl: float = 0.6):
    """WCAcousticTimeStepSizeInFVM: CFL * min_edge / max(c + |v|)."""
    c = eos.sound_speed(state["Pressure"], state["Density"])
    speed = jnp.linalg.norm(state["Velocity"], axis=-1)
    return cfl * dm.min_edge / (jnp.max(c + speed) + TINY)


def viscous_force(state, dm: DeviceMesh, far: FarField, mu: float,
                  bc: BCSpec = BCSpec()):
    """ViscousForceInner over the FVM relation: per face
    F = mu (v_r - v_l) / r_eff * A, reduced per cell (the ghost right state
    gives the non-slip wall shear)."""
    (_, vel_l, _), (_, vel_r, _) = face_states(state, dm, far, bc)
    f = mu * (vel_r - vel_l) / dm.r_eff[:, None] * dm.area[:, None]
    return _cell_reduce(dm, f)        # (C, d) force (sign: + accelerates)


def wc_integration_step(state, dm: DeviceMesh, eos, riemann, far: FarField,
                        dt, mu: float = 0.0, bc: BCSpec = BCSpec()):
    """One conservative Eulerian WCSPH step: the reference splits it into
    EulerianIntegration1stHalf (momentum, interface p* v*) and 2ndHalf
    (mass, rho* v*) executed back to back with the same dt — combined here
    into one flux evaluation (identical update order: both halves read the
    same pre-step state).

    d(rho)/dt   = -(1/V) sum_f rho* (v*.n) A
    d(rho v)/dt = -(1/V) sum_f [rho* v* (v*.n) + p* n] A  + F_visc/V
    """
    (rho_l, vel_l, p_l), (rho_r, vel_r, p_r) = face_states(state, dm, far, bc)
    # interface_state's e_ij points j -> i = INTO the owner = -normal
    e_ij = -dm.normal
    rho_s, vel_s, p_s = interface_state(riemann, rho_l, vel_l, p_l,
                                        rho_r, vel_r, p_r, e_ij)
    vn = jnp.sum(vel_s * dm.normal, axis=-1)
    mass_flux = rho_s * vn * dm.area
    mom_flux = ((rho_s * vn)[:, None] * vel_s + p_s[:, None] * dm.normal) \
        * dm.area[:, None]

    div_mass = _cell_reduce(dm, mass_flux)
    div_mom = _cell_reduce(dm, mom_flux)

    rho = state["Density"]
    mom = rho[:, None] * state["Velocity"]
    inv_v = 1.0 / dm.volumes
    rho_new = rho - dt * inv_v * div_mass
    mom_new = mom - dt * inv_v[:, None] * div_mom
    if mu != 0.0:
        mom_new = mom_new + dt * inv_v[:, None] * viscous_force(
            state, dm, far, mu, bc)
    vel_new = mom_new / jnp.maximum(rho_new, TINY)[:, None]
    out = dict(state)
    out["Density"] = rho_new
    out["Velocity"] = vel_new
    out["Pressure"] = eos.pressure(rho_new)
    return out


def force_on_boundary(state, dm: DeviceMesh, riemann, far: FarField,
                      mu: float, boundary: int = 3):
    """PressureForceFromFluidInFVM + ViscousForceFromFluidInFVM: total
    (pressure, viscous) force the fluid exerts on the faces of one
    boundary type (drag/lift on the cylinder)."""
    (rho_l, vel_l, p_l), (rho_r, vel_r, p_r) = face_states(state, dm, far)
    rho_s, vel_s, p_s = interface_state(riemann, rho_l, vel_l, p_l,
                                        rho_r, vel_r, p_r, -dm.normal)
    sel = ((dm.btype == boundary) & ~dm.interior).astype(p_s.dtype)
    f_press = jnp.sum((sel * p_s * dm.area)[:, None] * dm.normal, axis=0)
    shear = mu * (vel_l - vel_r) / dm.r_eff[:, None] * dm.area[:, None]
    f_visc = jnp.sum(sel[:, None] * shear, axis=0)
    return f_press, f_visc


# ---------------------------------------------------------------------------
# Compressible (ideal-gas) HLLC path — counterpart of the reference's
# EulerianCompressibleIntegration1st/2ndHalfHLLCWithLimiterRiemann stack as
# used by test_2d_eulerian_supersonic_flow_new_BC (Mach-2 cylinder) and the
# FVM double-mach-reflection case.
# ---------------------------------------------------------------------------

def make_compressible_fvm_state(dm: DeviceMesh, gas, rho0: float, vel0,
                                p0: float, dtype=jnp.float32):
    C = dm.n_cells
    dim = dm.normal.shape[1]
    vel = jnp.broadcast_to(jnp.asarray(vel0, dtype), (C, dim)) + 0.0
    rho = jnp.full((C,), rho0, dtype)
    p = jnp.full((C,), p0, dtype)
    E = p / (gas.gamma - 1.0) + 0.5 * rho * jnp.sum(vel ** 2, -1)
    return {"Density": rho, "Velocity": vel, "Pressure": p,
            "TotalEnergyDensity": E}


def compressible_face_states(state, dm: DeviceMesh, far: FarField, gas):
    """Ghost BCs of the supersonic stack
    (2d_eulerian_supersonic_flow_around_cylinder.h:80-160):
      wall (3): REFLECTIVE slip — mirror the normal velocity component;
      far field (9): supersonic characteristic switch — faces where the
        freestream enters (v_far . n_out < 0) impose the freestream state,
        faces where the flow leaves copy the owner (zero gradient).
    """
    rho, vel, p = state["Density"], state["Velocity"], state["Pressure"]
    E = state["TotalEnergyDensity"]
    l = (rho[dm.owner], vel[dm.owner], p[dm.owner], E[dm.owner])
    rho_r, vel_r, p_r, E_r = rho[dm.neigh], vel[dm.neigh], p[dm.neigh], E[dm.neigh]

    bt = dm.btype
    wall = ~dm.interior & ((bt == 3) | (bt == 7))
    farf = ~dm.interior & ((bt == 9) | (bt == 5))

    vn = jnp.sum(l[1] * dm.normal, axis=-1, keepdims=True)
    vel_r = jnp.where(wall[:, None], l[1] - 2.0 * vn * dm.normal, vel_r)
    rho_r = jnp.where(wall, l[0], rho_r)
    p_r = jnp.where(wall, l[2], p_r)
    E_r = jnp.where(wall, l[3], E_r)

    v_far = jnp.asarray(far.vel, vel.dtype)
    inflow = farf & (jnp.sum(v_far * dm.normal, axis=-1) < 0.0)
    E_far = far.p / (gas.gamma - 1.0) + 0.5 * far.rho * jnp.sum(v_far ** 2)
    vel_r = jnp.where(inflow[:, None], v_far[None, :], vel_r)
    rho_r = jnp.where(inflow, far.rho, rho_r)
    p_r = jnp.where(inflow, far.p, p_r)
    E_r = jnp.where(inflow, E_far, E_r)
    return l, (rho_r, vel_r, p_r, E_r)


def compressible_time_step_fvm(state, gas, dm: DeviceMesh, cfl: float = 0.3):
    c = gas.sound_speed(state["Pressure"], state["Density"])
    speed = jnp.linalg.norm(state["Velocity"], axis=-1)
    return cfl * dm.min_edge / (jnp.max(c + speed) + TINY)


def compressible_step(state, dm: DeviceMesh, gas, far: FarField, dt,
                      ghost_override=None, t=0.0):
    """One conservative ideal-gas step with HLLC star-state face fluxes:
      F_mass = rho* vn* A,  F_mom = (rho* v* vn* + p* n) A,
      F_E    = (E* + p*) vn* A.

    `ghost_override(l, r, dm, t) -> r` replaces the default boundary ghost
    states entirely (case-specific BC setups like the double-mach
    reflection's mixed/time-dependent boundaries)."""
    from sphinxsys_jax.physics.eulerian import hllc_interface_state

    (rho_l, vel_l, p_l, E_l), (rho_r, vel_r, p_r, E_r) = \
        compressible_face_states(state, dm, far, gas)
    if ghost_override is not None:
        rho_r, vel_r, p_r, E_r = ghost_override(
            (rho_l, vel_l, p_l, E_l), (rho_r, vel_r, p_r, E_r), dm, t)
    rho_s, vel_s, p_s, E_s = hllc_interface_state(
        gas, rho_l, vel_l, p_l, E_l, rho_r, vel_r, p_r, E_r, -dm.normal)
    vn = jnp.sum(vel_s * dm.normal, axis=-1)
    f_mass = rho_s * vn * dm.area
    f_mom = ((rho_s * vn)[:, None] * vel_s + p_s[:, None] * dm.normal) \
        * dm.area[:, None]
    f_E = (E_s + p_s) * vn * dm.area

    inv_v = 1.0 / dm.volumes
    rho = state["Density"] - dt * inv_v * _cell_reduce(dm, f_mass)
    mom = (state["Density"][:, None] * state["Velocity"]
           - dt * inv_v[:, None] * _cell_reduce(dm, f_mom))
    E = state["TotalEnergyDensity"] - dt * inv_v * _cell_reduce(dm, f_E)

    rho = jnp.maximum(rho, 1e-8)
    vel = mom / rho[:, None]
    e_int = jnp.maximum(E - 0.5 * rho * jnp.sum(vel ** 2, -1), 1e-10)
    p = (gas.gamma - 1.0) * e_int
    return {"Density": rho, "Velocity": vel, "Pressure": p,
            "TotalEnergyDensity": E}


# ---------------------------------------------------------------------------
# MUSCL reconstruction (2nd-order): Green-Gauss cell gradients +
# Barth-Jespersen limiting.  Second-order counterpart of the reference's
# WithLimiterRiemann compressible stack for sharp shocks.
# ---------------------------------------------------------------------------

def green_gauss_gradient(q, dm: DeviceMesh):
    """(C,) -> (C, d) cell gradient: grad = (1/V) sum_f q_face n_out A with
    the arithmetic face average (boundary faces use the owner value)."""
    q_f = 0.5 * (q[dm.owner] + q[dm.neigh])
    q_f = jnp.where(dm.interior, q_f, q[dm.owner])
    flux = q_f[:, None] * dm.normal * dm.area[:, None]
    return _cell_reduce(dm, flux) / dm.volumes[:, None]

def _neighbor_minmax(q, dm: DeviceMesh):
    """Per cell: min/max of q over itself and its face neighbors."""
    f = dm.cell_faces                                # (C, K)
    other = jnp.where(dm.cell_sign > 0, q[dm.neigh[f]], q[dm.owner[f]])
    other = jnp.where(dm.cell_faces < dm.area.shape[0] - 1, other,
                      q[:, None])                    # dummy face -> self
    q_min = jnp.minimum(q, jnp.min(other, axis=1))
    q_max = jnp.maximum(q, jnp.max(other, axis=1))
    return q_min, q_max

def barth_jespersen_limiter(q, grad, dm: DeviceMesh):
    """(C,) scalar limiter psi in [0,1]: reconstructed face values stay
    within the neighborhood's [min, max]."""
    q_min, q_max = _neighbor_minmax(q, dm)
    # per-cell: evaluate dq at each of ITS faces
    f = dm.cell_faces
    d_cf = dm.midpoint[f] - dm.centroids[:, None, :]          # (C, K, d)
    dq = jnp.sum(grad[:, None, :] * d_cf, axis=-1)            # (C, K)
    up = jnp.where(dq > 0, (q_max - q)[:, None] / jnp.maximum(dq, TINY), 1.0)
    dn = jnp.where(dq < 0, (q_min - q)[:, None] / jnp.minimum(dq, -TINY), 1.0)
    psi_f = jnp.minimum(jnp.minimum(up, dn), 1.0)
    psi_f = jnp.where(f < dm.area.shape[0] - 1, psi_f, 1.0)   # ignore pad
    return jnp.maximum(jnp.min(psi_f, axis=1), 0.0)

def muscl_face_values(q, dm: DeviceMesh):
    """Limited linear reconstruction of q at each face from BOTH sides:
    returns (q_left_at_face, q_right_at_face) for interior faces (boundary
    right side = owner reconstruction, replaced by the ghost later)."""
    grad = green_gauss_gradient(q, dm)
    psi = barth_jespersen_limiter(q, grad, dm)
    lim_grad = psi[:, None] * grad
    d_l = dm.midpoint - dm.centroids[dm.owner]
    d_r = dm.midpoint - dm.centroids[dm.neigh]
    q_l = q[dm.owner] + jnp.sum(lim_grad[dm.owner] * d_l, axis=-1)
    q_r = q[dm.neigh] + jnp.sum(lim_grad[dm.neigh] * d_r, axis=-1)
    return q_l, q_r

def compressible_step_muscl(state, dm: DeviceMesh, gas, far: FarField, dt,
                            ghost_override=None, t=0.0):
    """Second-order variant of compressible_step: primitive variables
    (rho, u, v, p) are MUSCL-reconstructed to the face midpoints before
    the HLLC flux; ghost boundary states are built from the reconstructed
    owner-side values.  `ghost_override` as in compressible_step."""
    from sphinxsys_jax.physics.eulerian import hllc_interface_state

    rho, vel, p = state["Density"], state["Velocity"], state["Pressure"]
    rho_l, rho_r = muscl_face_values(rho, dm)
    p_l, p_r = muscl_face_values(p, dm)
    u_l, u_r = muscl_face_values(vel[:, 0], dm)
    v_l, v_r = muscl_face_values(vel[:, 1], dm)
    vel_l = jnp.stack([u_l, v_l], -1)
    vel_r = jnp.stack([u_r, v_r], -1)
    # positivity guard on the reconstruction
    rho_l = jnp.maximum(rho_l, 1e-8)
    rho_r = jnp.maximum(rho_r, 1e-8)
    p_l = jnp.maximum(p_l, 1e-10)
    p_r = jnp.maximum(p_r, 1e-10)
    E_l = p_l / (gas.gamma - 1.0) + 0.5 * rho_l * jnp.sum(vel_l ** 2, -1)
    E_r = p_r / (gas.gamma - 1.0) + 0.5 * rho_r * jnp.sum(vel_r ** 2, -1)

    # ghost right states at boundaries from the reconstructed left side
    bt = dm.btype
    wall = ~dm.interior & ((bt == 3) | (bt == 7))
    farf = ~dm.interior & ((bt == 9) | (bt == 5))
    vn = jnp.sum(vel_l * dm.normal, axis=-1, keepdims=True)
    vel_r = jnp.where(wall[:, None], vel_l - 2.0 * vn * dm.normal, vel_r)
    rho_r = jnp.where(wall, rho_l, rho_r)
    p_r = jnp.where(wall, p_l, p_r)
    E_r = jnp.where(wall, E_l, E_r)
    v_far = jnp.asarray(far.vel, vel.dtype)
    inflow = farf & (jnp.sum(v_far * dm.normal, axis=-1) < 0.0)
    E_far = far.p / (gas.gamma - 1.0) + 0.5 * far.rho * jnp.sum(v_far ** 2)
    outflow = farf & ~inflow
    vel_r = jnp.where(inflow[:, None], v_far[None, :],
                      jnp.where(outflow[:, None], vel_l, vel_r))
    rho_r = jnp.where(inflow, far.rho, jnp.where(outflow, rho_l, rho_r))
    p_r = jnp.where(inflow, far.p, jnp.where(outflow, p_l, p_r))
    E_r = jnp.where(inflow, E_far, jnp.where(outflow, E_l, E_r))
    if ghost_override is not None:
        rho_r, vel_r, p_r, E_r = ghost_override(
            (rho_l, vel_l, p_l, E_l), (rho_r, vel_r, p_r, E_r), dm, t)

    rho_s, vel_s, p_s, E_s = hllc_interface_state(
        gas, rho_l, vel_l, p_l, E_l, rho_r, vel_r, p_r, E_r, -dm.normal)
    vnf = jnp.sum(vel_s * dm.normal, axis=-1)
    f_mass = rho_s * vnf * dm.area
    f_mom = ((rho_s * vnf)[:, None] * vel_s + p_s[:, None] * dm.normal) \
        * dm.area[:, None]
    f_E = (E_s + p_s) * vnf * dm.area

    inv_v = 1.0 / dm.volumes
    rho_n = state["Density"] - dt * inv_v * _cell_reduce(dm, f_mass)
    mom = (state["Density"][:, None] * state["Velocity"]
           - dt * inv_v[:, None] * _cell_reduce(dm, f_mom))
    E = state["TotalEnergyDensity"] - dt * inv_v * _cell_reduce(dm, f_E)
    rho_n = jnp.maximum(rho_n, 1e-8)
    vel_n = mom / rho_n[:, None]
    e_int = jnp.maximum(E - 0.5 * rho_n * jnp.sum(vel_n ** 2, -1), 1e-10)
    return {"Density": rho_n, "Velocity": vel_n,
            "Pressure": (gas.gamma - 1.0) * e_int, "TotalEnergyDensity": E}
