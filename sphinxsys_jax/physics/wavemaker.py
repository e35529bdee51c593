"""Prescribed-motion wavemaker wall parts + wave-tank boundary helpers.

Counterpart of the reference's per-case `WaveMaking :
BodyPartMotionConstraint` classes and the damping-zone boundary condition:

  * piston stroke / dispersion solve:
    tests/2d_examples/test_2d_owsc/owsc.h:261-334 (single-frequency piston,
    Newton iteration on om^2 = g k tanh(k h), Biesel stroke transfer)
  * focused irregular packet:
    tests/2d_examples/test_2d_nonlinear_wave_fsi/nonlinear_wave_fsi.h:425-562
    (N equal-spaced frequency components, bisection dispersion solve,
    component strokes S_j = a (sinh kh cosh kh + kh)/sinh^2 kh, phases
    focusing the packet at x = xf, t = tf)
  * damping zone: fluid_dynamics::DampingBoundaryCondition
    (boundary_condition/fluid_boundary.cpp:23-32): quadratic-ramp velocity
    relaxation toward zero across the zone.

XLA shape: the motion laws are closed-form in time, evaluated on device
each acoustic sub-step; the wavemaker particles are a STATIC boolean mask
over the wall body (the reference's BodyRegionByParticle), so the update
is a masked where() — no particle lists, no host callbacks.  Coefficient
tables (om_j, k_j, S_j) are solved once at build time in numpy and closed
over as small constants.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# dispersion solves (build-time, numpy)
# ---------------------------------------------------------------------------

def dispersion_wavenumber(omega: float, depth: float, g: float,
                          iterations: int = 50, tol: float = 1e-12) -> float:
    """Solve om^2 = g k tanh(k h) for k by Newton iteration (the reference's
    computeWaveStrokeAndFrequency loop, owsc.h:299-313)."""
    k = max(omega * omega / g, 1e-8)  # deep-water start
    for _ in range(iterations):
        t = math.tanh(k * depth)
        f = k * t - omega * omega / g
        df = t + k * depth * (1.0 - t * t)
        k_new = k - f / df
        if abs(k_new - k) / abs(k_new) <= tol:
            return k_new
        k = k_new
    return k


def piston_stroke(wave_amp: float, k: float, depth: float, g: float,
                  omega: float) -> float:
    """Biesel first-order piston transfer (owsc.h:315-319):
        stroke = 0.5 a k (g/om^2) (2kh + sinh 2kh) / (cosh kh sinh kh)."""
    kh = k * depth
    return (0.5 * wave_amp * k * (g / omega / omega) *
            (2.0 * kh + math.sinh(2.0 * kh)) /
            (math.cosh(kh) * math.sinh(kh)))


class PistonMotion(NamedTuple):
    """Single-frequency piston: x(t) = 0.5 stroke sin(om t)
    (owsc.h WaveMaking::getDisplacement/Velocity/Acceleration)."""

    stroke: float
    omega: float

    def displacement(self, t):
        return 0.5 * self.stroke * jnp.sin(self.omega * t)

    def velocity(self, t):
        return 0.5 * self.stroke * self.omega * jnp.cos(self.omega * t)

    def acceleration(self, t):
        return (-0.5 * self.stroke * self.omega * self.omega *
                jnp.sin(self.omega * t))


def make_piston(wave_height: float, wave_period: float, depth: float,
                g: float, model_scale: float = 1.0) -> PistonMotion:
    """OWSC-style scaled piston (owsc.h:292-323): Froude-scale the target
    wave, solve dispersion, Biesel stroke."""
    h_s = wave_height / model_scale
    t_s = wave_period / math.sqrt(model_scale)
    omega = 2.0 * math.pi / t_s
    k = dispersion_wavenumber(omega, depth, g)
    stroke = piston_stroke(0.5 * h_s, k, depth, g, omega)
    return PistonMotion(stroke=stroke, omega=omega)


class FocusedPacketMotion(NamedTuple):
    """N-component focused packet (nonlinear_wave_fsi.h:439-474):
        x(t)  = sum_j 0.5 S_j cos(-k_j xf - om_j (t - tf))
        v(t)  = sum_j 0.5 om_j S_j sin(-k_j xf - om_j (t - tf))
        a(t)  = -sum_j 0.5 om_j^2 S_j cos(-k_j xf - om_j (t - tf))."""

    om: jnp.ndarray    # (N,)
    k: jnp.ndarray     # (N,)
    S: jnp.ndarray     # (N,)
    tf: float
    xf: float

    def _phase(self, t):
        return -self.k * self.xf - self.om * (t - self.tf)

    def displacement(self, t):
        return jnp.sum(0.5 * self.S * jnp.cos(self._phase(t)))

    def velocity(self, t):
        return jnp.sum(0.5 * self.om * self.S * jnp.sin(self._phase(t)))

    def acceleration(self, t):
        return -jnp.sum(0.5 * self.om * self.om * self.S *
                        jnp.cos(self._phase(t)))


def make_focused_packet(depth: float, tf: float, xf: float, fmin: float,
                        fmax: float, amplitude: float, n_components: int,
                        g: float, dtype=jnp.float32) -> FocusedPacketMotion:
    """Build the (om, k, S) component tables (nonlinear_wave_fsi.h:481-539;
    frequencies f_j = fmin + j (fmax-fmin)/N, strokes
    S_j = a (sinh kh cosh kh + kh) / sinh^2 kh)."""
    f = np.array([fmin + i * (fmax - fmin) / n_components
                  for i in range(n_components)])
    om = 2.0 * math.pi * f
    k = np.array([dispersion_wavenumber(o, depth, g) for o in om])
    kh = k * depth
    S = amplitude * (np.sinh(kh) * np.cosh(kh) + kh) / np.sinh(kh) ** 2
    return FocusedPacketMotion(om=jnp.asarray(om, dtype),
                               k=jnp.asarray(k, dtype),
                               S=jnp.asarray(S, dtype), tf=tf, xf=xf)


# ---------------------------------------------------------------------------
# device-side application
# ---------------------------------------------------------------------------

def apply_wavemaker(wall: dict, mask, motion, t, axis: int = 0) -> dict:
    """Impose the prescribed piston motion on the masked wall particles:
    Position = InitialPosition + d(t) e_axis, velocity/acceleration filled
    into the averaged channels the fluid wall BCs read
    (BodyPartMotionConstraint::update + the fluid's wall Riemann terms).
    `wall` must carry "InitialPosition"."""
    out = dict(wall)
    pos0 = wall["InitialPosition"]
    d = motion.displacement(t)
    v = motion.velocity(t)
    a = motion.acceleration(t)
    zeros = jnp.zeros_like(pos0)
    disp = zeros.at[:, axis].set(d)
    vel = zeros.at[:, axis].set(v)
    acc = zeros.at[:, axis].set(a)
    m = mask[:, None]
    out["Position"] = jnp.where(m, pos0 + disp, wall["Position"])
    for key, val in (("Velocity", vel), ("AverageVelocity", vel),
                     ("AverageAcceleration", acc)):
        base = wall.get(key, zeros)
        out[key] = jnp.where(m, val, base)
    return out


def damping_zone(fluid: dict, mask, x_lo: float, x_hi: float, dt,
                 strength: float = 5.0, axis: int = 0) -> dict:
    """DampingBoundaryCondition (fluid_boundary.cpp:23-32): relax velocity
    to zero with a quadratic ramp across [x_lo, x_hi] along `axis`."""
    out = dict(fluid)
    x = fluid["Position"][:, axis]
    factor = (x - x_lo) / (x_hi - x_lo)
    scale = (1.0 - dt * strength * factor * factor)[:, None]
    out["Velocity"] = jnp.where(mask[:, None],
                                fluid["Velocity"] * scale, fluid["Velocity"])
    return out
