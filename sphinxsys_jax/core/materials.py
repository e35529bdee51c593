"""Materials: equations of state and constitutive laws.

JAX counterpart of /root/reference/src/shared/materials/.  Each
material is a frozen dataclass of static scalars exposing pure jnp
functions, so material laws inline into fused interaction kernels (the
analog of the reference's POD `EosKernel`/`ConstituteKernel` device structs,
materials/weakly_compressible_fluid.h:57, materials/elastic_solid.h:141).
"""

from __future__ import annotations

import dataclasses

import math

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Material:
    """Base material (materials/base_material.h:51)."""

    rho0: float = 1.0


@dataclasses.dataclass(frozen=True)
class Solid(Material):
    """Inert solid (walls); carries only a reference density."""


@dataclasses.dataclass(frozen=True)
class WeaklyCompressibleFluid(Material):
    """Linear-EoS weakly-compressible fluid
    (materials/weakly_compressible_fluid.cpp:17-30):
        p  = rho0 c0^2 (rho/rho0 - 1)
        c  = c0  (independent of state)
    """

    c0: float = 1.0

    @property
    def p0(self) -> float:
        return self.rho0 * self.c0 * self.c0

    def pressure(self, rho):
        return self.p0 * (rho / self.rho0 - 1.0)

    def density_from_pressure(self, p):
        return self.rho0 * (p / self.p0 + 1.0)

    def sound_speed(self, p=None, rho=None):
        return self.c0


@dataclasses.dataclass(frozen=True)
class CompressibleFluid(Material):
    """Ideal-gas compressible fluid (materials/compressible_fluid.cpp):
        p = (gamma - 1) rho e ;  c = sqrt(gamma p / rho)
    """

    gamma: float = 1.4

    def pressure(self, rho, e):
        return (self.gamma - 1.0) * rho * e

    def internal_energy(self, p, rho):
        return p / (rho * (self.gamma - 1.0))

    def sound_speed(self, p, rho):
        return jnp.sqrt(self.gamma * p / rho)


@dataclasses.dataclass(frozen=True)
class Viscosity:
    """Newtonian dynamic viscosity (materials/viscosity.h:40)."""

    mu: float = 0.0

    def __call__(self, *args):
        return self.mu


# ---------------------------------------------------------------------------
# Elastic solids (materials/elastic_solid.h:46-341).
# All laws expose:
#   stress_PK1(F)   first Piola-Kirchhoff stress from deformation gradient
#   sound speeds for the elastic time-step criterion.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ElasticSolid(Solid):
    """Base linear-elastic solid parameterized by (rho0, E, nu)."""

    youngs_modulus: float = 1.0
    poisson_ratio: float = 0.3

    @property
    def shear_modulus(self) -> float:  # G
        return 0.5 * self.youngs_modulus / (1.0 + self.poisson_ratio)

    @property
    def bulk_modulus(self) -> float:  # K
        return self.youngs_modulus / (3.0 * (1.0 - 2.0 * self.poisson_ratio))

    @property
    def lambda0(self) -> float:  # Lame first parameter
        nu, E = self.poisson_ratio, self.youngs_modulus
        return nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @property
    def sound_speed(self) -> float:
        """Reference sound speed used by the elastic acoustic dt
        (materials/elastic_solid.cpp setSoundSpeeds): c0 = sqrt(K/rho0)."""
        import math

        return math.sqrt(self.bulk_modulus / self.rho0)

    def numerical_viscosity(self, smoothing_length: float) -> float:
        """Numerical damping coefficient used by the Kelvin-Voigt-type
        artificial viscosity in elastic dynamics
        (elastic_solid.cpp: 0.5 * rho0 * c0 * h)."""
        return 0.5 * self.rho0 * self.sound_speed * smoothing_length

    def stress_PK2(self, F):
        """Second Piola-Kirchhoff stress; base = linear elasticity on
        Green-Lagrange strain (Saint-Venant Kirchhoff small-strain form)."""
        dim = F.shape[-1]
        eye = jnp.eye(dim, dtype=F.dtype)
        E_green = 0.5 * (jnp.swapaxes(F, -1, -2) @ F - eye)
        return self.lambda0 * jnp.trace(E_green, axis1=-2, axis2=-1)[..., None, None] * eye \
            + 2.0 * self.shear_modulus * E_green

    def stress_PK1(self, F):
        return F @ self.stress_PK2(F)

    @property
    def shear_wave_speed(self) -> float:
        """cs0 = sqrt(G/rho0) (elastic_solid.cpp setSoundSpeeds)."""
        import math

        return math.sqrt(self.shear_modulus / self.rho0)

    def volumetric_kirchhoff(self, J):
        """Volumetric Kirchhoff stress scalar for the decomposed shear/
        volumetric split (elastic_solid.cpp:98): K J (J - 1)."""
        return self.bulk_modulus * J * (J - 1.0)

    def stress_cauchy(self, almansi_strain):
        """Cauchy stress from the Almansi strain (elastic_solid.cpp:93-96,
        linear/SVK form): sigma = lambda tr(eps) I + 2 G eps.  Used by
        Integration1stHalfCauchy via PK1 = J sigma F^-T."""
        dim = almansi_strain.shape[-1]
        eye = jnp.eye(dim, dtype=almansi_strain.dtype)
        tr = jnp.trace(almansi_strain, axis1=-2, axis2=-1)
        return self.lambda0 * tr[..., None, None] * eye \
            + 2.0 * self.shear_modulus * almansi_strain


@dataclasses.dataclass(frozen=True)
class LinearElasticSolid(ElasticSolid):
    """Alias with the reference's name (elastic_solid.h:46)."""


@dataclasses.dataclass(frozen=True)
class SaintVenantKirchhoffSolid(ElasticSolid):
    """St. Venant-Kirchhoff: S = lambda tr(E) I + 2 G E (finite strain)."""


@dataclasses.dataclass(frozen=True)
class Muscle(ElasticSolid):
    """Holzapfel-Ogden-type anisotropic muscle (elastic_solid.cpp
    Muscle::StressPK2): exponential isotropic + fiber + sheet + fiber-sheet
    invariant terms over reference directions f0/s0, plus a volumetric
    penalty.  a0/b0 follow the reference's 4-entry convention
    (iso, fiber, sheet, fiber-sheet)."""

    bulk_modulus_param: float = 1.0
    f0: tuple = (1.0, 0.0)
    s0: tuple = (0.0, 1.0)
    a0: tuple = (1.0, 0.0, 0.0, 0.0)
    b0: tuple = (1.0, 0.0, 0.0, 0.0)

    @property
    def lambda0(self) -> float:
        # Lame lambda from the bulk penalty: lambda = K - 2G/dim with the
        # reference's G = a0[0] exp(b0[0]) convention folded into the
        # isotropic term; use K-based lambda directly
        return self.bulk_modulus_param

    @property
    def sound_speed(self) -> float:
        import math

        return math.sqrt(self.bulk_modulus_param / self.rho0)

    def stress_PK2(self, F):
        dim = F.shape[-1]
        eye = jnp.eye(dim, dtype=F.dtype)
        C = jnp.swapaxes(F, -1, -2) @ F
        f0 = jnp.asarray(self.f0, dtype=F.dtype)
        s0 = jnp.asarray(self.s0, dtype=F.dtype)
        f0f0 = jnp.outer(f0, f0)
        s0s0 = jnp.outer(s0, s0)
        f0s0 = jnp.outer(f0, s0) + jnp.outer(s0, f0)
        I_ff = jnp.einsum("...ij,j,i->...", C, f0, f0) - 1.0
        I_ss = jnp.einsum("...ij,j,i->...", C, s0, s0) - 1.0
        I_fs = jnp.einsum("...ij,j,i->...", C, f0, s0)
        I_1 = jnp.trace(C, axis1=-2, axis2=-1) - dim
        J = jnp.linalg.det(F)
        Cinv = jnp.linalg.inv(C)
        a, b = self.a0, self.b0
        lam = self.lambda0
        return (a[0] * jnp.exp(b[0] * I_1))[..., None, None] * eye + \
            ((lam * (J - 1.0) - a[0]) * J)[..., None, None] * Cinv + \
            (2.0 * a[1] * I_ff * jnp.exp(b[1] * I_ff * I_ff))[..., None, None] * f0f0 + \
            (2.0 * a[2] * I_ss * jnp.exp(b[2] * I_ss * I_ss))[..., None, None] * s0s0 + \
            (a[3] * I_fs * jnp.exp(b[3] * I_fs * I_fs))[..., None, None] * f0s0


@dataclasses.dataclass(frozen=True)
class NeoHookeanSolid(ElasticSolid):
    """Compressible Neo-Hookean (elastic_solid.h NeoHookeanSolid):
        S = G J^{-2/3} (I - tr(C)/dim * C^{-1}) + K J (J-1) C^{-1}
    expressed through C = F^T F, J = det(F)."""

    def stress_PK2(self, F):
        dim = F.shape[-1]
        eye = jnp.eye(dim, dtype=F.dtype)
        C = jnp.swapaxes(F, -1, -2) @ F
        J = jnp.linalg.det(F)
        Cinv = jnp.linalg.inv(C)
        trC = jnp.trace(C, axis1=-2, axis2=-1)
        G, K = self.shear_modulus, self.bulk_modulus
        Jm23 = J ** (-2.0 / 3.0)
        dev = Jm23[..., None, None] * (eye - (trC / dim)[..., None, None] * Cinv)
        vol = (K * J * (J - 1.0))[..., None, None] * Cinv
        return G * dev + vol

    def volumetric_kirchhoff(self, J):
        """elastic_solid.cpp:129: 0.5 K (J^2 - 1)."""
        return 0.5 * self.bulk_modulus * (J * J - 1.0)

    def stress_cauchy(self, almansi_strain):
        """elastic_solid.cpp:119-126: with B = (I - 2 eps)^-1, J = sqrt(|B|):
        sigma = K/2 (J - 1/J) I + G J^{-2/d - 1} dev(B)."""
        dim = almansi_strain.shape[-1]
        eye = jnp.eye(dim, dtype=almansi_strain.dtype)
        B = jnp.linalg.inv(eye - 2.0 * almansi_strain)
        J = jnp.sqrt(jnp.linalg.det(B))
        trB = jnp.trace(B, axis1=-2, axis2=-1)
        G, K = self.shear_modulus, self.bulk_modulus
        dev = B - (trB / dim)[..., None, None] * eye
        return (0.5 * K * (J - 1.0 / J))[..., None, None] * eye \
            + G * (J ** (-2.0 / dim - 1.0))[..., None, None] * dev


@dataclasses.dataclass(frozen=True)
class FeneNeoHookeanSolid(ElasticSolid):
    """Neo-Hookean with finite extensibility (elastic_solid.cpp:200-207):
        S = G / (1 - 2 tr(E)/J1m) I + (lambda (J-1) - G) J C^{-1}
    with E the Green-Lagrange strain and J1m the reference extension."""

    j1_m: float = 1.0

    def stress_PK2(self, F):
        dim = F.shape[-1]
        eye = jnp.eye(dim, dtype=F.dtype)
        C = jnp.swapaxes(F, -1, -2) @ F
        strain_tr = 0.5 * (jnp.trace(C, axis1=-2, axis2=-1) - dim)
        J = jnp.linalg.det(F)
        Cinv = jnp.linalg.inv(C)
        G, lam = self.shear_modulus, self.lambda0
        return (G / (1.0 - 2.0 * strain_tr / self.j1_m))[..., None, None] * eye \
            + ((lam * (J - 1.0) - G) * J)[..., None, None] * Cinv


@dataclasses.dataclass(frozen=True)
class OrthotropicSolid(ElasticSolid):
    """Orthotropic elasticity with 3 principal directions
    (elastic_solid.h:248-282, elastic_solid.cpp:154-198,
    elastic_solid_3d.cpp:7-35; the reference implements 3D only).  The
    per-direction shear combination Mu_i = 1/G_i + 1/G_k - 1/G_j is
    replicated verbatim from elastic_solid_3d.cpp:10-12.  The base-class
    (E, nu) are the maxima, used for sound speed / time stepping as in the
    reference constructor."""

    a: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    E: tuple = (1.0, 1.0, 1.0)
    G: tuple = (0.5, 0.5, 0.5)
    poisson: tuple = (0.3, 0.3, 0.3)

    def __post_init__(self):
        object.__setattr__(self, "youngs_modulus", max(self.E))
        object.__setattr__(self, "poisson_ratio", max(self.poisson))

    def _params(self, dtype):
        import numpy as _np

        E, nu, G = self.E, self.poisson, self.G
        mu = _np.asarray([1 / G[0] + 1 / G[2] - 1 / G[1],
                          1 / G[1] + 1 / G[0] - 1 / G[2],
                          1 / G[2] + 1 / G[1] - 1 / G[0]])
        compliance = _np.asarray([
            [1 / E[0], -nu[0] / E[0], -nu[1] / E[0]],
            [-nu[0] / E[1], 1 / E[1], -nu[2] / E[1]],
            [-nu[1] / E[2], -nu[2] / E[1], 1 / E[2]]]).T
        cinv = _np.linalg.inv(compliance)
        lam = cinv.copy()
        for i in range(3):
            lam[i, i] = cinv[i, i] - 2 * mu[i]
        A = _np.asarray([_np.outer(self.a[i], self.a[i]) for i in range(3)])
        return (jnp.asarray(mu, dtype), jnp.asarray(lam, dtype),
                jnp.asarray(A, dtype))

    def stress_PK2(self, F):
        dtype = F.dtype
        mu, lam, A = self._params(dtype)
        eye = jnp.eye(3, dtype=dtype)
        strain = 0.5 * (jnp.swapaxes(F, -1, -2) @ F - eye)
        stress = jnp.zeros_like(strain)
        bidot = jnp.einsum("aij,...ij->...a", A, strain)   # (..., 3)
        for i in range(3):
            summa = jnp.zeros_like(strain)
            for j in range(3):
                summa = summa + lam[i, j] * (
                    bidot[..., i, None, None] * A[j]
                    + bidot[..., j, None, None] * A[i])
            stress = stress + mu[i] * (A[i] @ strain + strain @ A[i]
                                       + 0.5 * summa)
        return stress


@dataclasses.dataclass(frozen=True)
class HardeningPlasticSolid(ElasticSolid):
    """J2 plasticity with linear isotropic hardening via radial return on
    the normalized elastic left Cauchy-Green tensor
    (inelastic_solid.h:60-100, inelastic_solid.cpp:31-54).  Stateful:
    carries (inverse_plastic_strain (..,d,d), hardening_parameter (..,))
    per particle through `elastic_left_cauchy`."""

    yield_stress: float = 1.0
    hardening_modulus: float = 0.0

    def initial_plastic_state(self, n: int, dim: int, dtype=jnp.float32):
        eye = jnp.broadcast_to(jnp.eye(dim, dtype=dtype), (n, dim, dim))
        return eye, jnp.zeros((n,), dtype)

    def _trial(self, be, kappa):
        dim = be.shape[-1]
        G0 = self.shear_modulus
        nbe = be * (jnp.linalg.det(be) ** (-1.0 / dim))[..., None, None]
        iso = jnp.trace(nbe, axis1=-2, axis2=-1) / dim
        eye = jnp.eye(dim, dtype=be.dtype)
        dev_kirchhoff = G0 * (nbe - iso[..., None, None] * eye)
        dk_norm = jnp.linalg.norm(dev_kirchhoff, axis=(-2, -1))
        return nbe, iso, dev_kirchhoff, dk_norm

    def _flow_stress(self, kappa):
        return self.hardening_modulus * kappa + self.yield_stress

    def elastic_left_cauchy(self, F, inv_plastic_strain, kappa):
        """Radial-return update.  Returns (normalized_be, inv_ps', kappa')."""
        sqrt23 = math.sqrt(2.0 / 3.0)
        G0 = self.shear_modulus
        be = F @ inv_plastic_strain @ jnp.swapaxes(F, -1, -2)
        nbe, iso, dev_k, dk_norm = self._trial(be, kappa)
        trial = dk_norm - sqrt23 * self._flow_stress(kappa)
        Gr = iso * G0
        relax = jnp.maximum(trial, 0.0) * 0.5 / (Gr + self.hardening_modulus / 3.0)
        kappa_new = kappa + sqrt23 * relax
        dim = F.shape[-1]
        eye = jnp.eye(dim, dtype=F.dtype)
        dev_relaxed = dev_k - (2.0 * Gr * relax / jnp.maximum(dk_norm, 1e-15)
                               )[..., None, None] * dev_k
        relaxed_be = dev_relaxed / G0 + iso[..., None, None] * eye
        nbe_new = relaxed_be * (jnp.linalg.det(relaxed_be)
                                ** (-1.0 / dim))[..., None, None]
        yielded = (trial > 0.0)[..., None, None]
        nbe_out = jnp.where(yielded, nbe_new, nbe)
        inv_F = jnp.linalg.inv(F)
        inv_ps_new = inv_F @ nbe_out @ jnp.swapaxes(inv_F, -1, -2)
        return nbe_out, inv_ps_new, jnp.where(trial > 0.0, kappa_new, kappa)

    def kirchhoff_stress(self, normalized_be, J):
        """tau = G0 dev(be_n) + K0 J (J - 1) I (DeviatoricKirchhoff +
        LinearElasticSolid::VolumetricKirchhoff)."""
        dim = normalized_be.shape[-1]
        eye = jnp.eye(dim, dtype=normalized_be.dtype)
        iso = jnp.trace(normalized_be, axis1=-2, axis2=-1) / dim
        dev = self.shear_modulus * (normalized_be - iso[..., None, None] * eye)
        vol = (self.bulk_modulus * J * (J - 1.0))[..., None, None] * eye
        return dev + vol


@dataclasses.dataclass(frozen=True)
class NonLinearHardeningPlasticSolid(HardeningPlasticSolid):
    """Saturation-type nonlinear hardening (inelastic_solid.h:103-136,
    inelastic_solid.cpp:56-80): flow stress
      sigma_y(k) = H k + sigma_0 + (sigma_inf - sigma_0)(1 - e^{-n k})
    solved by a few Newton iterations on the return increment."""

    saturation_flow_stress: float = 1.0
    saturation_exponent: float = 1.0

    def _flow_stress(self, kappa):
        return (self.hardening_modulus * kappa + self.yield_stress
                + (self.saturation_flow_stress - self.yield_stress)
                * (1.0 - jnp.exp(-self.saturation_exponent * kappa)))

    def _flow_stress_derivative(self, kappa):
        return (self.hardening_modulus + self.saturation_exponent
                * (self.saturation_flow_stress - self.yield_stress)
                * jnp.exp(-self.saturation_exponent * kappa))

    def elastic_left_cauchy(self, F, inv_plastic_strain, kappa):
        sqrt23 = math.sqrt(2.0 / 3.0)
        G0 = self.shear_modulus
        dim = F.shape[-1]
        nF = F * (jnp.linalg.det(F) ** (-1.0 / dim))[..., None, None]
        be = nF @ inv_plastic_strain @ jnp.swapaxes(nF, -1, -2)
        nbe, iso, dev_k, dk_norm = self._trial(be, kappa)
        trial0 = dk_norm - sqrt23 * self._flow_stress(kappa)
        Gr = iso * G0

        def newton(relax, _):
            k_try = kappa + sqrt23 * relax
            f = dk_norm - sqrt23 * self._flow_stress(k_try) - 2.0 * Gr * relax
            df = -2.0 * Gr * (1.0 + self._flow_stress_derivative(k_try)
                              / (3.0 * Gr))
            return relax - f / df, None

        relax0 = jnp.zeros_like(kappa)
        relax = relax0
        for _ in range(8):            # fixed Newton iterations
            relax, _ = newton(relax, None)
        relax = jnp.maximum(relax, 0.0)
        kappa_new = kappa + sqrt23 * relax
        eye = jnp.eye(dim, dtype=F.dtype)
        dev_relaxed = dev_k - (2.0 * Gr * relax / jnp.maximum(dk_norm, 1e-15)
                               )[..., None, None] * dev_k
        relaxed_be = dev_relaxed / G0 + iso[..., None, None] * eye
        nbe_new = relaxed_be * (jnp.linalg.det(relaxed_be)
                                ** (-1.0 / dim))[..., None, None]
        yielded = (trial0 > 0.0)
        nbe_out = jnp.where(yielded[..., None, None], nbe_new, nbe)
        inv_F = jnp.linalg.inv(nF)
        inv_ps_new = inv_F @ nbe_out @ jnp.swapaxes(inv_F, -1, -2)
        return nbe_out, inv_ps_new, jnp.where(yielded, kappa_new, kappa)


@dataclasses.dataclass(frozen=True)
class ViscousPlasticSolid(HardeningPlasticSolid):
    """Perzyna-type viscoplasticity with a Herschel-Bulkley overstress law
    (inelastic_solid.h:108-136, inelastic_solid.cpp
    ViscousPlasticSolid::ElasticLeftCauchy): past yield, the deviatoric
    Kirchhoff norm relaxes toward the root of

        eta^(1/n) (s_mid - s_trial) + 2 G~ dt (s_mid - sqrt(2/3) sy)^(1/n)

    The reference solves it with an adaptive-precision host bisection;
    here a FIXED 40-step bisection on [sqrt(2/3) sy, s_trial] reaches
    2^-40 of the bracket — tighter than the reference's 1e-6 relative
    gate — and stays jittable."""

    viscous_modulus: float = 1.0
    herschel_bulkley_power: float = 1.0

    def elastic_left_cauchy(self, F, inv_plastic_strain, kappa, dt=0.0):
        """Returns (normalized_be, inv_ps', kappa) — kappa is unused (no
        hardening in the reference's viscous model) but kept for the
        shared plastic-solid op signature."""
        sqrt23 = math.sqrt(2.0 / 3.0)
        dim = F.shape[-1]
        G0 = self.shear_modulus
        be = F @ inv_plastic_strain @ jnp.swapaxes(F, -1, -2)
        nbe, iso, dev_k, dk_norm = self._trial(be, kappa)
        s_yield = sqrt23 * self.yield_stress
        trial = dk_norm - s_yield
        Gr = iso * G0

        inv_n = 1.0 / self.herschel_bulkley_power
        eta_pow = self.viscous_modulus ** inv_n

        def f(s_mid):
            return (eta_pow * (s_mid - dk_norm)
                    + 2.0 * Gr * dt * jnp.maximum(s_mid - s_yield, 0.0)
                    ** inv_n)

        lo = jnp.full_like(dk_norm, s_yield)
        hi = dk_norm

        def body(_, carry):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            neg = f(mid) < 0.0
            return (jnp.where(neg, mid, lo), jnp.where(neg, hi, mid))

        lo, hi = jax.lax.fori_loop(0, 40, body, (lo, hi))
        s_new = 0.5 * (lo + hi)

        eye = jnp.eye(dim, dtype=F.dtype)
        dev_relaxed = (s_new / jnp.maximum(dk_norm, 1e-15)
                       )[..., None, None] * dev_k
        relaxed_be = dev_relaxed / G0 + iso[..., None, None] * eye
        nbe_new = relaxed_be * (jnp.linalg.det(relaxed_be)
                                ** (-1.0 / dim))[..., None, None]
        nbe_out = jnp.where((trial > 0.0)[..., None, None], nbe_new, nbe)
        inv_F = jnp.linalg.inv(F)
        inv_ps_new = inv_F @ nbe_out @ jnp.swapaxes(inv_F, -1, -2)
        return nbe_out, inv_ps_new, kappa


@dataclasses.dataclass(frozen=True)
class LocallyOrthotropicMuscle(Muscle):
    """Muscle with PER-PARTICLE fiber/sheet directions (elastic_solid.h:
    334-372, LocallyOrthotropicMuscle::StressPK2): same Holzapfel-Ogden
    terms, the direction tensors read from local arrays — pass the
    per-particle f0/s0 fields to stress_PK2_local."""

    def local_direction_tensors(self, f0_local, s0_local):
        """(N, d) fiber + sheet fields -> (f0f0, s0s0, f0s0) (N, d, d)."""
        f0f0 = jnp.einsum("...i,...j->...ij", f0_local, f0_local)
        s0s0 = jnp.einsum("...i,...j->...ij", s0_local, s0_local)
        f0s0 = jnp.einsum("...i,...j->...ij", f0_local, s0_local) \
            + jnp.einsum("...i,...j->...ij", s0_local, f0_local)
        return f0f0, s0s0, f0s0

    def stress_PK2_local(self, F, f0_local, s0_local):
        dim = F.shape[-1]
        eye = jnp.eye(dim, dtype=F.dtype)
        C = jnp.swapaxes(F, -1, -2) @ F
        f0f0, s0s0, f0s0 = self.local_direction_tensors(f0_local, s0_local)
        I_ff = jnp.einsum("...ij,...j,...i->...", C, f0_local, f0_local) - 1.0
        I_ss = jnp.einsum("...ij,...j,...i->...", C, s0_local, s0_local) - 1.0
        I_fs = jnp.einsum("...ij,...j,...i->...", C, f0_local, s0_local)
        I_1 = jnp.trace(C, axis1=-2, axis2=-1) - dim
        J = jnp.linalg.det(F)
        Cinv = jnp.linalg.inv(C)
        a, b = self.a0, self.b0
        lam = self.lambda0
        return (a[0] * jnp.exp(b[0] * I_1))[..., None, None] * eye + \
            ((lam * (J - 1.0) - a[0]) * J)[..., None, None] * Cinv + \
            (2.0 * a[1] * I_ff * jnp.exp(b[1] * I_ff * I_ff))[..., None, None] * f0f0 + \
            (2.0 * a[2] * I_ss * jnp.exp(b[2] * I_ss * I_ss))[..., None, None] * s0s0 + \
            (a[3] * I_fs * jnp.exp(b[3] * I_fs * I_fs))[..., None, None] * f0s0


@dataclasses.dataclass(frozen=True)
class CompositeSolid(ElasticSolid):
    """Per-particle material dispatch (complex_solid.h:59-96): each
    particle carries a material_id selecting one of the composed elastic
    solids.  The XLA formulation evaluates every composed material's
    stress densely and selects by mask (the materials tuple is small,
    typically 2-3 — branch-free and vectorized where the reference
    virtual-dispatches per particle).  Sound speed for time stepping is
    the max over composites, as in the reference ctor."""

    materials: tuple = ()

    def __post_init__(self):
        if self.materials:
            stiffest = max(m.sound_speed for m in self.materials)
            object.__setattr__(self, "youngs_modulus",
                               stiffest ** 2 * self.rho0 * 3.0 * (1.0 - 2.0 *
                                                                  self.poisson_ratio))

    @property
    def sound_speed(self) -> float:
        return max(m.sound_speed for m in self.materials)

    def stress_PK2_composite(self, F, material_id):
        out = None
        for k, m in enumerate(self.materials):
            s = m.stress_PK2(F)
            out = s if out is None else jnp.where(
                (material_id == k)[..., None, None], s, out)
        return out

    def composite_density(self, material_id):
        """CompositeDensity: per-particle rho0 of the selected material."""
        rho = jnp.zeros_like(material_id, dtype=jnp.float32)
        for k, m in enumerate(self.materials):
            rho = jnp.where(material_id == k, m.rho0, rho)
        return rho
