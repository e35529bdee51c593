"""Resolution policy: smoothing length, spacing, reference number density.

Counterpart of /root/reference/src/shared/adaptations/adaptation.h:53.
Defaults match the reference: h/dx = 1.3 (adaptation.h:71), Wendland C2
kernel with cutoff 2h (adaptation.cpp:16).
"""

from __future__ import annotations

import dataclasses

from sphinxsys_jax.core import kernels as K


@dataclasses.dataclass(frozen=True)
class SPHAdaptation:
    spacing: float
    dim: int
    h_spacing_ratio: float = 1.3
    kernel_cls: type = K.WendlandC2

    @property
    def h(self) -> float:
        return self.h_spacing_ratio * self.spacing

    @property
    def kernel(self) -> K.SmoothingKernel:
        return self.kernel_cls(h=self.h)

    @property
    def cutoff(self) -> float:
        return self.kernel.cutoff

    @property
    def volume(self) -> float:
        """Lattice particle volume = spacing^dim."""
        return self.spacing ** self.dim

    @property
    def sigma0(self) -> float:
        """Reference (lattice) number density
        (adaptation.cpp computeLatticeNumberDensity)."""
        return K.lattice_number_density(self.kernel, self.spacing, self.dim)
