"""Implicit particle relaxation of a turbine-blade section.

Counterpart of /root/reference/tests/2d_examples/test_2d_implicit_relaxation/
implicit_relaxation.cpp: a MultiPolygon blade (data/TurbineBlade.dat) at
dx = 1/25 is lattice-filled, randomized by 0.25 dx, and relaxed with
RelaxationStepLevelSetCorrectionInnerImplicit for 1000 iterations; the
regression quantity is the body-average |ZeroOrderResidual| ("Particle
KineticEnergy") every 200 iterations.

XLA-first deviations (documented):
  * the reference's sequenced splitting sweep (each particle solves its
    local system and immediately scatters -B k to its neighbors) is
    replaced by the order-free Jacobi two-pass solve in
    physics/relax.py::implicit_relaxation_update;
  * the level-set kernel/gradient/second-gradient integrals are the same
    sampled cut-cell mesh integrals the reference probes
    (level_set_transformation.hpp:78-138), built by
    meshes/levelset.py::update_kernel_integrals.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.geometry import Polygon
from sphinxsys_jax.meshes.levelset import build_levelset
from sphinxsys_jax.neighbors.cell_list import CellGrid
from sphinxsys_jax.physics.relax import relax_shape_implicit

BLADE_DAT = ("/root/reference/tests/2d_examples/test_2d_implicit_relaxation/"
             "data/TurbineBlade.dat")
DX = 1.0 / 25.0


def load_blade() -> Polygon:
    pts = np.loadtxt(BLADE_DAT)
    return Polygon(vertices=tuple(map(tuple, pts)))


def run_case(n_iterations: int = 1000, record_every: int = 200,
             seed: int = 0):
    """Returns (relaxed positions, avg-|residual| curve at the recording
    cadence, initial lattice positions)."""
    blade = load_blade()
    lo, hi = blade.bounds()
    pad = 4 * DX
    dom_lo = np.asarray(lo) - pad
    dom_hi = np.asarray(hi) + pad
    pos0, vol = generate_lattice(blade, dom_lo, dom_hi, DX)
    adaptation = SPHAdaptation(spacing=DX, dim=2)
    cell = adaptation.cutoff
    n_cells = tuple(int(np.ceil((dom_hi[d] - dom_lo[d]) / cell)) + 1
                    for d in range(2))
    grid = CellGrid(lower=tuple(dom_lo), spacing=(cell, cell), shape=n_cells)
    ls = build_levelset(blade, dom_lo, dom_hi, DX, dtype=jnp.float64) \
        .update_kernel_integrals(adaptation.kernel, 2)
    pos, curve = relax_shape_implicit(
        blade, jnp.asarray(pos0), vol, adaptation, grid,
        n_iterations=n_iterations, record_every=record_every, seed=seed,
        levelset=ls)
    return pos, curve, pos0
