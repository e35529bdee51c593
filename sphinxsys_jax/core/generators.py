"""Particle generators (host-side, NumPy).

Counterpart of /root/reference/src/shared/particle_generator/:
  * lattice fill of a shape (particle_generator_lattice.cpp + the 2D/3D
    loops in for_2D_build/particle_generator/particle_generator_lattice_2d.cpp:12-24)
  * observer point sets (base_particle_generator.cpp:78)
  * reload from saved relaxed distributions is in io/restart.py.

Generation is inherently host-side precompute (runs once), so plain NumPy:
lattice positions are the cell centers of a zero-buffer mesh over the
system domain bounds at the reference spacing — cell center =
lower + (i + 0.5) * dx (meshes/base_mesh.cpp Mesh ctor +
CellPositionFromIndex) — kept where shape.contains() is true.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from sphinxsys_jax.core.geometry import Shape


def lattice_positions(domain_lower, domain_upper, spacing: float) -> np.ndarray:
    """All lattice cell-center candidates over the domain bounds, matching
    the reference Mesh with buffer_width=0: n_cells per axis =
    ceil(extent/dx) + 1 - 1 (base_mesh.cpp:10-15)."""
    lo = np.asarray(domain_lower, dtype=np.float64)
    hi = np.asarray(domain_upper, dtype=np.float64)
    n_cells = np.ceil((hi - lo) / spacing).astype(int)  # all_grid_points - 1
    axes = [lo[d] + (np.arange(n_cells[d]) + 0.5) * spacing for d in range(len(lo))]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def generate_lattice(shape: Shape, domain_lower, domain_upper, spacing: float,
                     chunk: int = 1 << 20) -> Tuple[np.ndarray, float]:
    """Fill `shape` with lattice particles. Returns (positions (N,dim),
    particle volume = spacing^dim)."""
    from sphinxsys_jax.utils.hosteval import host_eval

    cand = lattice_positions(domain_lower, domain_upper, spacing)
    keep = []
    for start in range(0, len(cand), chunk):
        block = cand[start:start + chunk]
        inside = host_eval(shape.contains, jnp.asarray(block))
        keep.append(block[inside])
    pos = np.concatenate(keep, axis=0) if keep else np.zeros((0, cand.shape[1]))
    volume = float(spacing) ** cand.shape[1]
    return pos, volume


def generate_surface_lattice(shape: Shape, domain_lower, domain_upper,
                             spacing: float, thickness: float,
                             seed: int = 0, chunk: int = 1 << 20,
                             ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Surface (shell) particle generator, the reduced-order lattice
    approach of ParticleGenerator<SurfaceParticles, Lattice>
    (particle_generator_lattice.cpp:44-56 +
    for_2D_build/particle_generator/particle_generator_lattice_2d.cpp:26-70):

    scan a FINE lattice (spacing = 0.5*particle_spacing if the shell is
    thicker than a particle, else 0.5*thickness) over the thin volume
    `shape`; the occupied fine cells measure the shell volume; thin the
    occupied cells down (uniform random, fixed seed for determinism) to
    `planned = round(total_volume / (spacing^(d-1) * thickness))`
    particles.  Each particle carries volumetric measure
    avg_particle_volume / thickness = spacing^(d-1) (an AREA — shell
    particles are codimension-1), the shape normal at its position, and
    the shell thickness.

    Returns (positions (N,d), normals (N,d), area = spacing^(d-1)).
    """
    from sphinxsys_jax.utils.hosteval import host_eval

    lattice_spacing = 0.5 * spacing if thickness > spacing else 0.5 * thickness
    cand = lattice_positions(domain_lower, domain_upper, lattice_spacing)
    dim = cand.shape[1]
    keep = []
    for start in range(0, len(cand), chunk):
        block = cand[start:start + chunk]
        inside = host_eval(shape.contains, jnp.asarray(block))
        keep.append(block[inside])
    occupied = np.concatenate(keep, axis=0) if keep else np.zeros((0, dim))

    all_cells = len(occupied)
    total_volume = all_cells * lattice_spacing ** dim
    avg_particle_volume = spacing ** (dim - 1) * thickness
    planned = int(total_volume / avg_particle_volume + 0.5)
    interval = max(planned / max(all_cells, 1), 1e-30)

    rng = np.random.default_rng(seed)
    selected = rng.uniform(0.0, 1.0, size=all_cells) <= interval
    # never exceed the planned count (reference caps at planned_number_)
    cum = np.cumsum(selected)
    selected &= cum <= planned
    pos = occupied[selected]

    normals = np.asarray(host_eval(shape.find_normal_direction,
                                   jnp.asarray(pos)))
    area = float(spacing) ** (dim - 1)
    return pos, normals, area


def consistent_shell_normals(positions: np.ndarray, normals: np.ndarray,
                             reference_direction) -> np.ndarray:
    """Orient raw surface-lattice normals to one consistent side.

    Lattice surface particles straddle the mid-surface, so the shape's SDF
    gradient flips sign across it (the reference fixes this later with
    ShellNormalDirectionPrediction during relaxation,
    relax_dynamics.h:268).  This is the cheap deterministic version: flip
    every normal whose dot with `reference_direction(pos) -> (..., d)`
    (e.g. the radial direction for a cylindrical/spherical shell) is
    negative."""
    ref = np.asarray(reference_direction(positions), dtype=np.float64)
    flip = np.sum(normals * ref, axis=-1, keepdims=True) < 0.0
    return np.where(flip, -normals, normals)


def generate_observers(points) -> np.ndarray:
    """Observer particle positions (ObserverParticles)."""
    return np.asarray(points, dtype=np.float64)
