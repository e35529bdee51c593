"""Finite-volume (FVM) front end on unstructured meshes.

Counterpart of the reference's FVM stack:
  * ANSYS/Fluent .msh parsing — src/shared/bodies/complex_bodies/
    unstructured_mesh.h (ANSYSMesh) + for_2D_build/bodies/
    unstructured_mesh_2d.cpp
  * ghost boundary machinery — src/shared/particle_dynamics/
    general_dynamics/boundary_condition/fvm_ghost_boundary.h
  * Eulerian WCSPH-in-FVM dynamics — tests/2d_examples/
    test_2d_FVM_flow_around_cylinder/FVM_flow_around_cylinder_2d_def.h

XLA-native design: the reference stores a per-cell ragged neighborhood and
runs the SPH kernels over it with dW_ij = -A_f / (2 V_i V_j).  Here the
mesh is compiled ONCE (host-side NumPy) into flat face arrays plus a dense
padded cell->face incidence table; every solver op is then face gathers +
a (C, K_max) incidence gather-sum — no scatters, no ragged structures, and
the whole time step jits to one XLA program.
"""

from sphinxsys_jax.fvm.mesh import FVMesh, read_fluent_msh, compile_mesh
from sphinxsys_jax.fvm.meshgen import cylinder_ogrid, write_fluent_msh
