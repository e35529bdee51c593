"""Mesh-based fields: narrow-band packaged level sets.

Counterpart of the reference's src/shared/meshes (SparseMeshField,
MeshWithGridDataPackages) + mesh_dynamics/level_set_dynamics.
"""

from sphinxsys_jax.meshes.levelset import (LevelSet, LevelSetShape,
                                           build_levelset)
