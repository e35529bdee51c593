from sphinxsys_jax.neighbors.cell_list import CellGrid, grid_from_bounds, build_cell_table, CellTable
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, build_neighbor_list, brute_force_neighbors

__all__ = [
    "CellGrid", "grid_from_bounds", "build_cell_table", "CellTable",
    "NeighborList", "build_neighbor_list", "brute_force_neighbors",
]
