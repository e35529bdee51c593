"""Tree/network bodies: branching particle networks grown on a surface.

Counterpart of the reference's ParticleGenerator<BaseParticles, Network>
(for_3D_build/particle_generator/particle_generator_network.cpp) and
TreeBody (shared/bodies/complex_bodies/tree_body.{h,cpp}): a binary tree of
branches is grown over a Shape's surface — each tentative segment endpoint
is pulled back onto the surface (x -= phi * n), steered by (a) the branch
bifurcation angle in the local tangent plane and (b) a repulsive "density
gradient" away from already-placed particles, and rejected when it collides
with a non-family branch (distance < 5 segment lengths).

Generation is a one-time host-side precompute (the reference also runs it
serially at startup), so plain NumPy with an incremental brute-force
nearest-neighbor; the OUTPUT is flat arrays — positions, per-particle
branch ids, and the tree adjacency as a padded (N, K) neighbor table that
drops straight into the jitted relation-based dynamics (the reference's
TreeInnerRelation for network diffusion)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

TINY = 1.0e-12


@dataclasses.dataclass
class Branch:
    """TreeBody::Branch (tree_body.h): particle list + topology."""

    id: int
    parent: int
    particles: List[int]
    end_direction: np.ndarray
    children: List[int]
    is_terminated: bool = False


@dataclasses.dataclass
class TreeNetwork:
    positions: np.ndarray        # (N, d)
    branch_id: np.ndarray        # (N,)
    branches: List[Branch]
    segment_length: float

    @property
    def n_particles(self) -> int:
        return len(self.positions)

    def edges(self) -> np.ndarray:
        """(E, 2) int edges: consecutive particles within a branch + the
        junction edge from the parent branch's last particle to the child
        branch's first (TreeBody::buildLocationReference)."""
        out = []
        for b in self.branches:
            for a, c in zip(b.particles[:-1], b.particles[1:]):
                out.append((a, c))
            if b.parent >= 0 and b.particles:
                parent = self.branches[b.parent]
                if parent.particles:
                    out.append((parent.particles[-1], b.particles[0]))
        return np.asarray(out, np.int64).reshape(-1, 2)

    def adjacency(self, k_max: int = 4) -> np.ndarray:
        """Padded (N, K) neighbor table of the tree relation (sentinel =
        N), for NeighborList-based dynamics along the network."""
        n = self.n_particles
        adj = np.full((n, k_max), n, np.int64)
        cnt = np.zeros(n, np.int64)
        for a, b in self.edges():
            for x, y in ((a, b), (b, a)):
                if cnt[x] >= k_max:
                    raise ValueError("k_max too small for tree adjacency")
                adj[x, cnt[x]] = y
                cnt[x] += 1
        return adj


class _Grower:
    def __init__(self, shape, segment_length: float, grad_factor: float,
                 angle: float, repulsivity: float, seed: int):
        import jax.numpy as jnp

        from sphinxsys_jax.utils.hosteval import host_eval

        self.shape = shape
        self.seg = segment_length
        self.grad_factor = grad_factor
        self.angle = angle
        self.repulsivity = repulsivity
        self.rng = np.random.default_rng(seed)
        self.pos: List[np.ndarray] = []
        self.branch_of: List[int] = []
        self.branches: List[Branch] = []
        self._jnp = jnp
        self._host_eval = host_eval

    # -- shape queries ---------------------------------------------------
    def _sd(self, p):
        return float(self._host_eval(self.shape.signed_distance,
                                     self._jnp.asarray(p)[None])[0])

    def _normal(self, p):
        n = np.asarray(self._host_eval(self.shape.find_normal_direction,
                                       self._jnp.asarray(p)[None])[0],
                       np.float64)
        return n / (np.linalg.norm(n) + TINY)

    def _project(self, p):
        """createATentativeNewBranchPoint: pull the point onto the surface."""
        return p - self._sd(p) * self._normal(p)

    # -- nearest neighbor over placed particles --------------------------
    def _nearest(self, p):
        arr = np.asarray(self.pos)
        d = np.linalg.norm(arr - p, axis=1)
        i = int(np.argmin(d))
        return i, arr[i], d[i]

    def _density_gradient(self, p):
        """getGradientFromNearestPoints: central difference of the
        distance-to-nearest-particle field — points AWAY from crowded
        regions (network_cpp:40-63)."""
        delta = self.grad_factor * self.seg
        dim = len(p)
        grad = np.zeros(dim)
        for i in range(dim):
            up, down = p.copy(), p.copy()
            up[i] -= delta
            down[i] += delta
            _, _, du = self._nearest(up)
            _, _, dd = self._nearest(down)
            grad[i] = (dd - du) / 2.0 * delta
        return grad

    # -- growth ----------------------------------------------------------
    def _add_particle(self, branch: Branch, p, end_dir):
        self.pos.append(np.asarray(p, np.float64))
        self.branch_of.append(branch.id)
        branch.particles.append(len(self.pos) - 1)
        branch.end_direction = end_dir

    def _is_collision(self, new_point, parent_id):
        """isCollision (network_cpp:76-102): reject a point whose nearest
        placed particle belongs to a non-family branch and is closer than
        5 segment lengths."""
        i, q, d = self._nearest(new_point)
        loc = self.branch_of[i]
        family = {parent_id} | set(self.branches[parent_id].children)
        return (loc not in family) and (d < 5.0 * self.seg)

    def grow_branch(self, parent_id: int, angle: float, repulsivity: float,
                    n_segments: int) -> bool:
        parent = self.branches[parent_id]
        init_point = np.asarray(self.pos[parent.particles[-1]])
        init_dir = parent.end_direction

        surf_n = self._normal(init_point)
        in_plane = -np.cross(init_dir, surf_n)
        grad = self._density_gradient(init_point)
        direction = np.cos(angle) * init_dir + np.sin(angle) * in_plane
        direction /= np.linalg.norm(direction) + TINY
        end_dir = repulsivity * grad + direction
        end_dir /= np.linalg.norm(end_dir) + TINY

        new_point = self._project(init_point + end_dir * self.seg)
        if self._is_collision(new_point, parent_id):
            return False

        branch = Branch(id=len(self.branches), parent=parent_id,
                        particles=[], end_direction=end_dir, children=[])
        self.branches.append(branch)
        parent.children.append(branch.id)
        self._add_particle(branch, new_point, end_dir)

        for _ in range(1, n_segments):
            surf_n = self._normal(new_point)
            grad = self._density_gradient(new_point)
            grad -= np.dot(grad, surf_n) * surf_n     # project to surface
            direction = repulsivity * grad + end_dir
            direction /= np.linalg.norm(direction) + TINY
            end_dir = direction
            end_point = new_point
            new_point = self._project(end_point + end_dir * self.seg)
            if self._is_collision(new_point, parent_id):
                branch.is_terminated = True
                break
            if np.linalg.norm(new_point - end_point) < 0.5 * self.seg:
                branch.is_terminated = True
                break
            self._add_particle(branch, new_point, end_dir)
        return True


def generate_network(shape, starting_point, second_point, iterations: int,
                     grad_factor: float = 5.0, segment_length: float = 0.1,
                     segments_per_branch: int = 10, angle: float = 0.3,
                     repulsivity: float = 0.5, fascicles: bool = False,
                     fascicle_angles=(-1.25, 0.75), fascicle_ratio: float = 2.0,
                     seed: int = 0) -> TreeNetwork:
    """ParticleGenerator<BaseParticles, Network>::prepareGeometricData
    (network_cpp:168-240): root segment toward `second_point`, optional
    fascicle pair, then `iterations` bifurcation generations at
    +-(angle + U(-0.5,0.5)*0.05) with repulsive steering."""
    start = np.asarray(starting_point, np.float64)
    second = np.asarray(second_point, np.float64)
    g = _Grower(shape, segment_length, grad_factor, angle, repulsivity, seed)

    root = Branch(id=0, parent=-1, particles=[], children=[],
                  end_direction=(second - start) / (np.linalg.norm(second - start) + TINY))
    g.branches.append(root)
    g._add_particle(root, start, root.end_direction)

    to_grow: List[int] = []
    if g.grow_branch(0, 0.0, 0.0, segments_per_branch):
        to_grow.append(len(g.branches) - 1)

    if fascicles and to_grow:
        trunk = to_grow[0]
        to_grow = []
        for a in fascicle_angles:
            n_seg = int(fascicle_ratio * segments_per_branch)
            if g.grow_branch(trunk, a, 0.0, n_seg):
                to_grow.append(len(g.branches) - 1)

    for _ in range(iterations):
        nxt: List[int] = []
        g.rng.shuffle(to_grow)
        for bid in to_grow:
            a = angle + float(g.rng.uniform(-0.5, 0.5)) * 0.05
            for sgn in (1.0, -1.0):
                if g.grow_branch(bid, sgn * a, repulsivity,
                                 segments_per_branch) \
                        and not g.branches[-1].is_terminated:
                    nxt.append(len(g.branches) - 1)
        to_grow = nxt

    return TreeNetwork(positions=np.asarray(g.pos),
                       branch_id=np.asarray(g.branch_of, np.int64),
                       branches=g.branches, segment_length=segment_length)
