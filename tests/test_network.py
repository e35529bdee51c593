"""Tree/network body generation (core/network.py) vs
particle_generator_network.cpp + tree_body.cpp semantics, and diffusion
along the tree relation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.network import generate_network


_CACHE = {}


def _sphere_net(iterations=4, **kw):
    key = (iterations, tuple(sorted(kw.items())))
    if key not in _CACHE:
        sphere = G.Ball(center=(0.0, 0.0, 0.0), radius=1.0)
        _CACHE[key] = generate_network(
            sphere, starting_point=(0.0, 0.0, 1.0),
            second_point=(0.1, 0.0, 0.995), iterations=iterations,
            segment_length=0.08, segments_per_branch=6, **kw)
    return _CACHE[key]


def test_network_grows_on_surface():
    """Every particle is projected onto the shape surface
    (createATentativeNewBranchPoint, network_cpp:65-75); the tree branches
    over the generations."""
    net = _sphere_net()
    assert net.n_particles > 40
    r = np.linalg.norm(net.positions, axis=1)
    assert np.abs(r - 1.0).max() < 1e-3
    # binary bifurcation: more branches than generations
    assert len(net.branches) > 6
    # consecutive particles a segment length apart
    e = net.edges()
    d = np.linalg.norm(net.positions[e[:, 0]] - net.positions[e[:, 1]], axis=1)
    assert d.max() < 2.0 * net.segment_length + 1e-9
    assert d.min() > 0.2 * net.segment_length


def test_network_collision_rejection():
    """Non-family branches keep their distance (isCollision,
    network_cpp:76-102): no particle pair from unrelated branches sits
    closer than ~the collision radius at creation time."""
    net = _sphere_net()
    pos, bid = net.positions, net.branch_id
    # family map: parent and siblings allowed close
    family = {}
    for b in net.branches:
        fam = {b.id, b.parent} | set(b.children)
        if b.parent >= 0:
            fam |= set(net.branches[b.parent].children)
        family[b.id] = fam
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    n = len(pos)
    viol = 0
    for i in range(n):
        for j in range(i + 1, n):
            if bid[j] not in family[bid[i]] and d[i, j] < 1.0 * net.segment_length:
                viol += 1
    assert viol == 0


def test_tree_adjacency_and_diffusion():
    """The padded tree relation feeds NeighborList-based dynamics: scalar
    diffusion spreads from the root along the network monotonically with
    total concentration conserved (the reference's network-diffusion use of
    TreeInnerRelation)."""
    from sphinxsys_jax.neighbors.neighbor_list import NeighborList

    net = _sphere_net()
    n = net.n_particles
    adj = net.adjacency(k_max=4)
    count = np.sum(adj < n, axis=1)
    assert count.max() <= 4 and count.min() >= 1
    # graph-Laplacian diffusion along the tree (explicit Euler)
    nl_idx = jnp.asarray(adj, jnp.int32)
    phi = jnp.zeros((n,)).at[0].set(1.0)
    mask = (nl_idx < n)
    idx_safe = jnp.minimum(nl_idx, n - 1)

    @jax.jit
    def step(phi):
        phi_j = phi[idx_safe] * mask
        lap = jnp.sum(phi_j - phi[:, None] * mask, axis=1)
        return phi + 0.2 * lap

    for _ in range(200):
        phi = step(phi)
    phi = np.asarray(phi)
    assert phi.sum() == pytest.approx(1.0, rel=1e-4)   # conservation
    assert (phi > 0).all()                             # reached every node
    # concentration decays with graph distance from the root on the trunk
    trunk = net.branches[1].particles
    assert phi[trunk[0]] > phi[trunk[-1]]
