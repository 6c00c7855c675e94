"""The port's batched masked Prim (``sbayes_tpu_torch/ops/mst.py``) against
scipy's minimum spanning tree and against the JAX package's
``cluster_mst_stats_prim`` on the same numpy inputs: the triple
[total, n_edges, max_edge] of every cluster of a batch.

Tolerance: 1e-5 relative (float32 sums of at most N - 1 edge costs, added in
another order); the edge count is exact."""
import numpy as np
import pytest
from scipy.sparse.csgraph import minimum_spanning_tree

import jax
import jax.numpy as jnp
import torch

from sbayes_tpu_torch.ops.mst import cluster_mst_stats

N = 14
RTOL = 1e-5


def _cost(seed, n=N):
    """A symmetric cost matrix of planar distances (positive off the diagonal)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, size=(n, 2))
    return np.linalg.norm(xy[:, None] - xy[None], axis=-1).astype(np.float32)


def _masks(seed, sizes, n=N):
    rng = np.random.default_rng(seed)
    masks = np.zeros((len(sizes), n), bool)
    for row, size in zip(masks, sizes):
        row[rng.choice(n, size=size, replace=False)] = True
    return masks


def _scipy_triple(cost, mask):
    idx = np.flatnonzero(mask)
    if idx.size < 2:
        return np.zeros(3)
    tree = minimum_spanning_tree(cost[np.ix_(idx, idx)].astype(np.float64))
    edges = np.asarray(tree[tree.nonzero()]).ravel()
    return np.asarray([edges.sum(), edges.size, edges.max()])


def _jax_triple(cost, masks):
    from sbayes_tpu.ops.mst import cluster_mst_stats_prim

    out = jax.vmap(lambda m: jnp.stack(cluster_mst_stats_prim(jnp.asarray(cost), m)))(
        jnp.asarray(masks))
    return np.asarray(out)


def _port_triple(cost, masks):
    return cluster_mst_stats(torch.as_tensor(cost), torch.as_tensor(masks)).numpy()


@pytest.mark.parametrize("size", [0, 1, 2, 3, 7, N])
def test_one_size_against_scipy_and_jax(size):
    """Batches of equal-sized clusters, the degenerate sizes included:
    size <= 1 gives (0, 0, 0), size N spans every object."""
    cost = _cost(size)
    masks = _masks(10 + size, [size] * 4)
    got = _port_triple(cost, masks)
    assert got.shape == (4, 3)
    want = np.stack([_scipy_triple(cost, m) for m in masks])
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, _jax_triple(cost, masks), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_sizes_in_one_batch(seed):
    """Clusters of every size from 0 to N in one batch: the loop runs to the
    largest, the smaller ones are finished earlier and add nothing more."""
    cost = _cost(seed)
    masks = _masks(seed, list(range(N + 1)))
    got = _port_triple(cost, masks)
    want = np.stack([_scipy_triple(cost, m) for m in masks])
    np.testing.assert_array_equal(got[:, 1], np.maximum(np.arange(N + 1) - 1, 0))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, _jax_triple(cost, masks), rtol=RTOL, atol=1e-6)


def test_a_cluster_does_not_depend_on_its_batch():
    """The loop length is the batch's largest size: a small cluster beside a
    large one gets the bits it gets alone (finished clusters stay finished)."""
    cost = _cost(5)
    masks = _masks(5, [0, 1, 4, 9, 2, N])
    batched = _port_triple(cost, masks)
    for i in range(len(masks)):
        np.testing.assert_array_equal(batched[i], _port_triple(cost, masks[i:i + 1])[0])


def test_infinite_cut_stops_adding_edges():
    """Two components joined by no finite edge: the tree spans the start's
    component only, as the JAX package's gather-form Prim does
    (``cluster_mst_edge_costs``; its matmul form multiplies 0 by inf)."""
    from sbayes_tpu.ops.mst import cluster_mst_edge_costs

    cost = _cost(7)
    cost[:6, 6:] = np.inf
    cost[6:, :6] = np.inf
    masks = np.zeros((2, N), bool)
    masks[0, [0, 2, 4, 7, 9]] = True      # starts in the first component
    masks[1, 6:] = True                   # one component: a complete tree
    got = _port_triple(cost, masks)
    assert got[0, 1] == 2 and got[1, 1] == N - 7
    assert np.all(np.isfinite(got))
    for row, mask in zip(got, masks):
        edges, count = cluster_mst_edge_costs(jnp.asarray(cost), jnp.asarray(mask))
        np.testing.assert_allclose(row, [float(edges.sum()), int(count), float(edges.max())],
                                   rtol=RTOL)
    np.testing.assert_allclose(got[0], _scipy_triple(cost, np.isin(np.arange(N), [0, 2, 4])),
                               rtol=RTOL)


def test_equal_costs_and_empty_batch():
    """Ties between edges give the same totals; an empty batch gives (0, 3)."""
    cost = np.ones((N, N), np.float32) - np.eye(N, dtype=np.float32)
    masks = _masks(3, [5, 9])
    np.testing.assert_array_equal(_port_triple(cost, masks), [[4, 4, 1], [8, 8, 1]])
    assert _port_triple(cost, np.zeros((0, N), bool)).shape == (0, 3)
