"""The port's batched masked Prim (``sbayes_tpu_torch/ops/mst.py``) against
scipy's minimum spanning tree and against the JAX package's
``cluster_mst_stats_prim`` on the same numpy inputs: the triple
[total, n_edges, max_edge] of every cluster of a batch. Then the wrapper of
the Prim kernel (``csrc/mst.cu``): on the CPU its contract (CPU tensors take
the plain ``_prim``, what the kernel does not take raises), and, marked
``gpu``, the kernel against ``_prim`` on the card:
``python -m pytest -m gpu tests/test_torch_mst.py``. JAX is imported only
inside the tests that compare with it: the card's machine has none.

Tolerance: 1e-5 relative (float32 sums of at most N - 1 edge costs, added in
another order); the edge count and the longest edge are exact."""
import re
from pathlib import Path

import numpy as np
import pytest
from scipy.sparse.csgraph import minimum_spanning_tree

import torch

from sbayes_tpu_torch.ops import mst
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
    import jax
    import jax.numpy as jnp

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
    import jax.numpy as jnp

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


# ---------------------------------------------------------------------------
# The kernel's wrapper: its contract on the CPU.

def _plain_update(cost, agg, clusters, changed):
    """What ``_update_geo`` computed before the kernel: the changed masks
    through ``_prim`` in one call, written into a copy of ``agg``."""
    ar = torch.arange(clusters.shape[0], device=clusters.device)
    triples = mst._prim(cost, torch.cat([clusters[ar, i] for i in changed]))
    out = agg.clone()
    for i, triple in zip(changed, triples.view(len(changed), -1, 3)):
        out[ar, i] = triple
    return out


def _clusters(seed, B, K, n, max_size, device="cpu"):
    """(B, K, n) disjoint clusters of random sizes 0..max_size."""
    rng = np.random.default_rng(seed)
    clusters = np.zeros((B, K, n), bool)
    for b in range(B):
        perm = rng.permutation(n)
        sizes = rng.integers(0, max_size + 1, size=K)
        start = 0
        for k, size in enumerate(sizes):
            clusters[b, k, perm[start:start + size]] = True
            start += size
    return torch.as_tensor(clusters, device=device)


@pytest.mark.parametrize("n_changed", [1, 2])
def test_cpu_tensors_take_the_plain_prim(n_changed):
    """On CPU tensors both entries run ``_prim`` and launch nothing: the
    triples are ``_prim``'s bits, the update is the former ``_update_geo``'s
    bits and leaves the unchanged rows bit-equal to its input."""
    cost = torch.as_tensor(_cost(3))
    clusters = _clusters(3, 16, 3, N, 5)
    agg = torch.randn(16, 3, 3)
    gen = torch.Generator().manual_seed(n_changed)
    changed = tuple(torch.randint(0, 3, (16,), generator=gen) for _ in range(n_changed))
    mst.launches.reset()
    masks = clusters.reshape(-1, N)
    assert torch.equal(cluster_mst_stats(cost, masks), mst._prim(cost, masks))
    got = mst.update_mst_stats(cost, agg, clusters, changed)
    assert torch.equal(got, _plain_update(cost, agg, clusters, changed))
    hit = torch.zeros(16, 3, dtype=torch.bool)
    for i in changed:
        hit[torch.arange(16), i] = True
    assert torch.equal(got[~hit], agg[~hit])
    assert mst.launches.count == 0


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


GOOD = dict(cost=((N, N), torch.float32), clusters=((4, 3, N), torch.bool),
            agg=((4, 3, 3), torch.float32), i0=((4,), torch.int64), i1=((4,), torch.int64))
BAD = {
    "cost_f64": (TypeError, dict(cost=((N, N), torch.float64))),
    "masks_uint8": (TypeError, dict(clusters=((4, 3, N), torch.uint8))),
    "agg_f64": (TypeError, dict(agg=((4, 3, 3), torch.float64))),
    "index_int32": (TypeError, dict(i1=((4,), torch.int32))),
    "cost_shape": (ValueError, dict(cost=((N, N + 1), torch.float32))),
    "masks_2d": (ValueError, dict(clusters=((12, N), torch.bool))),
    "agg_shape": (ValueError, dict(agg=((4, 2, 3), torch.float32))),
    "index_shape": (ValueError, dict(i0=((4, 1), torch.int64))),
    "too_many_objects": (ValueError, dict(cost=((mst.MAX_OBJECTS + 1,) * 2, torch.float32),
                                          clusters=((4, 3, mst.MAX_OBJECTS + 1), torch.bool))),
}


@pytest.mark.parametrize("case", list(BAD))
def test_launch_args_the_kernel_does_not_take_raise(case):
    """The checks made before every launch, on tensors of the meta device
    (shapes and types, no data): a wrong type, shape or size raises."""
    error, change = BAD[case]
    t = {k: _meta(*v) for k, v in {**GOOD, **change}.items()}
    mst.check_launch_args(**{k: _meta(*v) for k, v in {"cost": GOOD["cost"],
                                                       "clusters": GOOD["clusters"]}.items()})
    with pytest.raises(error):
        mst.check_launch_args(t["cost"], t["clusters"], t["agg"], (t["i0"], t["i1"]))


def test_three_changed_clusters_raise():
    t = {k: _meta(*v) for k, v in GOOD.items()}
    mst.check_launch_args(t["cost"], t["clusters"], t["agg"], (t["i0"], t["i1"]))
    with pytest.raises(ValueError):
        mst.check_launch_args(t["cost"], t["clusters"], t["agg"], (t["i0"], t["i1"], t["i0"]))


def test_max_objects_is_the_kernels():
    """``MAX_OBJECTS`` mirrors the kernel source's limit (values per thread
    x warps per mask x 32), so the check refuses what the launch would."""
    src = (Path(mst.__file__).parent.parent / "csrc" / "mst.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert mst.MAX_OBJECTS == const["kMaxVpl"] * const["kBlockWarps"] * const["kWarp"]


# ---------------------------------------------------------------------------
# The kernel on the card.

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_masks(n, rows, seed):
    """(rows, n) masks cycling through the sizes 0, 1, 2, 3, 7, 50 and n."""
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 2, 3, 7, 50, n]
    masks = np.zeros((rows, n), bool)
    for r in range(rows):
        masks[r, rng.choice(n, size=sizes[r % len(sizes)], replace=False)] = True
    return masks


def _assert_triples(got, want):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got[:, 1], want[:, 1])                 # edge counts exactly
    assert torch.equal(got[:, 2], want[:, 2])                 # longest edge exactly
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [100, 2100], ids=["warp", "block"])
def test_kernel_against_prim_on_the_card(n):
    """2,048 masks of sizes 0, 1, 2, 3, 7, 50 and n at N = 100 (one warp
    a mask) and N = 2,100 (one block a mask), one of them across an
    infinite cut: the kernel's triples against ``_prim``'s, one launch."""
    dev = _card()
    cost = _cost(n, n)
    cost[: n // 3, n // 3:] = np.inf
    cost[n // 3:, : n // 3] = np.inf
    masks = _card_masks(n, 2048, n)
    masks[5, :] = False
    masks[5, [0, 1, 2, n // 3, n // 3 + 1]] = True           # starts left of the cut
    cost_d, masks_d = torch.as_tensor(cost, device=dev), torch.as_tensor(masks, device=dev)
    mst.launches.reset()
    got = cluster_mst_stats(cost_d, masks_d)
    torch.cuda.synchronize()
    assert mst.launches.count == 1
    want = mst._prim(cost_d, masks_d)
    _assert_triples(got, want)
    assert got[5, 1] == 2 and torch.isfinite(got).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n_changed", [1, 2])
def test_update_geo_on_the_card(n_changed):
    """The carried aggregates' update of ``_update_geo`` under the MST
    (``update_mst_stats``) at 1024 chains, K = 3, N = 100, with one changed
    cluster (a Gibbsish or wide step) and two (the jump): the changed rows
    as the plain update gives them, every other row bit-equal to the input,
    one launch."""
    dev = _card()
    cost = torch.as_tensor(_cost(11, 100), device=dev)
    clusters = _clusters(11, 1024, 3, 100, 33, device=dev)
    agg = torch.randn(1024, 3, 3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(n_changed)
    changed = tuple(torch.randint(0, 3, (1024,), generator=gen, device=dev)
                    for _ in range(n_changed))
    mst.launches.reset()
    got = mst.update_mst_stats(cost, agg, clusters, changed)
    torch.cuda.synchronize()
    assert mst.launches.count == 1
    want = _plain_update(cost, agg, clusters, changed)
    hit = torch.zeros(1024, 3, dtype=torch.bool, device=dev)
    for i in changed:
        hit[torch.arange(1024, device=dev), i] = True
    assert torch.equal(got[~hit], agg[~hit])
    _assert_triples(got[hit], want[hit])


@pytest.mark.gpu
def test_kernel_entries_do_not_sync_on_the_card():
    """Neither ``cluster_mst_stats`` nor ``update_mst_stats`` waits for the
    card: both run under ``torch.cuda.set_sync_debug_mode("error")``."""
    dev = _card()
    cost = torch.as_tensor(_cost(4, 100), device=dev)
    clusters = _clusters(4, 64, 3, 100, 33, device=dev)
    agg = torch.zeros(64, 3, 3, device=dev)
    changed = (torch.zeros(64, dtype=torch.long, device=dev),
               torch.ones(64, dtype=torch.long, device=dev))
    mst.cluster_mst_stats(cost, clusters.reshape(-1, 100))           # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stats = mst.cluster_mst_stats(cost, clusters.reshape(-1, 100))
        updated = mst.update_mst_stats(cost, agg, clusters, changed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(updated[:, :2], stats.view(64, 3, 3)[:, :2])


@pytest.mark.gpu
def test_wrong_arguments_raise_on_the_card():
    """A CUDA call with a wrong type or shape raises before any launch."""
    dev = _card()
    cost = torch.as_tensor(_cost(2, 100), device=dev)
    masks = torch.as_tensor(_card_masks(100, 8, 2), device=dev)
    mst.launches.reset()
    with pytest.raises(TypeError):
        cluster_mst_stats(cost.double(), masks)
    with pytest.raises(TypeError):
        cluster_mst_stats(cost, masks.to(torch.uint8))
    with pytest.raises(ValueError):
        cluster_mst_stats(cost[:, :99], masks)
    with pytest.raises(ValueError):
        mst.update_mst_stats(cost, torch.zeros(8, 2, 3, device=dev), masks.view(4, 2, 100),
                             (torch.zeros(8, dtype=torch.long, device=dev),))
    assert mst.launches.count == 0


def test_check_holds_the_prim_entries_against_prim():
    """``ops.check.mst_vs_plain``, which holds the kernel against ``_prim``
    on the card, on CPU tensors: both entries are ``_prim`` there, so every
    error is 0 and the rows the update leaves alone stay as they were."""
    from sbayes_tpu_torch.ops.check import mst_vs_plain

    errs = mst_vs_plain(torch.as_tensor(_cost(9)), _clusters(9, 8, 3, N, 4))
    assert errs == {"mst_stats_rel": 0.0, "mst_update_rel": 0.0}
