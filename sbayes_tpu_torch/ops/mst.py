"""Minimum-spanning-tree statistics of clusters: a batched, masked Prim.

Port of ``sbayes_tpu/ops/mst.py::cluster_mst_stats_prim``. The geo prior
aggregates the edge costs of the MST over a cluster's members in the dense
(N, N) cost matrix; it consumes only the triple [total, n_edges, max_edge].

For CUDA tensors ``cluster_mst_stats`` and ``update_mst_stats`` launch
``csrc/mst.cu`` (each mask's loop inside the kernel, to its own size: one
launch, no sync); for CPU tensors they run ``_prim``, the plain version.
There is no other switch. The JAX package computes its Prim in plain JAX,
outside any Pallas kernel, so the kernel replaces none: it removes the
host loop below and its sync.

``_prim`` runs over a batch of masks at once: every iteration is one
min-reduction, one row gather ``cost[j]`` and three (M, N) elementwise ops
(five launches). The loop runs to the largest cluster of the batch; smaller
clusters are finished earlier and add nothing more (their candidate set is
empty). Reading that size is the one host-device sync of a call (the span
``sbt.sync/mst.size``, inside the call's ``sbt.prim``). Every per-iteration
tensor is (M, N); the edges are kept as (M, n_iter).

The row gather is the form the JAX package switches to above 2,048 objects
(``cluster_mst_edge_costs``, the gather-form Prim, where its one-hot matmul
form would re-read the whole cost matrix every iteration); at and below that
size it equals ``cluster_mst_stats_prim``. The port has one form for all N.
"""
from __future__ import annotations

import functools

import torch

from sbayes_tpu_torch.ops import _cuda
from sbayes_tpu_torch.tracing import span

launches = _cuda.LaunchCounter("mst")

# The most objects the kernel takes (csrc/mst.cu: kMaxVpl * kBlockWarps * kWarp).
MAX_OBJECTS = 32 * 32 * 32


def cluster_mst_stats(cost: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(M, 3) [total, n_edges, max_edge] of the MST over each masked subgraph.

    cost: (N, N) symmetric cost matrix; mask: (M, N) bool memberships.
    A cluster of size <= 1 gives (0, 0, 0). Members that no finite edge
    reaches (an infinite cut) stop the tree: no further edge is added.
    CPU tensors take ``_prim``; CUDA tensors launch the kernel."""
    with span("sbt.prim"):
        if not mask.is_cuda:
            return _prim(cost, mask)
        check_launch_args(cost, mask[:, None])
        out = torch.empty((mask.shape[0], 3), dtype=torch.float32, device=mask.device)
        if mask.shape[0]:
            _launch(cost, mask, out)
        return out


def update_mst_stats(cost: torch.Tensor, agg: torch.Tensor, clusters: torch.Tensor,
                     changed) -> torch.Tensor:
    """A copy of the (B, K, 3) triples ``agg`` of ``clusters`` (B, K, N) in
    which row ``[b, i[b]]`` of each (B,) index ``i`` in ``changed`` (one or
    two of them) is recomputed from ``clusters``. CPU tensors take
    ``update_rows`` with ``_prim``; CUDA tensors launch the kernel once (it
    also copies the other rows)."""
    if not clusters.is_cuda:
        return update_rows(agg, clusters, changed, functools.partial(cluster_mst_stats, cost))
    with span("sbt.prim"):
        check_launch_args(cost, clusters, agg, changed)
        out = torch.empty(agg.shape, dtype=torch.float32, device=agg.device)
        _launch(cost, clusters, out, agg, changed)
        return out


def update_rows(agg, clusters, changed, triples_of):
    """A copy of ``agg`` with row ``[b, i[b]]`` of each ``i`` in ``changed``
    set to ``triples_of`` of that cluster's mask (one call for all)."""
    ar = torch.arange(clusters.shape[0], device=clusters.device)
    triples = triples_of(torch.cat([clusters[ar, i] for i in changed])).view(len(changed), -1, 3)
    agg = agg.clone()
    for i, triple in zip(changed, triples):
        agg[ar, i] = triple
    return agg


def check_launch_args(cost, clusters, agg=None, changed=()):
    """Raise on what the kernel does not take: cost (N, N) float32, clusters
    (B, K, N) bool, agg (B, K, 3) float32 and one or two (B,) int64 indices,
    all on one device, N at most ``MAX_OBJECTS``."""
    N = clusters.shape[-1]
    if tuple(cost.shape) != (N, N) or clusters.dim() != 3:
        raise ValueError(f"cost {tuple(cost.shape)} and masks {tuple(clusters.shape)}: "
                         f"expected (N, N) and (B, K, N)")
    if N > MAX_OBJECTS:
        raise ValueError(f"the Prim kernel takes at most {MAX_OBJECTS} objects, not {N}")
    B, K = clusters.shape[:2]
    expect = [("cost", cost, torch.float32), ("masks", clusters, torch.bool)]
    if agg is not None:
        if not 1 <= len(changed) <= 2:
            raise ValueError(f"one or two changed clusters, not {len(changed)}")
        if tuple(agg.shape) != (B, K, 3):
            raise ValueError(f"agg shape {tuple(agg.shape)} != {(B, K, 3)}")
        for i in changed:
            if tuple(i.shape) != (B,):
                raise ValueError(f"changed-cluster index shape {tuple(i.shape)} != {(B,)}")
        expect += [("agg", agg, torch.float32)] + [("index", i, torch.int64) for i in changed]
    for name, t, dtype in expect:
        if t.dtype != dtype or t.device != clusters.device:
            raise TypeError(f"{name} must be a {dtype} tensor on {clusters.device}, "
                            f"not {t.dtype} on {t.device}")


def _launch(cost, masks, out, agg=None, changed=()):
    """Launch ``csrc/mst.cu`` on the current stream of the tensors' device:
    every mask of ``masks`` (..., N), or (``agg`` given) the update form."""
    cost, masks = cost.contiguous(), masks.contiguous()
    agg = None if agg is None else agg.contiguous()
    idx = [i.contiguous() for i in changed] + [None] * (2 - len(changed))
    N = masks.shape[-1]
    K = masks.shape[1] if agg is not None else 1
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = _cuda.stream_of(out)
    with torch.cuda.device(out.device):
        rc = _cuda.library().sbt_mst(cost.data_ptr(), masks.data_ptr(), ptr(idx[0]),
                                     ptr(idx[1]), ptr(agg), out.data_ptr(), masks.numel() // N,
                                     K, N, stream)
    _cuda.check(rc, "mst")
    launches.add("update" if agg is not None else "stats", (out.device.index, stream))


def _prim(cost: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    M, N = mask.shape
    dev = mask.device
    n_iter = 0
    if M > 0:
        largest = mask.sum(-1).max()
        with span("sbt.sync/mst.size"):
            n_iter = int(largest) - 1
    if n_iter <= 0:
        return torch.zeros((M, 3), dtype=cost.dtype, device=dev)

    # ``blocked`` is +inf at every object that is no candidate (not a member,
    # or in the tree already) and 0 at the candidates: added after each
    # relaxation it keeps the distances of the blocked objects at +inf.
    zero = torch.zeros((), dtype=cost.dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=cost.dtype, device=dev)
    start = mask.to(torch.uint8).argmax(-1, keepdim=True)          # a member (any will do)
    blocked = torch.where(mask, zero, inf).scatter_(1, start, float("inf"))
    d = cost[start[:, 0]] + blocked
    edges = []
    for _ in range(n_iter):                    # five launches per iteration
        w, j = d.min(-1, keepdim=True)
        edges.append(w)
        blocked.scatter_(1, j, float("inf"))
        d = torch.minimum(d, cost[j[:, 0]]).add_(blocked)
    edges = torch.cat(edges, dim=1)                                # (M, n_iter)
    # The first infinite minimum ends a tree (complete, or cut off): what the
    # loop relaxed after it does not count.
    added = (~torch.isfinite(edges)).cumsum(-1) == 0
    e = torch.where(added, edges, zero)
    return torch.stack([e.sum(-1), added.sum(-1).to(cost.dtype), e.max(-1).values.clamp(min=0)],
                       dim=-1)
