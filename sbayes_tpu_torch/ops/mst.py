"""Minimum-spanning-tree statistics of clusters: a batched, masked Prim.

Port of ``sbayes_tpu/ops/mst.py::cluster_mst_stats_prim``. The geo prior
aggregates the edge costs of the MST over a cluster's members in the dense
(N, N) cost matrix; it consumes only the triple [total, n_edges, max_edge].
Plain PyTorch (the JAX package computes it outside any Pallas kernel), over
a batch of masks at once: every Prim iteration is one min-reduction, one
row gather ``cost[j]`` and three (M, N) elementwise ops (five launches).

The loop runs to the largest cluster of the batch; smaller clusters are
finished earlier and add nothing more (their candidate set is empty).
Reading that size is the one host-device sync of a call (the span
``sbt.sync/mst.size``, inside the call's ``sbt.prim``). Every
per-iteration tensor is (M, N); the edges are kept as (M, n_iter).

The row gather is the form the JAX package switches to above 2,048 objects
(``cluster_mst_edge_costs``, the gather-form Prim, where its one-hot matmul
form would re-read the whole cost matrix every iteration); at and below that
size it equals ``cluster_mst_stats_prim``. The port has one form for all N.
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.tracing import span


def cluster_mst_stats(cost: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(M, 3) [total, n_edges, max_edge] of the MST over each masked subgraph.

    cost: (N, N) symmetric cost matrix; mask: (M, N) bool memberships.
    A cluster of size <= 1 gives (0, 0, 0). Members that no finite edge
    reaches (an infinite cut) stop the tree: no further edge is added."""
    with span("sbt.prim"):
        return _prim(cost, mask)


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
