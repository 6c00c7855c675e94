"""Kernel 1: the collapsed likelihood of a batch of chains.

Replaces the TPU kernel ``sbayes_tpu/ops/pallas_kernels.py::_loglh_kernel``
(the ``pl.pallas_call`` in ``make_pallas_log_likelihood.log_lh_batch``).
For CUDA tensors ``log_likelihood`` launches ``csrc/loglh.cu``; for CPU
tensors it runs ``log_likelihood_plain`` (sufficient-statistic counts, then
``dirichlet_categorical_logpdf``), the plain PyTorch version of the same
function. There is no other switch.

The kernel calls no lgamma: over integer counts both lgamma differences
telescope into sums of logs (``log_rising``), one term per observation, and
the model-only inputs come in one table (``ModelConstants.conc_table``).

Bound on an H100: memory. The kernel reads each chain's source and
memberships once (the shared feature index and concentration tables stay in
L2), see ``bytes_moved`` and ``operations``. The source is either form of the
chain state: bool one-hot (B, N, F, C) or packed int8 (B, N, F) (one byte a
cell, the sentinel C counting nothing); both give the same result.
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.model.math import compute_feature_counts, dirichlet_categorical_logpdf
from sbayes_tpu_torch.ops import _cuda


launches = _cuda.LaunchCounter("loglh")


def log_likelihood_plain(consts, clusters, source):
    """(B,) collapsed log-likelihood: counts (over the model's feature tiles),
    then the Dirichlet-categorical log-pdf summed over cluster and
    confounder-group rows."""
    cl, conf = compute_feature_counts(clusters, source, consts.features, consts.groups,
                                      consts.feature_chunk)
    lh_cl = dirichlet_categorical_logpdf(cl, consts.conc_cluster[None, None]).sum((-1, -2))
    lh_conf = dirichlet_categorical_logpdf(conf, consts.conc_conf[None]).sum((-1, -2, -3))
    return lh_cl + lh_conf


def log_rising(a, c):
    """``lgamma(a + c) - lgamma(a) = sum_{i<c} log(a + i)`` for integer counts
    ``c >= 0`` and ``a > 0``, as the kernel sums it: one log per unit of
    count, none for a count of 0 (exactly 0). Plain PyTorch, any
    broadcastable shapes."""
    a, c = torch.broadcast_tensors(a, c)
    acc = torch.zeros_like(a)
    for i in range(int(c.max()) if c.numel() else 0):
        acc = acc + torch.where(c > i, torch.log(a + i), torch.zeros_like(a))
    return acc


def log_likelihood(consts, clusters, source):
    """clusters (B, K, N) bool, source (B, N, F, C) bool or packed (B, N, F)
    int8 -> (B,) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not clusters.is_cuda:
        return log_likelihood_plain(consts, clusters, source)
    return log_likelihood_cuda(consts, clusters, source)


def log_likelihood_cuda(consts, clusters, source):
    """Launch ``csrc/loglh.cu`` on the current stream (the packed variant
    for an int8 source)."""
    B, K, N = clusters.shape
    F, S, C, G = consts.F, consts.S, consts.C, consts.Gmax
    packed = source.dtype == torch.int8
    want = (B, N, F) if packed else (B, N, F, C)
    if source.shape != want:
        raise ValueError(f"source shape {tuple(source.shape)} != {want}")
    if clusters.dtype != torch.bool or source.dtype not in (torch.bool, torch.int8):
        raise TypeError("clusters must be bool, the source bool or packed int8")
    if not (clusters.device == source.device == consts.feat_idx.device):
        raise ValueError("clusters, source and the model constants must share one CUDA device")
    clusters = clusters.contiguous()
    source = source.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=clusters.device)
    lib = _cuda.library()
    # One block per (chain, feature tile); the tiles' fixed-point sums meet
    # in ``partial``.
    tiles = -(-F // feature_tile(consts, packed))
    partial = (torch.empty((B, tiles), dtype=torch.int64, device=clusters.device)
               if tiles > 1 else None)
    # The launch and its shared-memory attribute go to the tensors' device,
    # whichever device is the calling thread's current one.
    stream = _cuda.stream_of(out)
    with torch.cuda.device(out.device):
        rc = lib.sbt_loglh(
            clusters.data_ptr(), source.data_ptr(), consts.feat_idx_t.data_ptr(),
            consts.group_idx.data_ptr(), consts.conc_table.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            B, K, N, F, S, C, G, int(packed), stream)
    _cuda.check(rc, "loglh")
    launches.add("packed" if packed else "bool", (out.device.index, stream))
    return out


def bytes_moved(consts, B: int, packed: bool = False) -> int:
    """Bytes the function must move: each input cell it needs read once, the
    output written once. The source of NA cells and the concentrations of
    the padding groups up to Gmax are never needed; an observed cell's
    source is C bytes, or 1 in the ``packed`` form. The shared table holds,
    for the cluster prior and each real group, a concentration per cell and
    their sum per feature."""
    N, F, S, C, K = consts.N, consts.F, consts.S, consts.C, consts.K
    observed = int((consts.feat_idx < S).sum())
    per_chain = K * N + observed * (1 if packed else C) + 4
    n_groups = sum(int(n) for n in consts.n_groups)
    shared = N * F + 4 * (C - 1) * N + 4 * (1 + n_groups) * F * (S + 1)
    return B * per_chain + shared


def operations(consts, B: int, packed: bool = False) -> int:
    """Operations per call, a lower bound: one add per source byte, and per
    (row, feature) 3 S + 4 adds and lgamma calls, each lgamma counted as one
    operation, whatever evaluates it."""
    rows = consts.K + (consts.C - 1) * consts.Gmax
    per_cell = 1 if packed else consts.C
    return B * (consts.N * consts.F * per_cell + rows * consts.F * (3 * consts.S + 4))


def feature_tile(consts, packed: bool = False) -> int:
    """Features per shared-memory tile of the kernel for this model (F = the
    kernel does not tile); asks the built library."""
    return _cuda.library().sbt_loglh_feature_tile(consts.K, consts.N, consts.F, consts.S,
                                                  consts.C, consts.Gmax, int(packed))
