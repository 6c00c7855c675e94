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

The object-axis split (``parallel/mesh.py``) takes the same kernel in two
more entry points, because the likelihood of a cell depends on every
observation of it and so does not split over objects while its counts do:
``loglh_counts`` counts one block of objects (the block's constants and
state), and ``loglh_from_counts`` turns the counts summed over the blocks
into the likelihood, from the same terms in the same fixed point as the
fused kernel, so it equals ``log_likelihood`` bit for bit on any split.
Each has its plain version beside it (``compute_feature_counts``, and the
Dirichlet-categorical log-pdf of ``log_likelihood_plain``).
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.model.math import compute_feature_counts, dirichlet_categorical_logpdf
from sbayes_tpu_torch.ops import _cuda


launches = _cuda.LaunchCounter("loglh")
counts_launches = _cuda.LaunchCounter("loglh_counts")
from_counts_launches = _cuda.LaunchCounter("loglh_from_counts")


def log_likelihood_plain(consts, clusters, source):
    """(B,) collapsed log-likelihood: counts (over the model's feature tiles),
    then the Dirichlet-categorical log-pdf summed over cluster and
    confounder-group rows."""
    return loglh_from_counts_plain(consts, *loglh_counts_plain(consts, clusters, source))


def loglh_counts_plain(consts, clusters, source):
    """Plain version of ``loglh_counts``: ``compute_feature_counts``."""
    return compute_feature_counts(clusters, source, consts.features, consts.groups,
                                  consts.feature_chunk)


def loglh_from_counts_plain(consts, cl, conf):
    """Plain version of ``loglh_from_counts``: the Dirichlet-categorical
    log-pdf of the counts, summed over cluster and confounder-group rows."""
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
    packed = _check_source(consts, clusters, source)
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


def _check_source(consts, clusters, source):
    B, K, N = clusters.shape
    packed = source.dtype == torch.int8
    want = (B, N, consts.F) if packed else (B, N, consts.F, consts.C)
    if source.shape != want:
        raise ValueError(f"source shape {tuple(source.shape)} != {want}")
    if clusters.dtype != torch.bool or source.dtype not in (torch.bool, torch.int8):
        raise TypeError("clusters must be bool, the source bool or packed int8")
    if not (clusters.device == source.device == consts.feat_idx_t.device):
        raise ValueError("clusters, source and the model constants must share one CUDA device")
    return packed


def loglh_counts(consts, clusters, source):
    """The counts of the objects of ``consts`` (one object block's constants,
    or the whole model's): clusters (B, K, N) bool and source (B, N, F, C)
    bool or packed (B, N, F) int8 of those objects -> cluster counts (B, K,
    F, S) and confounder counts (B, C-1, G, F, S), integer-valued float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``sbt_loglh_counts``)."""
    if not clusters.is_cuda:
        return loglh_counts_plain(consts, clusters, source)
    packed = _check_source(consts, clusters, source)
    B, K, N = clusters.shape
    F, S, C, G = consts.F, consts.S, consts.C, consts.Gmax
    dev = clusters.device
    cl = torch.empty((B, K, F, S), dtype=torch.float32, device=dev)
    conf = torch.empty((B, C - 1, G, F, S), dtype=torch.float32, device=dev)
    clusters, source = clusters.contiguous(), source.contiguous()
    stream = _cuda.stream_of(cl)
    with torch.cuda.device(dev):
        rc = _cuda.library().sbt_loglh_counts(
            clusters.data_ptr(), source.data_ptr(), consts.feat_idx_t.data_ptr(),
            consts.group_idx.data_ptr(), cl.data_ptr(),
            conf.data_ptr() if conf.numel() else None,
            B, K, N, F, S, C, G, int(packed), stream)
    _cuda.check(rc, "loglh_counts")
    counts_launches.add("packed" if packed else "bool", (dev.index, stream))
    return cl, conf


def loglh_from_counts(consts, cl, conf):
    """(B,) likelihood from counts cl (B, K, F, S) and conf (B, C-1, G, F,
    S), float32 holding integers (the counts of all objects, e.g. summed
    over object blocks). CPU tensors take the plain version; CUDA tensors
    launch the kernel (``sbt_loglh_from_counts``), which equals the fused
    kernel's ``log_likelihood`` of the same objects bit for bit."""
    if not cl.is_cuda:
        return loglh_from_counts_plain(consts, cl, conf)
    B, K = cl.shape[:2]
    F, S, C, G = consts.F, consts.S, consts.C, consts.Gmax
    if tuple(cl.shape) != (B, K, F, S) or tuple(conf.shape) != (B, C - 1, G, F, S):
        raise ValueError(f"count shapes {tuple(cl.shape)}, {tuple(conf.shape)} do not match "
                         f"the model")
    if cl.dtype != torch.float32 or conf.dtype != torch.float32:
        raise TypeError("counts must be float32")
    if not (cl.device == conf.device == consts.conc_table.device):
        raise ValueError("counts and the model constants must share one CUDA device")
    dev = cl.device
    cl, conf = cl.contiguous(), conf.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=dev)
    sums = torch.empty(B, dtype=torch.int64, device=dev)
    stream = _cuda.stream_of(out)
    with torch.cuda.device(dev):
        rc = _cuda.library().sbt_loglh_from_counts(
            cl.data_ptr(), conf.data_ptr() if conf.numel() else None,
            consts.conc_table.data_ptr(), out.data_ptr(), sums.data_ptr(),
            B, K, F, S, C, G, stream)
    _cuda.check(rc, "loglh_from_counts")
    from_counts_launches.add(None, (dev.index, stream))
    return out


def counts_bytes_moved(consts, B: int, packed: bool = False) -> int:
    """Bytes ``loglh_counts`` must move for the N objects of ``consts``: the
    memberships, the source of the observed cells (C bytes, or 1 packed),
    the feature index and the groups read once; the counts written once."""
    N, F, S, C, K = consts.N, consts.F, consts.S, consts.C, consts.K
    observed = int((consts.feat_idx_t < S).sum())
    rows = K + (C - 1) * consts.Gmax
    return (B * (K * N + observed * (1 if packed else C) + 4 * rows * F * S)
            + N * F + 4 * (C - 1) * N)


def counts_operations(consts, B: int, packed: bool = False) -> int:
    """Operations of ``loglh_counts``, a lower bound: one per source byte read
    and one per count written."""
    rows = consts.K + (consts.C - 1) * consts.Gmax
    per_cell = 1 if packed else consts.C
    return B * (consts.N * consts.F * per_cell + rows * consts.F * consts.S)


def from_counts_bytes_moved(consts, B: int) -> int:
    """Bytes ``loglh_from_counts`` must move: the counts read once, the
    concentration table of the real groups read once, the output written."""
    F, S, C, K = consts.F, consts.S, consts.C, consts.K
    rows = K + (C - 1) * consts.Gmax
    n_groups = sum(int(n) for n in consts.n_groups)
    return B * (4 * rows * F * S + 4) + 4 * (1 + n_groups) * F * (S + 1)


def from_counts_operations(cl, conf) -> int:
    """Operations of ``loglh_from_counts`` on these counts (they depend on
    the data): two logs for each unit of count (the cell's term and its
    row's), each log counted as one operation, and one read a cell."""
    return int(2 * (cl.sum() + conf.sum()).item()) + cl.numel() + conf.numel()


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
