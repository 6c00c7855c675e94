"""Kernel 1: the collapsed likelihood of a batch of chains.

Replaces the TPU kernel ``sbayes_tpu/ops/pallas_kernels.py::_loglh_kernel``
(the ``pl.pallas_call`` in ``make_pallas_log_likelihood.log_lh_batch``).
For CUDA tensors ``log_likelihood`` launches ``csrc/loglh.cu``; for CPU
tensors it runs ``log_likelihood_plain`` (sufficient-statistic counts, then
``dirichlet_categorical_logpdf``), the plain PyTorch version of the same
function. There is no other switch.

Bound on an H100: memory. The kernel reads each chain's source and
memberships once (the shared feature index and concentrations stay in L2),
see ``bytes_moved``.
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.model.math import compute_feature_counts, dirichlet_categorical_logpdf
from sbayes_tpu_torch.ops import _cuda


launches = _cuda.LaunchCounter("loglh")


def log_likelihood_plain(consts, clusters, source):
    """(B,) collapsed log-likelihood: counts, then the Dirichlet-categorical
    log-pdf summed over cluster and confounder-group rows."""
    cl, conf = compute_feature_counts(clusters, source, consts.features, consts.groups)
    lh_cl = dirichlet_categorical_logpdf(cl, consts.conc_cluster[None, None]).sum((-1, -2))
    lh_conf = dirichlet_categorical_logpdf(conf, consts.conc_conf[None]).sum((-1, -2, -3))
    return lh_cl + lh_conf


def log_likelihood(consts, clusters, source):
    """clusters (B, K, N) bool, source (B, N, F, C) bool -> (B,) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not clusters.is_cuda:
        return log_likelihood_plain(consts, clusters, source)
    return log_likelihood_cuda(consts, clusters, source)


def log_likelihood_cuda(consts, clusters, source):
    """Launch ``csrc/loglh.cu`` on the current stream."""
    B, K, N = clusters.shape
    F, S, C, G = consts.F, consts.S, consts.C, consts.Gmax
    if source.shape != (B, N, F, C):
        raise ValueError(f"source shape {tuple(source.shape)} != {(B, N, F, C)}")
    if clusters.dtype != torch.bool or source.dtype != torch.bool:
        raise TypeError("clusters and source must be bool tensors")
    if not (clusters.device == source.device == consts.feat_idx.device):
        raise ValueError("clusters, source and the model constants must share one CUDA device")
    clusters = clusters.contiguous()
    source = source.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=clusters.device)
    lib = _cuda.library()
    rc = lib.sbt_loglh(
        clusters.data_ptr(), source.data_ptr(), consts.feat_idx.data_ptr(),
        consts.group_idx.data_ptr(), consts.conc_cluster.data_ptr(),
        consts.conc_conf.data_ptr(), out.data_ptr(),
        B, K, N, F, S, C, G, _cuda.stream_of(out))
    _cuda.check(rc, "loglh")
    launches.add()
    return out


def bytes_moved(consts, B: int) -> int:
    """Bytes the function must move: each input cell it needs read once, the
    output written once. The source of NA cells and the concentrations of
    the padding groups up to Gmax are never needed."""
    N, F, S, C, K = consts.N, consts.F, consts.S, consts.C, consts.K
    observed = int((consts.feat_idx < S).sum())
    per_chain = K * N + observed * C + 4
    n_groups = sum(int(n) for n in consts.n_groups)
    shared = N * F + 4 * (C - 1) * N + 4 * F * S + 4 * n_groups * F * S
    return B * per_chain + shared
