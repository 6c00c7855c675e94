"""Tensor math of the collapsed mixture model, batched over chains.

Port of the subset of ``sbayes_tpu/model/math.py`` that the default
sampling path uses. Chain-state tensors carry an explicit leading chain
axis ``B`` (the JAX package vmaps a per-chain function instead); model
constants are shared and unbatched.

Row gathers and scatters take an index of ``N`` to mean "padding": a gather
returns an all-zero row there and a scatter drops the write, which is what
XLA does for out-of-bounds indices and what torch would raise on. Both work
on a flattened (B*N, row) view with one spare row, so neither needs a
data-dependent shape (and thus no host-device sync).
"""
from __future__ import annotations

import torch

TINY = 1e-35


def normalize(x, dim=-1):
    """Normalize so the given axis sums to 1."""
    return x / x.sum(dim=dim, keepdim=True)


def dirichlet_categorical_logpdf(counts, a):
    """Collapsed Dirichlet-categorical log-likelihood per feature, without
    the multinomial coefficient; states with ``a <= 0`` are excluded.

    counts, a: (..., F, S) -> (..., F)."""
    n = counts.sum(-1)
    sum_a = a.sum(-1)
    const = torch.lgamma(sum_a) - torch.lgamma(n + sum_a)
    series = torch.where(a > 0, torch.lgamma(counts + a) - torch.lgamma(a),
                         torch.zeros_like(counts)).sum(-1)
    return const + series


def dirichlet_categorical_delta(counts, a, d):
    """Exact change of ``dirichlet_categorical_logpdf(counts + d, a).sum()``
    for unit count moves (at most one observation moving per feature),
    from logs of the touched entries only: lgamma(c+1) - lgamma(c) = log c.

    counts, a, d: (..., F, S) -> (...,)."""
    zero = torch.zeros_like(counts)
    series = (
        torch.where(d > 0, torch.log(torch.clamp(counts + a, min=TINY)), zero)
        - torch.where(d < 0, torch.log(torch.clamp(counts + a - 1, min=TINY)), zero)
    ).sum((-1, -2))
    n = counts.sum(-1)
    sum_a = a.sum(-1)
    dn_f = d.sum(-1)
    zf = torch.zeros_like(n)
    const = (
        -torch.where(dn_f > 0, torch.log(torch.clamp(n + sum_a, min=TINY)), zf)
        + torch.where(dn_f < 0, torch.log(torch.clamp(n + sum_a - 1, min=TINY)), zf)
    ).sum(-1)
    return series + const


def dirichlet_logpdf(x, alpha, where=None):
    """Dirichlet log-density over the last axis (``where`` masks the
    applicable entries)."""
    if where is None:
        where = torch.ones_like(x, dtype=torch.bool)
    zero = torch.zeros_like(x)
    lognorm = (torch.where(where, torch.lgamma(alpha), zero).sum(-1)
               - torch.lgamma(torch.where(where, alpha, zero).sum(-1)))
    one = torch.ones_like(x)
    kernel = torch.where(where, (alpha - 1) * torch.log(torch.where(where, x, one)), zero).sum(-1)
    return kernel - lognorm


def compute_feature_counts(clusters, source, features, conf_groups):
    """Sufficient-statistic counts of every mixture component.

    clusters (B, K, N) bool; source (B, N, F, C) bool; features (N, F, S);
    conf_groups (C-1, Gmax, N). Returns cluster counts (B, K, F, S) and
    confounder counts (B, C-1, Gmax, F, S) — integer-valued f32, exact.
    """
    dtype = features.dtype
    fx0 = features[None] * source[..., 0, None].to(dtype)                 # (B, N, F, S)
    cl = torch.einsum("bkn,bnfs->bkfs", clusters.to(dtype), fx0)
    conf = [torch.einsum("gn,bnfs->bgfs", conf_groups[i_c],
                         features[None] * source[..., 1 + i_c, None].to(dtype))
            for i_c in range(conf_groups.shape[0])]
    if not conf:
        B, _, F, S = cl.shape
        return cl, cl.new_zeros((B, 0, conf_groups.shape[1], F, S))
    return cl, torch.stack(conf, dim=1)


def normalize_weights(weights, has_components):
    """Per-object renormalized weights: weights (B, F, C), has_components
    (B, m, C) -> (B, m, F, C)."""
    w = weights[:, None, :, :] * has_components[:, :, None, :].to(weights.dtype)
    return w / w.sum(-1, keepdim=True)


def conditional_effect_mean(prior_counts, feature_counts, unif_counts=None,
                            prior_temperature=None, temperature=None):
    """Posterior-mean categorical effect given counts, with the MC3 heating
    of prior and likelihood counts."""
    if prior_temperature is not None:
        prior_counts = unif_counts + (prior_counts - unif_counts) / prior_temperature
    if temperature is not None:
        feature_counts = feature_counts / temperature
    return normalize(feature_counts + prior_counts)


def sample_categorical_onehot(gen, p):
    """One-hot draws (bool, same shape) from unnormalized categorical
    probabilities ``p`` by inverse CDF, one uniform per cell. All-zero rows
    yield the last category (every caller masks them)."""
    c = p.shape[-1]
    cdf = torch.cumsum(p, dim=-1)
    u = torch.rand(p.shape[:-1], generator=gen, device=p.device, dtype=p.dtype) * cdf[..., -1]
    idx = torch.clamp((u[..., None] >= cdf).sum(-1), max=c - 1)
    return torch.nn.functional.one_hot(idx, c).bool()


def compact_indices(mask, size: int, fill: int):
    """Ascending indices of True per row of ``mask`` (B, n), padded with
    ``fill`` to ``size`` columns (also when ``size`` > n)."""
    B, n = mask.shape
    ar = torch.arange(n, device=mask.device)
    order = torch.argsort(torch.where(mask, ar, n + ar), dim=-1)
    if size > n:
        order = torch.cat([order, order.new_full((B, size - n), fill)], dim=-1)
    order = order[:, :size]
    m = mask.sum(-1, keepdim=True)
    return torch.where(torch.arange(size, device=mask.device) < m, order,
                       torch.full_like(order, fill))


def batch_take(x, idx):
    """``x[b, idx[b, j]]`` for a chain-batched ``x`` (B, n, ...) and per-chain
    indices ``idx`` (B, m) in [0, n)."""
    B, n = x.shape[:2]
    lin = (idx + n * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    return x.reshape(B * n, *x.shape[2:])[lin].reshape(*idx.shape, *x.shape[2:])


def gather_rows(src, idx):
    """``src[b, idx[b]]`` rows (B, m, ...) of a chain-batched ``src`` (B, N,
    ...); ``idx == N`` (padding) yields an all-zero row."""
    N = src.shape[1]
    valid = idx < N
    rows = batch_take(src, torch.clamp(idx, max=N - 1))
    shape = valid.shape + (1,) * (rows.dim() - 2)
    return rows & valid.view(shape) if rows.dtype == torch.bool else rows * valid.view(shape)


def scatter_rows(src, idx, rows):
    """A copy of ``src`` (B, N, ...) with ``rows`` (B, m, ...) written at the
    per-chain DISTINCT indices ``idx`` (B, m); ``idx == N`` drops the write."""
    B, N = src.shape[:2]
    tail = src.shape[2:]
    flat = torch.cat([src.reshape(B * N, *tail), src.new_zeros((1, *tail))])
    lin = torch.where(idx < N, idx + N * torch.arange(B, device=idx.device)[:, None],
                      torch.full_like(idx, B * N))
    flat[lin.reshape(-1)] = rows.reshape(-1, *tail).to(src.dtype)
    return flat[:B * N].view(src.shape)


def gather_cols(mat, idx):
    """``mat[b, ..., idx[b]]`` for a chain-batched ``mat`` (B, ..., N) and
    ``idx`` (B, m) -> (B, ..., m). Padding indices (N) are clamped; callers
    mask them."""
    idx = torch.clamp(idx, max=mat.shape[-1] - 1)
    shape = (idx.shape[0],) + (1,) * (mat.dim() - 2) + (idx.shape[1],)
    return torch.gather(mat, -1, idx.view(shape).expand(*mat.shape[:-1], idx.shape[1]))


def take_cols(mat, idx):
    """``mat[..., idx[b]]`` for a SHARED constant ``mat`` (..., N) and
    per-chain ``idx`` (B, m) -> (B, ..., m). Padding indices are clamped."""
    idx = torch.clamp(idx, max=mat.shape[-1] - 1)
    return torch.movedim(mat[..., idx], -2, 0)


def source_pick(p, source):
    """``(p * source).sum(-1)``: the probability each observation's chosen
    component picked (0 at NA cells)."""
    return (p * source).sum(-1)
