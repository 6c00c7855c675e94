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

The source (the component of every observation) comes in two forms, as in
the JAX package: the bool one-hot (B, N, F, C), all zero at NA cells, and
the packed int8 (B, N, F) component index with the sentinel C for "NA / no
component" (``ModelConstants.source_packed``: a third of the bytes at C = 3,
chosen at scale). The ``source_*`` helpers, ``gather_rows``,
``scatter_rows`` and ``compute_feature_counts`` take either; operators
compute with one-hot ROWS in both. ``feature_tiles`` cuts the feature axis
into the tiles of ``ModelConstants.feature_chunk``, over which the
full-width (B, N, F, ...) computations run at scale; ``tile_passes``
counts the tiles they walk. A source split over
object blocks (``parallel/mesh.py::SplitSource``) does the work of
``gather_rows`` and ``scatter_rows`` itself.
"""
from __future__ import annotations

import functools
import operator

import torch

from sbayes_tpu_torch.ops import _cuda, draw

TINY = 1e-35

# One count for each feature tile a tiled computation walks (none untiled),
# kept like the kernels' launch counters (``ops/check.py::COUNTERS``): a
# CUDA graph's replay counts the passes of its capture.
tile_passes = _cuda.LaunchCounter("tile_passes")


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


def feature_tiles(n_features: int, f_chunk=None) -> list:
    """Slices of the feature axis: tiles of ``f_chunk`` features (the last
    one shorter when ``f_chunk`` does not divide F), or one slice of all of
    them when ``f_chunk`` is None or not below F. A tiled walk counts its
    tiles in ``tile_passes``."""
    if f_chunk is None or f_chunk >= n_features:
        return [slice(0, n_features)]
    tiles = [slice(f0, min(f0 + f_chunk, n_features)) for f0 in range(0, n_features, f_chunk)]
    tile_passes.add(n=len(tiles))
    return tiles


def add_tiles(parts):
    """The sum of per-tile results in tile order (one tile: itself, bit for bit)."""
    return functools.reduce(operator.add, parts)


def cat_tiles(parts, dim: int):
    """Per-tile results joined along the feature axis ``dim``."""
    return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]


def source_is_packed(src) -> bool:
    """True for the packed int8 (..., N, F) index form."""
    return src.dtype == torch.int8


def source_comp(src, i: int, dtype=None):
    """The component-membership mask ``source[..., i]`` of either form, as
    ``dtype`` (bool when None)."""
    m = (src == i) if source_is_packed(src) else src[..., i]
    return m if dtype is None else m.to(dtype)


def source_onehot(src, n_components: int):
    """The bool one-hot (..., F, C) form (the identity on it); the sentinel
    C gives an all-zero row."""
    if not source_is_packed(src):
        return src
    return src[..., None] == torch.arange(n_components, dtype=src.dtype, device=src.device)


def pack_source(src_bool):
    """Bool one-hot (..., F, C) -> packed int8 (..., F); all-zero rows (NA)
    map to the sentinel C."""
    c = src_bool.shape[-1]
    idx = src_bool.to(torch.uint8).argmax(-1)
    return torch.where(src_bool.any(-1), idx, c).to(torch.int8)


def source_n_changed(a, b):
    """(B,) the source step-size statistic of the JAX package: the bit flips
    of the bool one-hot form, two per reassigned cell (the NA mask is the
    data's, so a cell is one-hot in both states or empty in both)."""
    dims = tuple(range(1, a.dim()))
    if source_is_packed(a):
        return 2.0 * (a != b).sum(dims).float()
    return (a ^ b).sum(dims).float()


def compute_feature_counts(clusters, source, features, conf_groups, f_chunk=None):
    """Sufficient-statistic counts of every mixture component.

    clusters (B, K, N) bool; source (B, N, F, C) bool or packed (B, N, F)
    int8; features (N, F, S); conf_groups (C-1, Gmax, N); with ``f_chunk``
    the features are walked in tiles of that many (tile-sized (B, N, f, S)
    intermediates, the same counts). Returns cluster counts (B, K, F, S)
    and confounder counts (B, C-1, Gmax, F, S) — integer-valued f32, exact.
    """
    dtype = features.dtype
    n_conf = conf_groups.shape[0]
    cl_tiles, conf_tiles = [], []
    for sl in feature_tiles(features.shape[1], f_chunk):
        feats = features[None, :, sl]
        src = source[:, :, sl]
        cl_tiles.append(torch.einsum("bkn,bnfs->bkfs", clusters.to(dtype),
                                     feats * source_comp(src, 0, dtype)[..., None]))
        conf_tiles.append([torch.einsum("gn,bnfs->bgfs", conf_groups[i_c],
                                        feats * source_comp(src, 1 + i_c, dtype)[..., None])
                           for i_c in range(n_conf)])
    cl = cat_tiles(cl_tiles, dim=2)
    if not n_conf:
        B, _, F, S = cl.shape
        return cl, cl.new_zeros((B, 0, conf_groups.shape[1], F, S))
    return cl, cat_tiles([torch.stack(t, dim=1) for t in conf_tiles], dim=3)


def normalize_weights(weights, has_components):
    """Per-object renormalized weights: weights (B, F, C), has_components
    (B, m, C) -> (B, m, F, C)."""
    w = weights[:, None, :, :] * has_components[:, :, None, :].to(weights.dtype)
    return w / w.sum(-1, keepdim=True)


def per_chain(t, x):
    """A temperature (or its inverse) ``t`` shaped to broadcast against the
    chain-batched ``x`` (B, ...): a (B,) tensor is viewed as (B, 1, ...), a
    Python float (unit temperatures, plain ensembles) passes unchanged."""
    if isinstance(t, torch.Tensor):
        return t.view(-1, *([1] * (x.dim() - 1)))
    return t


def conditional_effect_mean(prior_counts, feature_counts, unif_counts=None,
                            prior_temperature=None, temperature=None):
    """Posterior-mean categorical effect given counts (B, ...), with the MC3
    heating of prior and likelihood counts (floats or (B,) tensors)."""
    if prior_temperature is not None:
        prior_counts = (unif_counts + (prior_counts - unif_counts)
                        / per_chain(prior_temperature, feature_counts))
    if temperature is not None:
        feature_counts = feature_counts / per_chain(temperature, feature_counts)
    return normalize(feature_counts + prior_counts)


def sample_categorical_onehot(gen, p):
    """One-hot draws (bool, same shape) from unnormalized categorical
    probabilities ``p`` by inverse CDF, one uniform per cell. All-zero rows
    yield the last category (every caller masks them). The inverse CDF is
    ``ops/draw.py``'s: the kernel on CUDA tensors, its plain version on CPU
    ones."""
    u = torch.rand(p.shape[:-1], generator=gen, device=p.device, dtype=p.dtype)
    return draw.onehot(p, u)


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


def gather_rows(src, idx, n_components=None):
    """``src[b, idx[b]]`` rows (B, m, ...) of a chain-batched ``src`` (B, N,
    ...); ``idx == N`` (padding) yields an all-zero row. A packed source
    (B, N, F) gives its rows in the one-hot bool form (B, m, F, C), C =
    ``n_components`` (which it needs); padding gives the sentinel's all-zero
    row."""
    if not isinstance(src, torch.Tensor):
        return src.gather_rows(idx, n_components)
    N = src.shape[1]
    valid = idx < N
    rows = batch_take(src, torch.clamp(idx, max=N - 1))
    if source_is_packed(src):
        if n_components is None:
            raise ValueError("gather_rows of a packed source needs n_components")
        return source_onehot(torch.where(valid[..., None], rows, n_components), n_components)
    shape = valid.shape + (1,) * (rows.dim() - 2)
    return rows & valid.view(shape) if rows.dtype == torch.bool else rows * valid.view(shape)


def scatter_rows(src, idx, rows):
    """A copy of ``src`` (B, N, ...) with ``rows`` (B, m, ...) written at the
    per-chain DISTINCT indices ``idx`` (B, m); ``idx == N`` drops the write.
    A packed source (B, N, F) takes one-hot bool rows (B, m, F, C) and packs
    them."""
    if not isinstance(src, torch.Tensor):
        return src.scatter_rows(idx, rows)
    if source_is_packed(src) and rows.dim() == src.dim() + 1:
        rows = pack_source(rows)
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
    """``(p * source_onehot).sum(-1)``: the probability each observation's
    chosen component picked from ``p`` (..., N, F, C); 0 at NA cells. Either
    source form: a packed index is compared with each component on the fly
    (the sentinel matches none), which picks the same floats."""
    if source_is_packed(source):
        source = source_onehot(source, p.shape[-1])
    return (p * source).sum(-1)
