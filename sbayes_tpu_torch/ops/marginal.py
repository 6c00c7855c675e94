"""Kernel 2: the collapsed cluster-membership marginal of every object.

Replaces the TPU kernel ``sbayes_tpu/ops/pallas_marginal.py::_marginal_kernel``
(the ``pl.pallas_call`` in ``make_pallas_marginal.marginal``). For CUDA
tensors ``marginal`` launches ``csrc/marginal.cu``; for CPU tensors it runs
``marginal_plain``, the plain PyTorch version of the same function (the
closed-form mixture of ``OperatorFactory._marginal_impl``'s ``slice_body``
in the JAX package). There is no other switch.

Per chain b and object n, over features f with the mixture weights ``wh``
(already heated by 1/Tp) and availabilities ``hc`` / ``hc_flip`` (cluster
bit flipped):

    lh(n, f) = sum_c wh[f, c] hc[n, c] lh_c[n, f] / sum_c wh[f, c] hc[n, c]

with lh_0 the proposal cluster effect (row 0 under hc, row 1 under
hc_flip), lh_c the object's confounder-group effect and NA cells at 1.

Variants (the four the JAX operator factory builds, plus their
combinations): ``ratio`` returns the signed log-odds log m1 - log m0 (one
log per element), else both absolute log-marginals (B, N, 2) = [without,
with]; ``heat`` raises lh_0 to ``inv_t[b]``; ``two_eff`` takes two distinct
effect rows in the ratio form. The caller divides by the temperature.

Bound on an H100: memory (``bytes_moved``). With fewer chains than the
card has SMs the kernel's grid also splits the objects (``object_tile``).
The kernel takes the objects in the order of ``ObjectLayout`` (sorted by
their group in the confounder with the most groups, built once per
constants on the host), so that each block stages only the group rows its
own objects read; ``staged_bytes`` counts the effect-table bytes the
launches stage into shared memory.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import numpy as np
import torch

from sbayes_tpu_torch.ops import _cuda

TINY = 1e-35
# Dynamic shared memory of a feature tile: what a block gets without asking
# for more (csrc/marginal.cu: kSmemBudget), so that four blocks fit an SM.
SMEM_BUDGET = 47 * 1024

launches = _cuda.LaunchCounter("marginal")
# Bytes of the effect tables (the cluster-effect rows and the confounder
# rows of each block) the launches stage into shared memory, summed over
# their blocks and feature tiles; reckoned on the host from the layout, and
# in ``ops/check.py::COUNTERS``, so that a replayed graph counts its capture's.
staged_bytes = _cuda.LaunchCounter("marginal_staged_bytes")

# (ratio, heat, two_eff) of the four variants the JAX operator factory builds:
# Gibbsish / wide / ML step, wide at T != 1, log-space jump, EPS-flooring jump.
VARIANTS = ((True, False, False), (True, True, False), (True, False, True),
            (False, False, False))


def variant_name(ratio: bool, heat: bool, two_eff: bool) -> str:
    """Name of a variant in launch counts and measurements."""
    parts = ["marginal"] + (["heat"] if heat else []) + (["two_eff"] if two_eff else [])
    return "_".join(parts + ([] if ratio else ["abs"]))


def _n_rows(ratio: bool, two_eff: bool) -> int:
    return 1 if (ratio and not two_eff) else 2


def marginal_plain(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t=None,
                   ratio=True, two_eff=False):
    """Plain PyTorch version of the kernel (same arguments as ``marginal``)."""
    feats = consts.features                                   # (N, F, S) one-hot
    na = consts.na[None]                                      # (1, N, F)
    one = torch.ones((), device=feats.device)

    def cluster_lh(row):
        x = torch.einsum("bfs,nfs->bnf", p_eff[:, row], feats)
        if inv_t is not None:
            x = torch.clamp(x, min=TINY) ** inv_t[:, None, None]
        return torch.where(na, one, x)

    lh0a = cluster_lh(0)
    lh0b = cluster_lh(1) if _n_rows(ratio, two_eff) == 2 else lh0a
    lh_conf = [torch.where(na, one, torch.einsum("gn,bgfs,nfs->bnf", consts.groups[i_c],
                                                 conf_eff[:, i_c], feats))
               for i_c in range(consts.C - 1)]

    z_cur = torch.einsum("bnc,bfc->bnf", hc, wh)
    z_flip = torch.einsum("bnc,bfc->bnf", hc_flip, wh)

    def mix(h, lh0):
        s = wh[:, None, :, 0] * h[:, :, 0, None] * lh0
        for i_c, lh_c in enumerate(lh_conf, start=1):
            s = s + wh[:, None, :, i_c] * h[:, :, i_c, None] * lh_c
        return s

    s_cur, s_flip = mix(hc, lh0a), mix(hc_flip, lh0b)
    in_cluster = incl > 0.5
    if ratio:
        r = (s_cur / torch.clamp(s_flip, min=TINY)) * (z_flip / torch.clamp(z_cur, min=TINY))
        lr = torch.log(torch.clamp(r, min=TINY)).sum(-1)
        return torch.where(in_cluster, lr, -lr)
    lh_cur = s_cur / torch.clamp(z_cur, min=TINY)
    lh_flip = s_flip / torch.clamp(z_flip, min=TINY)
    inc = in_cluster[:, :, None]
    lh_with = torch.where(inc, lh_cur, lh_flip)
    lh_without = torch.where(inc, lh_flip, lh_cur)
    return torch.stack([torch.log(torch.clamp(lh_without, min=TINY)).sum(-1),
                        torch.log(torch.clamp(lh_with, min=TINY)).sum(-1)], dim=-1)


def marginal(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t=None,
             ratio=True, two_eff=False):
    """Membership marginals of a batch of chains.

    p_eff (B, E, F, S) cluster effects, E = 1 for the one-row ratio form
    else 2; conf_eff (B, C-1, G, F, S) confounder effects; wh (B, F, C)
    heated weights; hc, hc_flip (B, N, C) f32 availabilities; incl (B, N)
    f32 current membership; inv_t (B,) heating exponent or None.
    Returns (B, N) log-odds (ratio) or (B, N, 2) [log m0, log m1].

    CPU tensors take the plain version; CUDA tensors launch the kernel. In
    place of ``consts`` an ``ObjectSplit`` (a chain shard's object blocks)
    takes ``marginal_split``."""
    if hasattr(consts, "blocks"):
        return marginal_split(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t,
                              ratio, two_eff)
    if not p_eff.is_cuda:
        return marginal_plain(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t,
                              ratio, two_eff)
    return marginal_cuda(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t,
                         ratio, two_eff)


def marginal_split(split, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t=None, ratio=True,
                   two_eff=False):
    """``marginal`` of a chain shard whose objects are split
    (``parallel.mesh.ObjectSplit``): one launch per block, on the block's
    device and stream, with the block's ``hc`` / ``hc_flip`` / ``incl`` and
    the effects of the summed counts; the per-object results joined on
    the head (the kernel computes each object on its own, so a block's
    objects get what they get unsplit)."""
    def block(j):
        out = marginal(split.blocks[j], *split.to_block(j, (p_eff, conf_eff, wh)),
                       split.cols(j, hc, dim=1), split.cols(j, hc_flip, dim=1),
                       split.cols(j, incl, dim=1), split.to_block(j, inv_t), ratio, two_eff)
        return split.to_head(j, out)

    parts = split.run(block)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def object_tile(n_chains: int, n_objects: int, n_sm: int) -> int:
    """Objects per block of the kernel's (chain, object tile) grid: all of
    them (one block per chain) when the chains fill the card's ``n_sm``
    SMs, else tiles enough that chains x tiles is at least two blocks per
    SM."""
    if n_chains >= n_sm:
        return n_objects
    tiles = min(-(-2 * n_sm // n_chains), n_objects)
    return -(-n_objects // tiles)


def object_order(group_idx: np.ndarray, n_groups) -> np.ndarray:
    """(N,) int32: the objects stably sorted by their group in the
    confounder with the most groups (``group_idx`` (C-1, N), -1 = in no
    group; ``n_groups`` (C-1,)), those in none of its groups last."""
    n_objects = group_idx.shape[1]
    if len(group_idx) == 0:
        return np.arange(n_objects, dtype=np.int32)
    g = group_idx[int(np.argmax(n_groups))]
    key = np.where(g < 0, np.iinfo(np.int32).max, g)
    return np.argsort(key, kind="stable").astype(np.int32)


def tile_rows(sorted_groups: np.ndarray, obj_tile: int) -> tuple:
    """The confounder rows each block stages, for tiles of ``obj_tile`` of
    the sorted objects (``sorted_groups`` (C-1, N)): ``lo`` (tiles, C-1),
    the first group of each confounder that some object of the tile is in
    (0 where none is), and ``first_row`` (tiles, C), where each
    confounder's rows start among the block's, then the rows in all. A
    confounder's rows are the groups lo .. the last one its objects are in."""
    n_conf, n_objects = sorted_groups.shape
    n_tiles = -(-n_objects // obj_tile)
    g = np.full((n_conf, n_tiles * obj_tile), -1, dtype=np.int64)
    g[:, :n_objects] = sorted_groups
    g = g.reshape(n_conf, n_tiles, obj_tile)
    seen = g >= 0
    any_seen = seen.any(-1)
    lo = np.where(any_seen, np.where(seen, g, np.iinfo(np.int64).max).min(-1), 0)
    hi = np.where(seen, g, -1).max(-1)
    count = np.where(any_seen, hi - lo + 1, 0)
    first_row = np.zeros((n_tiles, n_conf + 1), dtype=np.int32)
    first_row[:, 1:] = np.cumsum(count.T, axis=1)
    return np.ascontiguousarray(lo.T, dtype=np.int32), first_row


def _host_only(device):
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the marginal's object layout is built on the host: launch the "
                           "kernel once on this batch before a CUDA graph captures it")


def feature_tile(F: int, S: int, C: int, rows: int, n_effect_rows: int) -> int:
    """Features per shared-memory tile of a block that stages ``rows``
    confounder rows: all of them when the tables fit ``SMEM_BUDGET``, else
    the largest multiple of 4 that does (every row of a tile then stays
    16-byte aligned in shared memory), at least 1. The sum is the kernel's
    ``tile_floats``: each table starts on 16 bytes."""
    def floats(ft):
        return sum(-(-x // 4) * 4 for x in (n_effect_rows * ft * S, rows * ft * S, ft * C))

    if floats(F) * 4 <= SMEM_BUDGET:
        return F
    ft = SMEM_BUDGET // 4 // ((n_effect_rows + rows) * S + C)
    while ft > 1 and floats(ft) * 4 > SMEM_BUDGET:
        ft -= 1
    if ft >= 4:
        ft &= ~3
    return max(ft, 1)


@dataclasses.dataclass(frozen=True)
class LaunchShape:
    """How the kernel walks a batch: objects per block (``obj_tile``), the
    most confounder rows a block stages (``rows``), features per
    shared-memory tile (``f_tile``), the effect-table bytes the launch
    stages (``staged_bytes``: per block and feature its E effect rows and
    its confounder rows, S floats each) and ``tile_rows`` on the device."""

    obj_tile: int
    rows: int
    f_tile: int
    staged_bytes: int
    lo: torch.Tensor          # (tiles, C-1) int32
    first_row: torch.Tensor   # (tiles, C) int32


class ObjectLayout:
    """The objects in the kernel's order (``object_order``): ``order`` (N,)
    int32, the state index ``feat_idx_t`` (F, N) and the group index
    ``group_idx`` (C-1, N) copied in that order, on the constants' device,
    and a ``LaunchShape`` for each batch size, built at its first launch.
    Built on the host, never inside a CUDA graph's capture: ``layout``
    keeps one for each constants object."""

    def __init__(self, consts):
        _host_only(consts.feat_idx_t.device)
        self.F, self.S, self.C = consts.F, consts.S, consts.C
        groups = consts.group_idx.cpu().numpy()
        order = object_order(groups, np.asarray(consts.n_groups))
        self.sorted_groups = np.ascontiguousarray(groups[:, order])
        device = consts.feat_idx_t.device
        self.order = torch.as_tensor(order, device=device)
        self.feat_idx_t = consts.feat_idx_t.index_select(1, self.order.long()).contiguous()
        self.group_idx = torch.as_tensor(self.sorted_groups, device=device)
        self._shapes: dict = {}

    def launch_shape(self, n_chains: int, n_sm: int, n_effect_rows: int) -> LaunchShape:
        key = (n_chains, n_sm, n_effect_rows)
        got = self._shapes.get(key)
        if got is None:
            _host_only(self.order.device)
            tile = object_tile(n_chains, self.order.shape[0], n_sm)
            lo, first_row = tile_rows(self.sorted_groups, tile)
            rows = first_row[:, -1].astype(np.int64)
            dev = self.order.device
            got = self._shapes[key] = LaunchShape(
                tile, int(rows.max()),
                feature_tile(self.F, self.S, self.C, int(rows.max()), n_effect_rows),
                4 * n_chains * self.F * self.S * int(n_effect_rows * len(rows) + rows.sum()),
                torch.as_tensor(lo, device=dev), torch.as_tensor(first_row, device=dev))
        return got


_layouts: dict = {}
_layouts_lock = threading.Lock()


def layout(consts) -> ObjectLayout:
    """The ``ObjectLayout`` of ``consts``, built at the first call for this
    constants object and kept while it lives (an ``ObjectSplit`` block's
    constants have their own)."""
    key = id(consts)
    with _layouts_lock:
        got = _layouts.get(key)
        if got is None:
            got = _layouts[key] = ObjectLayout(consts)
            weakref.finalize(consts, _layouts.pop, key, None)
    return got


def launch_shape(consts, n_chains: int, n_sm: int, ratio=True, two_eff=False) -> LaunchShape:
    """How the kernel walks a batch of ``n_chains`` chains of ``consts`` on
    a card of ``n_sm`` SMs (``LaunchShape``)."""
    return layout(consts).launch_shape(n_chains, n_sm, _n_rows(ratio, two_eff))


def marginal_cuda(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t=None,
                  ratio=True, two_eff=False):
    """Launch ``csrc/marginal.cu`` on the current stream."""
    B = p_eff.shape[0]
    N, F, S, C, G = consts.N, consts.F, consts.S, consts.C, consts.Gmax
    E = _n_rows(ratio, two_eff)
    expect = {"p_eff": (p_eff, (B, E, F, S)), "conf_eff": (conf_eff, (B, C - 1, G, F, S)),
              "wh": (wh, (B, F, C)), "hc": (hc, (B, N, C)), "hc_flip": (hc_flip, (B, N, C)),
              "incl": (incl, (B, N))}
    if inv_t is not None:
        expect["inv_t"] = (inv_t, (B,))
    args = {}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32 or t.device != consts.feat_idx.device:
            raise TypeError(f"{name} must be a float32 tensor on the constants' CUDA device")
        args[name] = t.contiguous()
    out = torch.empty((B, N) if ratio else (B, N, 2), dtype=torch.float32, device=p_eff.device)
    lay = layout(consts)
    shape = lay.launch_shape(B, _cuda.sm_count(out.device), E)
    # The launch and its shared-memory attribute go to the tensors' device,
    # whichever device is the calling thread's current one.
    stream = _cuda.stream_of(out)
    with torch.cuda.device(out.device):
        rc = _cuda.library().sbt_marginal(
            lay.feat_idx_t.data_ptr(), lay.group_idx.data_ptr(), lay.order.data_ptr(),
            shape.lo.data_ptr(), shape.first_row.data_ptr(),
            args["p_eff"].data_ptr(), args["conf_eff"].data_ptr(), args["wh"].data_ptr(),
            args["hc"].data_ptr(), args["hc_flip"].data_ptr(), args["incl"].data_ptr(),
            args["inv_t"].data_ptr() if inv_t is not None else None, out.data_ptr(),
            B, N, F, S, C, G, int(ratio), int(inv_t is not None), int(two_eff),
            shape.obj_tile, shape.f_tile, shape.rows, stream)
    _cuda.check(rc, "marginal")
    place = (out.device.index, stream)
    launches.add((bool(ratio), inv_t is not None, bool(two_eff)), place)
    staged_bytes.add(None, place, shape.staged_bytes)
    return out


def effect_cells_read(consts) -> tuple:
    """(p_eff cells, conf_eff cells) per chain and effect row that the data
    make the function read: the (f, s) pairs some object shows, and the
    (group, f, s) cells some member of the group shows. Padding groups up
    to Gmax and states that no object shows are never read."""
    N, F, S = consts.N, consts.F, consts.S
    fi = consts.feat_idx.long()
    obs = fi < S
    f_ar = torch.arange(F, device=fi.device)[None]
    p_cells = torch.unique((f_ar * S + fi)[obs]).numel()
    conf_cells = 0
    for gi in consts.group_idx.long():
        ok = obs & (gi[:, None] >= 0)
        conf_cells += torch.unique(((gi[:, None] * F + f_ar) * S + fi)[ok]).numel()
    return p_cells, conf_cells


def bytes_moved(consts, B: int, ratio=True, two_eff=False, heat=False) -> int:
    """Bytes the function must move: each input cell it needs read once, the
    output written once. Of the effect tables only the cells of
    ``effect_cells_read``; hc, hc_flip and incl are inputs of their own (the
    jump passes hc_flip = hc and incl = 1)."""
    N, F, C = consts.N, consts.F, consts.C
    p_cells, conf_cells = effect_cells_read(consts)
    per_chain = 4 * (_n_rows(ratio, two_eff) * p_cells + conf_cells + F * C + 2 * N * C + N
                     + (1 if heat else 0) + N * (1 if ratio else 2))
    return B * per_chain + N * F + 4 * (C - 1) * N


def operations(consts, B: int, ratio=True, two_eff=False, heat=False) -> int:
    """f32 operations per call (adds, multiplies, divides, logs; exp/log of heat)."""
    N, F, C = consts.N, consts.F, consts.C
    per_elem = 8 * C + (6 if ratio else 8) + (4 if heat else 0) * _n_rows(ratio, two_eff)
    return B * N * F * per_elem
