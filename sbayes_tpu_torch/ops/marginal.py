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

Bound on an H100: memory (``bytes_moved``).
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.ops import _cuda

TINY = 1e-35

launches = _cuda.LaunchCounter("marginal")

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

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not p_eff.is_cuda:
        return marginal_plain(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t,
                              ratio, two_eff)
    return marginal_cuda(consts, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t,
                         ratio, two_eff)


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
    rc = _cuda.library().sbt_marginal(
        consts.feat_idx.data_ptr(), consts.group_idx.data_ptr(),
        args["p_eff"].data_ptr(), args["conf_eff"].data_ptr(), args["wh"].data_ptr(),
        args["hc"].data_ptr(), args["hc_flip"].data_ptr(), args["incl"].data_ptr(),
        args["inv_t"].data_ptr() if inv_t is not None else None, out.data_ptr(),
        B, N, F, S, C, G, int(ratio), int(inv_t is not None), int(two_eff),
        _cuda.stream_of(out))
    _cuda.check(rc, "marginal")
    launches.add((bool(ratio), inv_t is not None, bool(two_eff)))
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
