"""The kernels against their plain versions on a chain batch's own inputs,
and the launch counts of this process.

``chip_smoke.py`` holds every kernel against its plain version with these
functions, in its own process and, through the process split
(``parallel/processes.py``), inside a shard's worker process, whose launch
counts only the worker can read (``launch_counts``). Beside the kernels'
launch counters ``COUNTERS`` holds ``model/math.py::tile_passes``, the
feature tiles walked, and ``ops/marginal.py::staged_bytes``, the bytes the
marginal stages into shared memory, which a CUDA graph's replay counts as
its launches.
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.model.math import tile_passes
from sbayes_tpu_torch.ops import draw, loglh, marginal, mst

LOGLH_TOL_REL = 1e-5             # lgammaf vs torch.lgamma, summation order (of the total)
MARGINAL_TOL_ABS = 1e-4          # 36 logs summed in another order (per object)
MARGINAL_TOL_FEATURES = 36       # wider data: the tolerance grows with the logs summed
MST_TOL_REL = 1e-5               # the total: float32 edges added in another order


# The launch counter of every kernel entry (``_cuda.LaunchCounter``), the
# count of feature tiles walked and the marginal's staged bytes.
COUNTERS = (loglh.launches, loglh.counts_launches, loglh.from_counts_launches,
            marginal.launches, mst.launches, draw.launches, tile_passes,
            marginal.staged_bytes)


def launch_counts() -> dict:
    """The launches of every kernel entry counted in this process: per
    counter its total, by variant and by place (``_cuda.LaunchCounter``)."""
    return {c.name: {"count": c.count, "variants": dict(c.variants),
                     "by_place": {p: dict(v) for p, v in c.by_place.items()}}
            for c in COUNTERS}


def reset_launches():
    for c in COUNTERS:
        c.reset()


def path_kernel_inputs(rt, states) -> dict:
    """The inputs both kernels get on the main path, from the chains' own
    state: memberships and sources, and the effects, weights and
    availabilities the Gibbsish operators hand to the marginal."""
    from sbayes_tpu_torch.model.math import normalize
    from sbayes_tpu_torch.sampling.conditionals import _pick_cluster

    c = rt.consts
    B = states.n_chains
    dev = states.clusters.device
    hc = rt.post.has_components(states.clusters)
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    i_cluster = torch.zeros(B, dtype=torch.long, device=dev)
    p_eff = normalize(_pick_cluster(states.cl_counts, i_cluster) + c.conc_cluster[None])
    return {"clusters": states.clusters, "source": states.source, "p_eff": p_eff,
            "p_other": normalize(torch.roll(p_eff, 1, dims=0) + 0.1),
            "conf_eff": normalize(states.conf_counts + c.conc_conf[None]),
            "wh": states.weights.contiguous(), "hc": hc.float(), "hc_flip": hc_flip.float(),
            "incl": hc[..., 0].float(), "inv_t": torch.full((B,), 1.0 / 1.3, device=dev)}


def jump_kernel_inputs(cond, states) -> dict:
    """The inputs the jump operator gives both kernels, from the chains' own
    state: the effects of clusters 0 (source) and 1 (target) as the two
    effect rows, ``hc_flip = hc`` and ``incl = 1``."""
    from sbayes_tpu_torch.model.math import normalize

    c = cond.consts
    B = states.n_chains
    hc = cond.post.has_components(states.clusters).float()
    effects = normalize(states.cl_counts[:, :2] + c.conc_cluster[None, None])
    return {"clusters": states.clusters, "source": states.source, "p_eff": effects[:, 0],
            "p_other": effects[:, 1],
            "conf_eff": normalize(states.conf_counts + c.conc_conf[None]),
            "wh": states.weights.contiguous(), "hc": hc, "hc_flip": hc,
            "incl": torch.ones((B, c.N), device=hc.device),
            "inv_t": torch.full((B,), 1.0 / 1.3, device=hc.device)}


def mc3_kernel_inputs(rt, states, temps, prior_temps=None) -> dict:
    """The inputs the wide operator gives the heat variant under per-chain
    likelihood temperatures ``temps`` and prior temperatures
    ``prior_temps`` (None: ``temps``), from the chains' own state: the
    heated effect of cluster 0 (counts over T, concentration over Tp), the
    weights to the power 1/Tp and ``inv_t = 1/T`` per chain."""
    from sbayes_tpu_torch.model.math import conditional_effect_mean, normalize, per_chain

    c = rt.consts
    if prior_temps is None:
        prior_temps = temps
    hc = rt.post.has_components(states.clusters)
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    p_eff = conditional_effect_mean(c.conc_cluster[None], states.cl_counts[:, 0],
                                    c.unif_conc[None], prior_temps, temps)
    inv_t = 1.0 / temps
    inv_tp = 1.0 / prior_temps
    return {"clusters": states.clusters, "source": states.source, "p_eff": p_eff,
            "p_other": normalize(torch.roll(p_eff, 1, dims=0) + 0.1),
            "conf_eff": normalize(states.conf_counts + c.conc_conf[None]),
            "wh": (states.weights ** per_chain(inv_tp, states.weights)).contiguous(),
            "hc": hc.float(), "hc_flip": hc_flip.float(), "incl": hc[..., 0].float(),
            "inv_t": inv_t}


def marginal_variant_args(inputs: dict, ratio: bool, heat: bool, two_eff: bool) -> tuple:
    """Positional arguments after ``consts`` and the keywords of
    ``marginal`` / ``marginal_plain`` for one variant."""
    rows = (inputs["p_eff"][:, None] if (ratio and not two_eff)
            else torch.stack([inputs["p_eff"], inputs["p_other"]], 1)).contiguous()
    args = (rows, inputs["conf_eff"], inputs["wh"], inputs["hc"], inputs["hc_flip"],
            inputs["incl"], inputs["inv_t"] if heat else None)
    return args, dict(ratio=ratio, two_eff=two_eff)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare_with_plain(c, inputs: dict) -> dict:
    """Both kernels and every marginal variant against their plain versions
    on ``inputs``; the likelihood on both source forms (the packed kernel
    bit-equal to the bool one: the same terms in fixed point); under an MST
    geo prior the Prim kernel on the clusters (``mst_vs_plain``); raises
    beyond a tolerance, returns the largest errors."""
    from sbayes_tpu_torch.model.math import pack_source, source_is_packed, source_onehot
    from sbayes_tpu_torch.model.posterior import skeleton_of

    src = inputs["source"]
    forms = {"packed": src if source_is_packed(src) else pack_source(src),
             "bool": source_onehot(src, c.C)}
    got = {k: loglh.log_likelihood(c, inputs["clusters"], v) for k, v in forms.items()}
    want = loglh.log_likelihood_plain(c, inputs["clusters"], src)
    again = [loglh.log_likelihood(c, inputs["clusters"], forms["packed"]) for _ in range(4)]
    _synchronize(src.device)
    if not all(torch.equal(got["packed"], other) for other in again + [got["bool"]]):
        raise AssertionError("loglh kernel: launches on the same inputs (either source form) "
                             "differ in bits")
    got = got["bool"]
    errs = {"loglh_abs": float((got - want).abs().max()),
            "loglh_rel": float(((got - want).abs() / want.abs()).max()),
            "loglh_packed_equals_bool": True}
    if not errs["loglh_rel"] <= LOGLH_TOL_REL:
        raise AssertionError(f"loglh kernel vs plain (N, F, S = {c.N, c.F, c.S}): relative "
                             f"error {errs['loglh_rel']} > {LOGLH_TOL_REL}")
    for variant in marginal.VARIANTS:
        args, kw = marginal_variant_args(inputs, *variant)
        got = marginal.marginal(c, *args, **kw)
        want = marginal.marginal_plain(c, *args, **kw)
        _synchronize(src.device)
        name = marginal.variant_name(*variant)
        errs[name] = float((got - want).abs().max())
        tol = MARGINAL_TOL_ABS * max(1.0, c.F / MARGINAL_TOL_FEATURES)
        if not errs[name] <= tol:
            raise AssertionError(f"{name} kernel vs plain (N, F, S = {c.N, c.F, c.S}): "
                                 f"{errs[name]} > {tol}")
    if c.geo.prior_type != "uniform" and skeleton_of(c.geo) == "mst":
        errs.update(mst_vs_plain(c.cost_matrix, inputs["clusters"]))
    return errs


def mst_vs_plain(cost, clusters) -> dict:
    """The Prim kernel's two entries against ``_prim`` on the (B, K, N)
    ``clusters``: every cluster's triple, and the update of rows 0 and 1 of
    each chain (the jump's form) in a copy of those triples. Edge counts and
    longest edges exactly, totals within ``MST_TOL_REL``; the rows the update
    does not touch bit-equal to its input. Raises, else returns the largest
    relative error of a total."""
    B, K, N = clusters.shape
    want = mst._prim(cost, clusters.reshape(B * K, N)).view(B, K, 3)
    got = mst.cluster_mst_stats(cost, clusters.reshape(B * K, N)).view(B, K, 3)
    rows = tuple(torch.full((B,), k, dtype=torch.long, device=clusters.device)
                 for k in range(min(K, 2)))
    updated = mst.update_mst_stats(cost, want, clusters, rows)
    _synchronize(clusters.device)
    if not torch.equal(updated[:, len(rows):], want[:, len(rows):]):
        raise AssertionError("mst update: a row it does not recompute changed")
    errs = {}
    for name, out in (("stats", got), ("update", updated)):
        if not (torch.equal(out[..., 1], want[..., 1]) and torch.equal(out[..., 2], want[..., 2])):
            raise AssertionError(f"mst kernel ({name}) vs _prim (N = {N}): edge counts or "
                                 f"longest edges differ")
        rel = ((out[..., 0] - want[..., 0]).abs() / want[..., 0].abs().clamp(min=1e-30)).max()
        errs[f"mst_{name}_rel"] = float(rel)
        if not errs[f"mst_{name}_rel"] <= MST_TOL_REL:
            raise AssertionError(f"mst kernel ({name}) vs _prim (N = {N}): relative error "
                                 f"of a total {errs[f'mst_{name}_rel']} > {MST_TOL_REL}")
    return errs


def shard_vs_plain(rt, states, inputs: str = "path", temps=None) -> dict:
    """``compare_with_plain`` on a runtime's chains ``states``, on the inputs
    the Gibbsish operators (``path``), the jump (``jump``) or the wide
    operator at the per-chain temperatures ``temps`` (``mc3``) give the
    kernels: the call a shard's worker makes (``on_shard``)."""
    if inputs == "path":
        made = path_kernel_inputs(rt, states)
    elif inputs == "jump":
        made = jump_kernel_inputs(rt.cond, states)
    else:
        made = mc3_kernel_inputs(rt, states, temps)
    return compare_with_plain(rt.consts, made)
