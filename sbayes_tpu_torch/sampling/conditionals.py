"""Collapsed conditionals shared by the Gibbs-flavoured operators.

Port of the part of ``sbayes_tpu/sampling/conditionals.py`` that the
sampling paths use: per-component likelihoods (also the exact leave-self-out
form for likelihood logging), the source posterior, the expected confounder
features of the residual effect proposal, and the Gibbs source
resample in its two forms — a mask over all objects
(``gibbs_resample_source``, used by the initializer) and gathered rows, m
objects per chain (``gibbs_resample_source_rows`` for moves within a
cluster, ``gibbs_resample_source_jump_rows`` for the jump between two).
Everything is batched over chains: chain-state
tensors carry a leading axis B, ``i_cluster`` is a (B,) index, gathered
object indices are (B, m) with N meaning "padding". The temperatures are
Python floats (unit temperatures) or (B,) tensors, one per chain (MC3).

The source may be bool one-hot or packed int8 (the model's form); gathered
rows are one-hot in both. The full-width computations (component
likelihoods, the source posterior, the mask engine) take a feature slice
``sl`` and run over the model's feature tiles at scale, as the JAX package
tiles them (``_FeatureSlice``).

``ObjectSplitConditionals`` are the conditionals of a chain shard whose
objects are split over blocks (``parallel/mesh.py``): the gathered-rows
engine runs on the head from rows gathered from the blocks, and the
membership marginal on each block (``object_layout``). The full-width engines
(the mask engine, the source posterior of all objects, the leave-self-out
likelihoods of the logger) are not split: the grid samples with the
scheduled operators from states initialised unsplit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sbayes_tpu_torch.model.math import (
    add_tiles,
    cat_tiles,
    conditional_effect_mean,
    feature_tiles,
    gather_cols,
    gather_rows,
    normalize,
    normalize_weights,
    pack_source,
    per_chain,
    sample_categorical_onehot,
    source_comp,
    source_is_packed,
    source_pick,
    take_cols,
)
from sbayes_tpu_torch.model.posterior import Posterior

EPS32 = 1.1920929e-07  # float32 machine epsilon
TINY = 1e-35


ALL = slice(None)


class SourceResample(NamedTuple):
    source: torch.Tensor            # new source (mask engine) or the OLD one (rows), either form
    log_q: torch.Tensor             # (B,) forward log-probability
    log_q_back: torch.Tensor        # (B,) backward log-probability
    source_prior_delta: Optional[torch.Tensor] = None  # (B,) rows engine only
    new_rows: Optional[torch.Tensor] = None            # (B, m, F, C) rows engine only


def _chains(x):
    return torch.arange(x.shape[0], device=x.device)


def _pick_cluster(x, i_cluster):
    """``x[b, i_cluster[b]]`` for a chain-batched x (B, K, ...)."""
    return x[_chains(x), i_cluster]


def _temperature(t):
    """A Python float, or a (B,) float32 tensor of per-chain temperatures."""
    return t.float() if isinstance(t, torch.Tensor) else float(t)


class Conditionals:
    """Gibbs conditionals of a model at fixed temperatures: Python floats, or
    (B,) tensors on the model's device, one likelihood and one prior
    temperature per chain. ``inv_T`` / ``inv_Tp`` are their inverses."""

    def __init__(self, posterior: Posterior, temperature=1.0, prior_temperature=1.0):
        self.post = posterior
        self.consts = posterior.consts
        self.T = _temperature(temperature)
        self.Tp = _temperature(prior_temperature)
        self.inv_T = 1.0 / self.T
        self.inv_Tp = 1.0 / self.Tp
        self.sample_from_prior = posterior.sample_from_prior

    def load_temperatures(self, temperature, prior_temperature):
        """Copy the (B,) per-chain temperatures into this object's own
        tensors and their inverses beside them, in place, where a captured
        CUDA graph reads them (``sampling/graphs.py``); float temperatures
        stay as they are."""
        for name, t in (("T", temperature), ("Tp", prior_temperature)):
            mine = getattr(self, name)
            if isinstance(mine, torch.Tensor):
                mine.copy_(t)
                getattr(self, "inv_" + name).copy_(1.0 / mine)

    @property
    def object_layout(self):
        """What ``ops.marginal.marginal`` takes for its objects: the model
        constants, or on a grid row the ``ObjectSplit``."""
        return self.consts

    def heat_lh(self, x):
        """``x ** (1/T)`` per chain."""
        return x ** per_chain(self.inv_T, x)

    def heat_prior(self, x):
        """``x ** (1/Tp)`` per chain."""
        return x ** per_chain(self.inv_Tp, x)

    # ------------------------------------------------------------------
    # Component likelihoods
    # ------------------------------------------------------------------

    def likelihood_per_component(self, clusters, cl_counts, conf_counts, sl=ALL):
        """(B, N, f, C) likelihood of each observation of the features ``sl``
        under each component from the posterior-mean effects (the counts
        cover all F); NA observations get 1."""
        c = self.consts
        feats = c.features[:, sl]
        cl_eff = normalize(cl_counts[:, :, sl] + c.conc_cluster[None, None, sl])
        lh0 = torch.einsum("bkn,bkfs,nfs->bnf", clusters.float(), cl_eff, feats)
        conf_eff = normalize(conf_counts[:, :, :, sl] + c.conc_conf[None, :, :, sl])
        lhc = torch.einsum("cgn,bcgfs,nfs->bnfc", c.groups, conf_eff, feats)
        lh = torch.cat([lh0[..., None], lhc], dim=-1)
        return torch.where(c.na[None, :, sl, None], torch.ones((), device=lh.device), lh)

    def likelihood_per_component_exact(self, clusters, source):
        """(B, N, F, C) leave-self-out component likelihoods: each
        observation is scored under effects estimated without its own
        contribution (for the likelihood logger); over the model's feature
        tiles."""
        c = self.consts
        cl_counts, conf_counts = self.post.feature_counts(clusters, source)
        member = clusters.any(dim=1)                                      # (B, N)
        zero = torch.zeros((), device=c.features.device)

        def tile(sl):
            feats = c.features[:, sl]
            src = source[:, :, sl]
            own0 = feats[None] * source_comp(src, 0, torch.float32)[..., None]   # (B, N, f, S)
            per_obj_cl = (torch.einsum("bkn,bkfs->bnfs", clusters.float(),
                                       cl_counts[:, :, sl] + c.conc_cluster[None, None, sl])
                          - member[:, :, None, None] * own0)
            eff0 = per_obj_cl / torch.clamp(per_obj_cl.sum(-1, keepdim=True), min=EPS32)
            lh0 = torch.where(member[:, :, None], (eff0 * feats[None]).sum(-1), zero)
            lhs = [lh0[..., None]]
            base_conf = conf_counts[:, :, :, sl] + c.conc_conf[None, :, :, sl]
            for i_c in range(c.C - 1):
                in_group = c.groups[i_c].sum(0) > 0                       # (N,)
                own = feats[None] * source_comp(src, 1 + i_c, torch.float32)[..., None]
                per_obj = (torch.einsum("gn,bgfs->bnfs", c.groups[i_c], base_conf[:, i_c])
                           - in_group[None, :, None, None] * own)
                eff = per_obj / torch.clamp(per_obj.sum(-1, keepdim=True), min=EPS32)
                lhs.append(torch.where(in_group[None, :, None], (eff * feats[None]).sum(-1),
                                       zero)[..., None])
            lh = torch.cat(lhs, dim=-1)
            return torch.where(c.na[None, :, sl, None], torch.ones((), device=lh.device), lh)

        return cat_tiles([tile(sl) for sl in feature_tiles(c.F, c.feature_chunk)], dim=2)

    def source_posterior(self, clusters, weights, source, counts=None, sl=ALL):
        """(B, N, f, C) posterior over the component of every observation of
        the features ``sl``."""
        if counts is None:
            counts = self.post.feature_counts(clusters, source)
        lh_pc = self.likelihood_per_component(clusters, *counts, sl=sl)
        w = normalize_weights(weights[:, sl], self.post.has_components(clusters))
        return normalize(self.heat_lh(lh_pc) * self.heat_prior(w))

    def expected_confounder_features(self, clusters, weights, conf_counts):
        """(B, N, F, S) expected feature values under the confounder mixture:
        heated posterior-mean confounder effects, weighted by each object's
        heated normalized confounder weights."""
        c = self.consts
        w = normalize_weights(weights, self.post.has_components(clusters))
        w_heated = normalize(self.heat_prior(w))
        p_conf = conditional_effect_mean(c.conc_conf[None], conf_counts,
                                         c.unif_conc[None, None, None], self.Tp, self.T)
        return torch.einsum("cgn,bcgfs,bnfc->bnfs", c.groups, p_conf, w_heated[..., 1:])

    # ------------------------------------------------------------------
    # Mask engine (all objects; subset given as a (B, N) mask)
    # ------------------------------------------------------------------

    def _conf_counts_of(self, source):
        """(B, C-1, Gmax, F, S) confounder counts of a source tensor."""
        return self.post.feature_counts(
            torch.zeros(source.shape[0], 0, source.shape[1], dtype=torch.bool,
                        device=source.device), source)[1]

    def _clgu(self, clusters, source, subset, i_cluster, conf_counts_full, sl=ALL):
        """(B, N, f, C) heated component likelihoods of the features ``sl``
        with the subset's own contribution removed from the effect estimates
        (the cluster effect counts members outside the subset; each
        confounder effect uses its full counts minus the subset's).
        ``source``: the features ``sl`` of the source, either form;
        ``conf_counts_full`` covers all F."""
        c = self.consts
        feats = c.features[:, sl]
        unif = c.unif_conc[sl]
        sub = subset.float()
        keep = _pick_cluster(clusters, i_cluster).float() * (1.0 - sub)   # (B, N)
        cl_keep = torch.einsum("bn,bnf,nfs->bfs", keep, source_comp(source, 0, torch.float32),
                               feats)
        cluster_effect = conditional_effect_mean(
            c.conc_cluster[None, sl], cl_keep, unif[None], self.Tp, self.T)
        lh0 = torch.einsum("bfs,nfs->bnf", cluster_effect, feats)
        changeable = torch.stack([
            torch.einsum("gn,bn,bnf,nfs->bgfs", c.groups[i_c], sub,
                         source_comp(source, 1 + i_c, torch.float32), feats)
            for i_c in range(c.C - 1)], dim=1)
        conf_effect = conditional_effect_mean(
            c.conc_conf[None, :, :, sl], conf_counts_full[:, :, :, sl] - changeable,
            unif[None, None, None], self.Tp, self.T)
        lhc = torch.einsum("cgn,bcgfs,nfs->bnfc", c.groups, conf_effect, feats)
        lh = torch.cat([lh0[..., None], lhc], dim=-1)
        lh = torch.where(c.na[None, :, sl, None], torch.ones((), device=lh.device), lh)
        return self.heat_lh(lh)

    @staticmethod
    def _masked_logp(p, source, subset, na):
        valid = (~na)[None] & subset[:, :, None]
        chosen = source_pick(p, source)
        return torch.where(valid, torch.log(torch.clamp(chosen, min=TINY)),
                           torch.zeros((), device=p.device)).sum((-1, -2))

    def gibbs_resample_source(self, gen, state_old, clusters_new, subset, i_cluster,
                              conf_counts_full=None) -> SourceResample:
        """Leave-subset-out Gibbs resample of the source of the objects in
        ``subset`` (B, N): forward and backward share the likelihoods,
        weights heated by 1/Tp, backward weights from the OLD clusters (the
        JAX package's ``_resample_engine`` as ``gibbs_resample_source`` calls
        it), over the model's feature tiles; the new source keeps the old
        one's form."""
        c = self.consts
        if conf_counts_full is None:
            conf_counts_full = self._conf_counts_of(state_old.source)
        hc_f = self.post.has_components(clusters_new)
        hc_b = self.post.has_components(state_old.clusters)
        new_tiles, log_q, log_q_back = [], [], []
        for sl in feature_tiles(c.F, c.feature_chunk):
            src, na = state_old.source[:, :, sl], c.na[:, sl]
            w_f = self.heat_prior(normalize_weights(state_old.weights[:, sl], hc_f))
            w_b = self.heat_prior(normalize_weights(state_old.weights[:, sl], hc_b))
            if self.sample_from_prior:
                p = w_f / torch.clamp(w_f.sum(-1, keepdim=True), min=EPS32)
                p_back = w_b / torch.clamp(w_b.sum(-1, keepdim=True), min=EPS32)
            else:
                lh = self._clgu(clusters_new, src, subset, i_cluster, conf_counts_full, sl)
                p = normalize(w_f * lh)
                p_back = normalize(w_b * lh)
            x = sample_categorical_onehot(gen, p) & ~na[None, :, :, None]
            if source_is_packed(src):
                src_new = torch.where(subset[:, :, None], pack_source(x), src)
            else:
                src_new = torch.where(subset[:, :, None, None], x, src)
            new_tiles.append(src_new)
            log_q.append(self._masked_logp(p, src_new, subset, na))
            log_q_back.append(self._masked_logp(p_back, src, subset, na))
        return SourceResample(cat_tiles(new_tiles, dim=2), add_tiles(log_q),
                              add_tiles(log_q_back))

    # ------------------------------------------------------------------
    # Gathered-rows engine: O(m F) per chain
    # ------------------------------------------------------------------

    def gather_obj(self, obj_idx):
        """Constant rows of the gathered objects: features (B, m, F, S),
        NA (B, m, F), confounder availability (B, m, C-1). Padding indices
        read a clamped row; callers mask it."""
        c = self.consts
        idx = torch.clamp(obj_idx, max=c.N - 1)
        return c.features[idx], c.na[idx], c.hc_conf[idx]

    def _clgu_rows(self, state_old, obj_idx, valid, i_cluster, counts, feats_m, na_m,
                   src_rows_old):
        """(B, m, F, C) heated leave-subset-out likelihoods of the gathered
        rows: the rows' own contribution is subtracted from the carried
        counts (exact: integer-valued f32)."""
        c = self.consts
        cl_counts, conf_counts = counts
        sub = valid.float()
        member = gather_cols(_pick_cluster(state_old.clusters, i_cluster)[:, None],
                             obj_idx)[:, 0].float() * sub                     # (B, m)
        excl0 = torch.einsum("bm,bmf,bmfs->bfs", member, src_rows_old[..., 0].float(), feats_m)
        cluster_effect = conditional_effect_mean(
            c.conc_cluster[None], _pick_cluster(cl_counts, i_cluster) - excl0,
            c.unif_conc[None], self.Tp, self.T)
        lh0 = torch.einsum("bfs,bmfs->bmf", cluster_effect, feats_m)
        g_m = take_cols(c.groups, obj_idx)                                     # (B, C-1, G, m)
        srcc = src_rows_old[..., 1:].float()                                   # (B, m, F, C-1)
        excl = torch.einsum("bcgm,bm,bmfc,bmfs->bcgfs", g_m, sub, srcc, feats_m)
        conf_effect = conditional_effect_mean(
            c.conc_conf[None], conf_counts - excl, c.unif_conc[None, None, None],
            self.Tp, self.T)
        lhc = torch.einsum("bcgm,bcgfs,bmfs->bmfc", g_m, conf_effect, feats_m)
        lh = torch.cat([lh0[..., None], lhc], dim=-1)
        lh = torch.where(na_m[..., None], torch.ones((), device=lh.device), lh)
        return self.heat_lh(lh)

    @staticmethod
    def _rows_logp(p, rows, valid, na_m):
        """(B,) sum of log p at the one-hot entries over valid, non-NA cells."""
        ok = (~na_m) & valid[:, :, None]
        chosen = (p * rows).sum(-1)
        return torch.where(ok, torch.log(torch.clamp(chosen, min=TINY)),
                           torch.zeros((), device=p.device)).sum((-1, -2))

    @staticmethod
    def source_prior_rows_logp(weights, hc_rows, rows, valid, na_m):
        """(B,) unheated source-prior contribution of the gathered rows."""
        w = normalize_weights(weights, hc_rows)
        p = (w * rows).sum(-1)
        ok = (~na_m) & valid[:, :, None]
        return torch.where(ok, torch.log(torch.where(ok, p, torch.ones_like(p))),
                           torch.zeros((), device=p.device)).sum((-1, -2))

    def rows_availability(self, clusters, obj_idx, hc_conf_m):
        """(B, m, C) availability of every component at the gathered rows."""
        hc0 = gather_cols(clusters, obj_idx).any(dim=1)                        # (B, m)
        return torch.cat([hc0[..., None], hc_conf_m], dim=-1)

    def _resample_engine_rows(self, gen, state_old, clusters_new, obj_idx, valid, i_fwd, i_back,
                              share_lh: bool, heat: bool, hc_back_from_old: bool,
                              counts) -> SourceResample:
        """Gibbs resample of the source rows of the DISTINCT objects
        ``obj_idx`` (B, m) with validity ``valid`` (B, m), leaving the rows'
        own contribution out of the effect estimates (the JAX package's
        ``_resample_engine_rows``). ``counts`` are the carried counts of
        ``state_old``; the rows are written later, by the MH step.

        ``i_fwd`` / ``i_back`` (B,): the cluster whose effect scores the
        forward / backward draw (``share_lh``: one likelihood for both);
        ``heat``: weights raised to 1/Tp; ``hc_back_from_old``: the backward
        availabilities come from the OLD clusters, else from the new ones."""
        feats_m, na_m, hc_conf_m = self.gather_obj(obj_idx)
        src_rows_old = gather_rows(state_old.source, obj_idx, self.consts.C)    # (B, m, F, C)
        hc_new_m = self.rows_availability(clusters_new, obj_idx, hc_conf_m)
        hc_old_m = self.rows_availability(state_old.clusters, obj_idx, hc_conf_m)

        w_f = normalize_weights(state_old.weights, hc_new_m)
        w_b = normalize_weights(state_old.weights, hc_old_m) if hc_back_from_old else w_f
        if heat:
            w_f = self.heat_prior(w_f)
            w_b = self.heat_prior(w_b)
        if self.sample_from_prior:
            p = w_f / torch.clamp(w_f.sum(-1, keepdim=True), min=EPS32)
            p_back = w_b / torch.clamp(w_b.sum(-1, keepdim=True), min=EPS32)
        else:
            lh_f = self._clgu_rows(state_old, obj_idx, valid, i_fwd, counts, feats_m, na_m,
                                   src_rows_old)
            lh_b = lh_f if share_lh else self._clgu_rows(
                state_old, obj_idx, valid, i_back, counts, feats_m, na_m, src_rows_old)
            p = normalize(w_f * lh_f)
            p_back = normalize(w_b * lh_b)

        x = sample_categorical_onehot(gen, p) & ~na_m[..., None]
        new_rows = torch.where(valid[:, :, None, None], x, src_rows_old)
        log_q = self._rows_logp(p, new_rows, valid, na_m)
        log_q_back = self._rows_logp(p_back, src_rows_old, valid, na_m)
        sp_delta = (self.source_prior_rows_logp(state_old.weights, hc_new_m, new_rows, valid, na_m)
                    - self.source_prior_rows_logp(state_old.weights, hc_old_m, src_rows_old,
                                                  valid, na_m))
        return SourceResample(state_old.source, log_q, log_q_back, sp_delta, new_rows=new_rows)

    def gibbs_resample_source_rows(self, gen, state_old, clusters_new, obj_idx, valid,
                                   i_cluster, counts) -> SourceResample:
        """Rows counterpart of ``gibbs_resample_source``, for moves within one
        cluster: forward and backward share the likelihoods, weights heated
        by 1/Tp, backward weights from the OLD clusters."""
        return self._resample_engine_rows(
            gen, state_old, clusters_new, obj_idx, valid, i_fwd=i_cluster, i_back=i_cluster,
            share_lh=True, heat=True, hc_back_from_old=True, counts=counts)

    def gibbs_resample_source_jump_rows(self, gen, state_old, clusters_new, obj_idx, valid,
                                        i_cluster_new, i_cluster_old, counts) -> SourceResample:
        """Source resample of objects that jump from cluster ``i_cluster_old``
        to ``i_cluster_new``: the forward draw under the target cluster's
        effect, the backward density under the source cluster's (both from
        the OLD state), unheated weights from the new clusters for both."""
        return self._resample_engine_rows(
            gen, state_old, clusters_new, obj_idx, valid, i_fwd=i_cluster_new,
            i_back=i_cluster_old, share_lh=False, heat=False, hc_back_from_old=False,
            counts=counts)

    def source_posterior_rows(self, clusters, weights, counts, obj_idx, feats_m, na_m,
                              hc_conf_m):
        """(B, m, F, C) full-counts source posterior at the gathered rows."""
        c = self.consts
        cl_counts, conf_counts = counts
        cl_eff = normalize(cl_counts + c.conc_cluster[None, None])
        mem = gather_cols(clusters, obj_idx).float()                            # (B, K, m)
        g_m = take_cols(c.groups, obj_idx)                                      # (B, C-1, G, m)
        conf_eff = normalize(conf_counts + c.conc_conf[None])
        lh0 = torch.einsum("bkm,bkfs,bmfs->bmf", mem, cl_eff, feats_m)
        lhc = torch.einsum("bcgm,bcgfs,bmfs->bmfc", g_m, conf_eff, feats_m)
        lh = torch.cat([lh0[..., None], lhc], dim=-1)
        lh = torch.where(na_m[..., None], torch.ones((), device=lh.device), lh)
        w = normalize_weights(weights, self.rows_availability(clusters, obj_idx, hc_conf_m))
        return normalize(self.heat_lh(lh) * self.heat_prior(w))

    def delta_counts_rows(self, counts, clusters, obj_idx, valid, src_old_rows,
                          src_new_rows, feats_m):
        """Exact count update for changed source rows (clusters unchanged)."""
        return self.delta_counts_rows_move(counts, clusters, clusters, obj_idx, valid,
                                           src_old_rows, src_new_rows, feats_m)

    def delta_counts_rows_move(self, counts, clusters_old, clusters_new, obj_idx, valid,
                               src_old_rows, src_new_rows, feats_m):
        """Exact count update for a multi-object move: subtract the rows' old
        contribution (old membership, old source), add the new one."""
        c = self.consts
        cl_counts, conf_counts = counts
        sub = valid.float()
        mem_old = gather_cols(clusters_old, obj_idx).float() * sub[:, None]    # (B, K, m)
        mem_new = gather_cols(clusters_new, obj_idx).float() * sub[:, None]
        delta_cl = (torch.einsum("bkm,bmf,bmfs->bkfs", mem_new, src_new_rows[..., 0].float(),
                                 feats_m)
                    - torch.einsum("bkm,bmf,bmfs->bkfs", mem_old, src_old_rows[..., 0].float(),
                                   feats_m))
        dc = src_new_rows[..., 1:].float() - src_old_rows[..., 1:].float()    # (B, m, F, C-1)
        g_m = take_cols(c.groups, obj_idx)
        delta_conf = torch.einsum("bcgm,bm,bmfc,bmfs->bcgfs", g_m, sub, dc, feats_m)
        return cl_counts + delta_cl, conf_counts + delta_conf


class ObjectSplitConditionals(Conditionals):
    """The conditionals over an ``ObjectSplitPosterior``: the rows of the
    gathered-rows engine come from the blocks that hold them, the
    membership marginal runs on each block."""

    def __init__(self, posterior, temperature=1.0, prior_temperature=1.0):
        super().__init__(posterior, temperature, prior_temperature)
        self.split = posterior.split

    def gather_obj(self, obj_idx):
        """``Conditionals.gather_obj``: the features and NA rows rebuilt on the
        head from the feature index rows (B, m, F) that the blocks send (one
        byte a cell; the features are one-hot, NA where the index is S),
        the confounder availabilities from the head."""
        c = self.consts
        idx = torch.clamp(obj_idx, max=c.N - 1)
        fi = self.split.take_rows([b.feat_idx for b in self.split.blocks], idx, batched=False)
        feats = (fi[..., None] == torch.arange(c.S, dtype=fi.dtype, device=fi.device)).float()
        return feats, fi == c.S, c.hc_conf[idx]

    def load_temperatures(self, temperature, prior_temperature):
        """Copy the (B,) per-chain temperatures into this object's own
        tensors and their inverses beside them, in place, where a captured
        CUDA graph reads them (``sampling/graphs.py``); float temperatures
        stay as they are."""
        for name, t in (("T", temperature), ("Tp", prior_temperature)):
            mine = getattr(self, name)
            if isinstance(mine, torch.Tensor):
                mine.copy_(t)
                getattr(self, "inv_" + name).copy_(1.0 / mine)

    @property
    def object_layout(self):
        return self.split
