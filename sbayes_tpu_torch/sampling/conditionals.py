"""Collapsed conditionals shared by the Gibbs-flavoured operators.

Port of the part of ``sbayes_tpu/sampling/conditionals.py`` that the default
sampling path uses: per-component likelihoods (also the exact leave-self-out
form for likelihood logging), the source posterior, and the Gibbs source
resample in its two forms — a mask over all objects
(``gibbs_resample_source``, used by the initializer) and gathered rows, m
objects per chain (``gibbs_resample_source_rows``). Everything is batched over chains: chain-state
tensors carry a leading axis B, ``i_cluster`` is a (B,) index, gathered
object indices are (B, m) with N meaning "padding".
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sbayes_tpu_torch.model.math import (
    conditional_effect_mean,
    gather_cols,
    gather_rows,
    normalize,
    normalize_weights,
    sample_categorical_onehot,
    source_pick,
    take_cols,
)
from sbayes_tpu_torch.model.posterior import Posterior

EPS32 = 1.1920929e-07  # float32 machine epsilon
TINY = 1e-35


class SourceResample(NamedTuple):
    source: torch.Tensor            # (B, N, F, C) new source (mask engine) or the OLD one (rows)
    log_q: torch.Tensor             # (B,) forward log-probability
    log_q_back: torch.Tensor        # (B,) backward log-probability
    source_prior_delta: Optional[torch.Tensor] = None  # (B,) rows engine only
    new_rows: Optional[torch.Tensor] = None            # (B, m, F, C) rows engine only


def _chains(x):
    return torch.arange(x.shape[0], device=x.device)


def _pick_cluster(x, i_cluster):
    """``x[b, i_cluster[b]]`` for a chain-batched x (B, K, ...)."""
    return x[_chains(x), i_cluster]


class Conditionals:
    """Gibbs conditionals of a model at fixed (Python float) temperatures."""

    def __init__(self, posterior: Posterior, temperature: float = 1.0,
                 prior_temperature: float = 1.0):
        self.post = posterior
        self.consts = posterior.consts
        self.T = float(temperature)
        self.Tp = float(prior_temperature)
        self.sample_from_prior = posterior.sample_from_prior

    # ------------------------------------------------------------------
    # Component likelihoods
    # ------------------------------------------------------------------

    def likelihood_per_component(self, clusters, cl_counts, conf_counts):
        """(B, N, F, C) likelihood of each observation under each component
        from the posterior-mean effects; NA observations get 1."""
        c = self.consts
        feats = c.features
        cl_eff = normalize(cl_counts + c.conc_cluster[None, None])
        lh0 = torch.einsum("bkn,bkfs,nfs->bnf", clusters.float(), cl_eff, feats)
        conf_eff = normalize(conf_counts + c.conc_conf[None])
        lhc = torch.einsum("cgn,bcgfs,nfs->bnfc", c.groups, conf_eff, feats)
        lh = torch.cat([lh0[..., None], lhc], dim=-1)
        return torch.where(c.na[None, :, :, None], torch.ones((), device=lh.device), lh)

    def likelihood_per_component_exact(self, clusters, source):
        """(B, N, F, C) leave-self-out component likelihoods: each
        observation is scored under effects estimated without its own
        contribution (for the likelihood logger)."""
        c = self.consts
        feats = c.features
        cl_counts, conf_counts = self.post.feature_counts(clusters, source)
        member = clusters.any(dim=1)                                      # (B, N)
        own0 = feats[None] * source[..., 0, None].float()                # (B, N, F, S)
        per_obj_cl = (torch.einsum("bkn,bkfs->bnfs", clusters.float(),
                                   cl_counts + c.conc_cluster[None, None])
                      - member[:, :, None, None] * own0)
        eff0 = per_obj_cl / torch.clamp(per_obj_cl.sum(-1, keepdim=True), min=EPS32)
        zero = torch.zeros((), device=feats.device)
        lh0 = torch.where(member[:, :, None], (eff0 * feats[None]).sum(-1), zero)
        lhs = [lh0[..., None]]
        base_conf = conf_counts + c.conc_conf[None]
        for i_c in range(c.C - 1):
            in_group = c.groups[i_c].sum(0) > 0                           # (N,)
            own = feats[None] * source[..., 1 + i_c, None].float()
            per_obj = (torch.einsum("gn,bgfs->bnfs", c.groups[i_c], base_conf[:, i_c])
                       - in_group[None, :, None, None] * own)
            eff = per_obj / torch.clamp(per_obj.sum(-1, keepdim=True), min=EPS32)
            lhs.append(torch.where(in_group[None, :, None], (eff * feats[None]).sum(-1),
                                   zero)[..., None])
        lh = torch.cat(lhs, dim=-1)
        return torch.where(c.na[None, :, :, None], torch.ones((), device=lh.device), lh)

    def source_posterior(self, clusters, weights, source, counts=None):
        """(B, N, F, C) posterior over the component of every observation."""
        if counts is None:
            counts = self.post.feature_counts(clusters, source)
        lh_pc = self.likelihood_per_component(clusters, *counts)
        w = normalize_weights(weights, self.post.has_components(clusters))
        return normalize(lh_pc ** (1.0 / self.T) * w ** (1.0 / self.Tp))

    # ------------------------------------------------------------------
    # Mask engine (all objects; subset given as a (B, N) mask)
    # ------------------------------------------------------------------

    def _conf_counts_of(self, source):
        """(B, C-1, Gmax, F, S) confounder counts of a source tensor."""
        return self.post.feature_counts(
            torch.zeros(source.shape[0], 0, source.shape[1], dtype=torch.bool,
                        device=source.device), source)[1]

    def _clgu(self, clusters, source, subset, i_cluster, conf_counts_full):
        """(B, N, F, C) heated component likelihoods with the subset's own
        contribution removed from the effect estimates (the cluster effect
        counts members outside the subset; each confounder effect uses its
        full counts minus the subset's)."""
        c = self.consts
        feats = c.features
        sub = subset.float()
        keep = _pick_cluster(clusters, i_cluster).float() * (1.0 - sub)   # (B, N)
        cl_keep = torch.einsum("bn,bnf,nfs->bfs", keep, source[..., 0].float(), feats)
        cluster_effect = conditional_effect_mean(
            c.conc_cluster[None], cl_keep, c.unif_conc[None], self.Tp, self.T)
        lh0 = torch.einsum("bfs,nfs->bnf", cluster_effect, feats)
        changeable = torch.stack([
            torch.einsum("gn,bn,bnf,nfs->bgfs", c.groups[i_c], sub,
                         source[..., 1 + i_c].float(), feats)
            for i_c in range(c.C - 1)], dim=1)
        conf_effect = conditional_effect_mean(
            c.conc_conf[None], conf_counts_full - changeable, c.unif_conc[None, None, None],
            self.Tp, self.T)
        lhc = torch.einsum("cgn,bcgfs,nfs->bnfc", c.groups, conf_effect, feats)
        lh = torch.cat([lh0[..., None], lhc], dim=-1)
        lh = torch.where(c.na[None, :, :, None], torch.ones((), device=lh.device), lh)
        return lh ** (1.0 / self.T)

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
        it; its other settings serve the jump, a later slice)."""
        c = self.consts
        if conf_counts_full is None:
            conf_counts_full = self._conf_counts_of(state_old.source)
        w_f = normalize_weights(state_old.weights, self.post.has_components(clusters_new))
        w_b = normalize_weights(state_old.weights, self.post.has_components(state_old.clusters))
        w_f = w_f ** (1.0 / self.Tp)
        w_b = w_b ** (1.0 / self.Tp)
        if self.sample_from_prior:
            p = w_f / torch.clamp(w_f.sum(-1, keepdim=True), min=EPS32)
            p_back = w_b / torch.clamp(w_b.sum(-1, keepdim=True), min=EPS32)
        else:
            lh = self._clgu(clusters_new, state_old.source, subset, i_cluster, conf_counts_full)
            p = normalize(w_f * lh)
            p_back = normalize(w_b * lh)
        x = sample_categorical_onehot(gen, p) & ~c.na[None, :, :, None]
        source_new = torch.where(subset[:, :, None, None], x, state_old.source)
        log_q = self._masked_logp(p, source_new, subset, c.na)
        log_q_back = self._masked_logp(p_back, state_old.source, subset, c.na)
        return SourceResample(source_new, log_q, log_q_back)

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
        return lh ** (1.0 / self.T)

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

    def gibbs_resample_source_rows(self, gen, state_old, clusters_new, obj_idx, valid,
                                   i_cluster, counts) -> SourceResample:
        """Rows counterpart of ``gibbs_resample_source`` (the JAX package's
        ``_resample_engine_rows``) on the DISTINCT indices ``obj_idx`` (B, m)
        with validity ``valid`` (B, m). ``counts`` are the carried counts of
        ``state_old``; the rows are written later, by the MH step."""
        feats_m, na_m, hc_conf_m = self.gather_obj(obj_idx)
        src_rows_old = gather_rows(state_old.source, obj_idx)                  # (B, m, F, C)
        hc_new_m = self.rows_availability(clusters_new, obj_idx, hc_conf_m)
        hc_old_m = self.rows_availability(state_old.clusters, obj_idx, hc_conf_m)

        w_f = normalize_weights(state_old.weights, hc_new_m) ** (1.0 / self.Tp)
        w_b = normalize_weights(state_old.weights, hc_old_m) ** (1.0 / self.Tp)
        if self.sample_from_prior:
            p = w_f / torch.clamp(w_f.sum(-1, keepdim=True), min=EPS32)
            p_back = w_b / torch.clamp(w_b.sum(-1, keepdim=True), min=EPS32)
        else:
            lh = self._clgu_rows(state_old, obj_idx, valid, i_cluster, counts, feats_m, na_m,
                                 src_rows_old)
            p = normalize(w_f * lh)
            p_back = normalize(w_b * lh)

        x = sample_categorical_onehot(gen, p) & ~na_m[..., None]
        new_rows = torch.where(valid[:, :, None, None], x, src_rows_old)
        log_q = self._rows_logp(p, new_rows, valid, na_m)
        log_q_back = self._rows_logp(p_back, src_rows_old, valid, na_m)
        sp_delta = (self.source_prior_rows_logp(state_old.weights, hc_new_m, new_rows, valid, na_m)
                    - self.source_prior_rows_logp(state_old.weights, hc_old_m, src_rows_old,
                                                  valid, na_m))
        return SourceResample(state_old.source, log_q, log_q_back, sp_delta, new_rows=new_rows)

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
        return normalize(lh ** (1.0 / self.T) * w ** (1.0 / self.Tp))

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
