"""The MCMC operators, batched over chains.

Port of ``sbayes_tpu/sampling/operators.py``: the scheduled operators —
grow/shrink (naive and Gibbsish), the wide membership resample, the jump of
one object between two clusters (K >= 2), the initializer's ML cluster
step, source Gibbs resampling (random subset, groups, all) and the weights
Gibbs step — and the ones no schedule draws: the wide operator's residual
effect proposals and its EM proposal, and the single-feature weights move
``make_alter_weights``. Each operator is ``op(gen, state) -> OpResult`` on a
batch of chains; one operator runs for the whole batch per step. Sentinel
transition probabilities force acceptance (Gibbs: log_q = -inf,
log_q_back = 0) or rejection (log_q = 0, log_q_back = -inf).

The membership marginal of the Gibbsish operators, of the wide operator
(whatever its effect proposal) and of the jump runs the CUDA kernel of
``ops/marginal.py`` on CUDA tensors (``_marginal_impl``,
``make_cluster_jump``). Under a cost-based geo prior every cluster operator
re-derives the carried skeleton aggregates of the clusters it changed
(``_update_geo``). The temperatures are the conditionals': Python floats for
unit temperatures, else (B,) tensors, one per chain (MC3).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from sbayes_tpu_torch.model.math import (
    add_tiles,
    cat_tiles,
    compact_indices,
    conditional_effect_mean,
    dirichlet_categorical_delta,
    dirichlet_logpdf,
    feature_tiles,
    gather_cols,
    gather_rows,
    normalize,
    normalize_weights,
    pack_source,
    per_chain,
    sample_categorical_onehot,
    source_n_changed,
)
from sbayes_tpu_torch.model.posterior import skeleton_of
from sbayes_tpu_torch.ops.marginal import marginal
from sbayes_tpu_torch.sampling.conditionals import EPS32, Conditionals, _pick_cluster
from sbayes_tpu_torch.sampling.state import ChainState
from sbayes_tpu_torch.tracing import span

TINY = 1e-35
NEG_INF = float("-inf")
LOG2 = math.log(2.0)


class OpResult(NamedTuple):
    state: ChainState                  # candidate (source: the OLD buffer when source_rows)
    log_q: torch.Tensor                # (B,)
    log_q_back: torch.Tensor           # (B,)
    step_size: torch.Tensor            # (B,)
    source_prior_delta: Optional[torch.Tensor] = None  # (B,) exact source-prior delta
    ll_delta: Optional[torch.Tensor] = None            # (B,) exact log-likelihood delta
    # Deferred source-row write (obj_idx (B, m), rows (B, m, F, C)); index N
    # marks padded or rejected entries, whose writes are dropped.
    source_rows: Optional[tuple] = None


def _masked_categorical(gen, p, mask):
    """(B,) index ~ p restricted to ``mask`` (Gumbel-max over log p)."""
    logits = torch.where(mask, torch.log(torch.clamp(p, min=TINY)),
                         torch.full((), NEG_INF, device=p.device))
    return torch.argmax(logits + _gumbel(gen, p.shape, p.device), dim=-1)


def _gumbel(gen, shape, device):
    """Standard Gumbel noise (uniforms clamped away from 0)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def _random_cluster_pair(gen, n_chains: int, n_clusters: int, device):
    """Per chain a random ordered pair (i_src, i_tgt) of distinct clusters."""
    perm = torch.argsort(torch.rand((n_chains, n_clusters), generator=gen, device=device), dim=-1)
    return perm[:, 0], perm[:, 1]


def _nanquantile_rows(x, q):
    """Per-row quantile ``q`` (B,) of ``x`` (B, n) over its non-NaN entries,
    interpolated linearly between the order statistics at ``q (n_valid - 1)``
    (numpy's default method); NaN for a row without any. One sort of the
    rows: ``torch.nanquantile`` with a vector ``q`` takes every q of every row."""
    v = torch.sort(x, dim=-1).values                                   # NaN last
    last = (~torch.isnan(x)).sum(-1).to(q.dtype) - 1
    pos = q * last
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low

    def at(i):
        i = torch.clamp(torch.minimum(i, last), min=0).long()
        return v.gather(-1, i[:, None])[:, 0]

    return at(low) * (1 - w_high) + at(high) * w_high


def _heat_prob(p, temperature):
    """p**(1/T) / (p**(1/T) + (1-p)**(1/T)) via logits (stable); ``p`` (B, N),
    ``temperature`` a float or (B,)."""
    logit = torch.log(torch.clamp(p, min=TINY)) - torch.log(torch.clamp(1.0 - p, min=TINY))
    return torch.sigmoid(logit / per_chain(temperature, logit))


def _reject_where(rejected, log_q, log_q_back, *deltas):
    """Apply the forced-reject sentinels (and zero deltas) on rejected chains."""
    zero = torch.zeros((), device=log_q.device)
    out = [torch.where(rejected, zero, log_q),
           torch.where(rejected, torch.full((), NEG_INF, device=log_q.device), log_q_back)]
    return out + [None if d is None else torch.where(rejected, zero, d) for d in deltas]


def wide_rows_cap_rule(n_objects: int, full_up_to: int = 1024, share: int = 16,
                  least: int = 512) -> int:
    """The most objects the wide operator resamples in one move (the JAX
    package's rule): all of them up to ``full_up_to`` objects, else
    max(``least``, N // ``share``). A move that changes more is rejected;
    the flip count is the same forward and backward, so the truncation is
    symmetric and plain MH on the restricted proposal stays exact."""
    return n_objects if n_objects <= full_up_to else max(least, n_objects // share)


def source_sweep_rule(n_features: int, threshold: int = 512) -> bool:
    """Whether the capped source selectors run the exact sequential sweep
    (``op_rows_sweep``) instead of the one-shot MH draw, whose acceptance
    collapses at large F (the JAX package's rule, outside prior mode)."""
    return n_features >= threshold


class OperatorFactory:
    """Builds the batched operator suite for one model and temperature.
    ``wide_rows_cap`` / ``source_sweep`` override ``wide_rows_cap_rule`` /
    ``source_sweep_rule`` (None: the rule for this model)."""

    def __init__(self, cond: Conditionals, p_grow: float = 0.5,
                 wide_rows_cap: Optional[int] = None, source_sweep: Optional[bool] = None):
        self.cond = cond
        self.consts = cond.consts
        self.T = cond.T
        self.Tp = cond.Tp
        # The heat variant of the marginal is the identity at the float T = 1
        # (plain ensembles); tensor temperatures take it on every chain, the
        # cold one included, as the JAX package's traced temperatures do.
        self.unit_T = not isinstance(self.T, torch.Tensor) and self.T == 1.0
        self.sample_from_prior = cond.sample_from_prior
        self.p_grow = p_grow
        N = self.consts.N
        self.wide_rows_cap = (wide_rows_cap_rule(N) if wide_rows_cap is None
                              else min(N, int(wide_rows_cap)))
        self.source_sweep = (source_sweep_rule(self.consts.F) if source_sweep is None
                             else bool(source_sweep))

    def sweeps(self, object_selector: str) -> bool:
        """Whether ``make_gibbs_sample_source(object_selector, ...)`` draws
        with the sequential sweep (``op_rows_sweep``)."""
        return (self.source_sweep and not self.sample_from_prior and self.consts.N > 10
                and object_selector != "all")

    # ==================================================================
    # Shared cluster-posterior math
    # ==================================================================

    def _state_counts(self, state):
        if state.cl_counts is None:
            return self.cond.post.feature_counts(state.clusters, state.source)
        return state.cl_counts, state.conf_counts

    # ------------------------------------------------------------------
    # Cluster-effect proposals: the effect (B, F, S) of cluster ``i_cluster``
    # that scores membership. 'gibbs' (its posterior mean) is what the
    # scheduled operators use; 'residual' and 'residual_counts' are
    # selectable on the wide operator.
    # ------------------------------------------------------------------

    def _heated_effect(self, counts):
        c = self.consts
        return conditional_effect_mean(c.conc_cluster[None], counts, c.unif_conc[None],
                                       self.Tp, self.T)

    def cluster_effect_proposal_gibbs(self, state, cl_counts, conf_counts, i_cluster):
        return self._heated_effect(_pick_cluster(cl_counts, i_cluster))

    def cluster_effect_proposal_residual(self, state, cl_counts, conf_counts, i_cluster):
        """The effect of the features of every object in no cluster."""
        free = (~state.clusters.any(dim=1)).float()
        return self._heated_effect(torch.einsum("bn,nfs->bfs", free, self.consts.features))

    def cluster_effect_proposal_residual_counts(self, state, cl_counts, conf_counts, i_cluster):
        """The effect of the feature counts above the expected confounder
        mixture, over the free objects and the cluster's own whose residual
        likelihood lies at or above the quantile ``1 - size / n_free``."""
        c = self.consts
        cluster = _pick_cluster(state.clusters, i_cluster)
        free = (~state.clusters.any(dim=1)) | cluster
        size, n_free = cluster.sum(-1), free.sum(-1)
        exp_conf = self.cond.expected_confounder_features(state.clusters, state.weights,
                                                          conf_counts)
        residual = torch.clamp(c.features[None] - exp_conf, min=0.0) * free[:, :, None, None]
        p = self._heated_effect(residual.sum(1))
        lh = (p[:, None] * residual).sum((2, 3))                               # (B, N)
        q = 1.0 - size / torch.clamp(n_free, min=1)
        thresh = _nanquantile_rows(torch.where(free, lh, float("nan")), q)
        relevant = free & (lh >= thresh[:, None])
        return self._heated_effect((residual * relevant[:, :, None, None]).sum(1))

    def _marginal_impl(self, state, i_cluster, counts, heat_effect_lh, ratio,
                       effect_proposal="gibbs"):
        """Collapsed membership marginals of every object for cluster
        ``i_cluster`` (B,) under the effect ``cluster_effect_proposal_<effect_proposal>``:
        the signed log-odds (B, N) when ``ratio``, else (log_m0, log_m1). The
        kernel of ``ops/marginal.py``."""
        c = self.consts
        cl_counts, conf_counts = self._state_counts(state) if counts is None else counts
        hc = self.cond.post.has_components(state.clusters)
        hc_flip = hc.clone()
        hc_flip[..., 0] = ~hc[..., 0]
        use_heat = heat_effect_lh and not self.unit_T
        proposal = getattr(self, f"cluster_effect_proposal_{effect_proposal}")
        p_eff = proposal(state, cl_counts, conf_counts, i_cluster)            # (B, F, S)
        conf_eff = normalize(conf_counts + c.conc_conf[None])
        p_rows = p_eff[:, None] if ratio else torch.stack([p_eff, p_eff], dim=1)
        B = p_eff.shape[0]
        inv_t = None
        if use_heat:
            inv_t = (self.cond.inv_T if isinstance(self.T, torch.Tensor)
                     else torch.full((B,), self.cond.inv_T, device=p_eff.device))
        out = marginal(self.cond.object_layout, p_rows.contiguous(), conf_eff,
                       self.cond.heat_prior(state.weights), hc.float(), hc_flip.float(),
                       hc[..., 0].float(), inv_t, ratio=ratio)
        if ratio:
            return out / per_chain(self.T, out)
        t = per_chain(self.T, out[..., 0])
        return out[..., 0] / t, out[..., 1] / t

    def _cluster_log_odds(self, state, i_cluster, counts=None, heat_effect_lh=False,
                          effect_proposal="gibbs"):
        """(B, N) signed log-odds log_m1 - log_m0 of cluster membership."""
        return self._marginal_impl(state, i_cluster, counts, heat_effect_lh, ratio=True,
                                   effect_proposal=effect_proposal)

    def _log_marginal_with_without(self, state, i_cluster, counts=None, heat_effect_lh=False):
        """(log_m0, log_m1): absolute log-marginals without / with membership."""
        return self._marginal_impl(state, i_cluster, counts, heat_effect_lh, ratio=False)

    def _cluster_posterior(self, state, i_cluster, gibbsish=True, counts=None,
                           additive_smoothing=1e-6, heat_effect_lh=False,
                           consider_geo=False, geo_scaler=1.0, effect_proposal="gibbs"):
        """(B, N) membership probability of each object; with
        ``consider_geo`` the log-odds gain the geo-prior change of adding
        the object (from the carried aggregates when the state has them)."""
        B, N = state.clusters.shape[0], self.consts.N
        if self.sample_from_prior or not gibbsish:
            return torch.full((B, N), 0.5, device=state.clusters.device)
        odds = self._cluster_log_odds(state, i_cluster, counts, heat_effect_lh, effect_proposal)
        if consider_geo:
            geo = self.cond.post.geo_prior_costs_per_object(state.clusters, i_cluster,
                                                            geo_agg=state.geo_agg)
            odds = odds + geo / per_chain(self.Tp, geo) / geo_scaler
        p = torch.sigmoid(odds)
        if additive_smoothing > 0:
            a = additive_smoothing
            p = (p + a) / (1 + 2 * a)
        return p

    def _delta_counts(self, counts, obj, clusters_old, clusters_new, src_old_row, src_new_row):
        """Exact O(F S) count update for ONE object per chain, ``obj`` (B,),
        plus the exact log-likelihood delta (logs of the touched entries)."""
        c = self.consts
        cl_counts, conf_counts = counts
        ar = torch.arange(obj.shape[0], device=obj.device)
        feats_o = self.cond.gather_obj(obj[:, None])[0][:, 0]                 # (B, F, S)
        old0 = feats_o * src_old_row[..., 0, None].float()
        new0 = feats_o * src_new_row[..., 0, None].float()
        mem_new = clusters_new[ar, :, obj].float()                             # (B, K)
        mem_old = clusters_old[ar, :, obj].float()
        d_cl = mem_new[:, :, None, None] * new0[:, None] - mem_old[:, :, None, None] * old0[:, None]
        g_o = c.groups[:, :, obj].permute(2, 0, 1)                             # (B, C-1, G)
        oldc = feats_o[:, None] * src_old_row[..., 1:].float().permute(0, 2, 1)[..., None]
        newc = feats_o[:, None] * src_new_row[..., 1:].float().permute(0, 2, 1)[..., None]
        d_conf_row = newc - oldc                                               # (B, C-1, F, S)
        conf = conf_counts + g_o[..., None, None] * d_conf_row[:, :, None]
        ll_d = dirichlet_categorical_delta(cl_counts, c.conc_cluster[None, None], d_cl).sum(-1)
        row_old = torch.einsum("bcg,bcgfs->bcfs", g_o, conf_counts)
        a_row = torch.einsum("bcg,cgfs->bcfs", g_o, c.conc_conf)
        has_g = g_o.sum(-1)[..., None, None]
        ll_d = ll_d + dirichlet_categorical_delta(row_old, a_row, d_conf_row * has_g).sum(-1)
        return cl_counts + d_cl, conf, ll_d

    def _delta_pat(self, pat_counts, obj_idx, valid, hc0_old, hc0_new, old_rows, new_rows):
        """Exact availability-pattern count update for the rows at ``obj_idx``."""
        if pat_counts is None:
            return None
        c = self.consts
        P = c.pat_bits.shape[0]
        static_m = c.static_pat[torch.clamp(obj_idx, max=c.N - 1)]
        v = valid.float()[..., None]
        oh_old = torch.nn.functional.one_hot(static_m + hc0_old.long() * (P // 2), P).float() * v
        oh_new = torch.nn.functional.one_hot(static_m + hc0_new.long() * (P // 2), P).float() * v
        B, m = obj_idx.shape
        delta = (torch.einsum("bmp,bmx->bpx", oh_new, new_rows.reshape(B, m, -1).float())
                 - torch.einsum("bmp,bmx->bpx", oh_old, old_rows.reshape(B, m, -1).float()))
        return pat_counts + delta.view(pat_counts.shape)

    def _update_geo(self, geo_agg, clusters_new, *changed_clusters):
        """The carried (B, K, 3) skeleton aggregates with the rows of the
        changed clusters (each a (B,) index) re-derived from ``clusters_new``
        (``Posterior.updated_geo_agg``). None when geo is not carried."""
        if geo_agg is None:
            return None
        return self.cond.post.updated_geo_agg(geo_agg, clusters_new, changed_clusters)

    def _grow_candidates(self, clusters, i_cluster, neighbourhood: str):
        """(B, N) growth candidates of cluster ``i_cluster``."""
        occ = clusters.any(dim=1)
        if neighbourhood == "everywhere":
            return ~occ
        adj = self.consts.adjacency.float()
        reach = _pick_cluster(clusters, i_cluster).float() @ adj.T
        if neighbourhood == "twostep":
            reach = reach @ adj.T
        return (reach > 0) & ~occ

    # ==================================================================
    # AlterCluster: grow or shrink one object (naive and Gibbsish)
    # ==================================================================

    def make_alter_cluster(self, gibbsish: bool, neighbourhood: str,
                           consider_geo: bool = False) -> Callable:
        """Grow or shrink one cluster by one object, with the JAX package's
        proposal densities: both carry log p_grow / log p_shrink (the
        direction of the move and of its reverse), forced directions
        included, and a move FROM a bound size gets -log 2 on a finite
        log_q_back; a shrink whose removed object is no grow candidate of
        the new state is rejected. (This rule samples the bound sizes at
        half the prior's probability; the port computes what the JAX
        package computes, ROADMAP C.1.)"""
        cond = self.cond
        K, N = self.consts.K, self.consts.N
        min_size, max_size = self.consts.min_size, self.consts.max_size
        p_grow, T = self.p_grow, self.T
        lp_grow, lp_shrink = math.log(p_grow), math.log1p(-p_grow)

        def op(gen, state):
            B = state.n_chains
            dev = state.clusters.device
            ar = torch.arange(B, device=dev)
            i_cluster = torch.randint(0, K, (B,), generator=gen, device=dev)
            cluster = _pick_cluster(state.clusters, i_cluster)
            size = cluster.sum(-1)
            at_min, at_max = size == min_size, size == max_size
            u_grow = torch.rand(B, generator=gen, device=dev)
            do_grow = torch.where(at_min, True, torch.where(at_max, False, u_grow < p_grow))

            counts = self._state_counts(state)
            grow_cand = self._grow_candidates(state.clusters, i_cluster, neighbourhood)
            p_post = _heat_prob(self._cluster_posterior(state, i_cluster, gibbsish, counts,
                                                        consider_geo=consider_geo), T)
            zero = torch.zeros((), device=dev)
            p_vec = torch.where(do_grow[:, None], torch.where(grow_cand, p_post, zero),
                                torch.where(cluster, 1.0 - p_post, zero))
            total = p_vec.sum(-1)
            fwd_mask = torch.where(do_grow[:, None], grow_cand, cluster)
            obj = _masked_categorical(gen, p_vec, fwd_mask | ~fwd_mask.any(-1, keepdim=True))
            p_fwd = p_vec / torch.clamp(total, min=TINY)[:, None]
            rejected = torch.where(
                do_grow, (~grow_cand.any(-1)) | (size >= max_size) | (total <= 0),
                (size <= min_size) | (total <= 0))

            clusters_new = state.clusters.clone()
            clusters_new[ar, i_cluster, obj] = do_grow
            obj_idx = obj[:, None]
            valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
            rs = cond.gibbs_resample_source_rows(gen, state, clusters_new, obj_idx, valid,
                                                 i_cluster, counts)
            src_obj = gather_rows(state.source, obj_idx, self.consts.C)          # (B, 1, F, C)
            cl_new, conf_new, ll_d = self._delta_counts(
                counts, obj, state.clusters, clusters_new, src_obj[:, 0], rs.new_rows[:, 0])
            counts_new = (cl_new, conf_new)
            pat_new = self._delta_pat(
                state.pat_counts, obj_idx, valid, state.clusters[ar, :, obj].any(-1)[:, None],
                clusters_new[ar, :, obj].any(-1)[:, None], src_obj, rs.new_rows)
            state_new = state._replace(
                clusters=clusters_new, pat_counts=pat_new, cl_counts=cl_new, conf_counts=conf_new,
                geo_agg=self._update_geo(state.geo_agg, clusters_new, i_cluster))

            back_grow_cand = self._grow_candidates(clusters_new, i_cluster, neighbourhood)
            rejected = rejected | (~do_grow & ~back_grow_cand[ar, obj])
            new_cluster = _pick_cluster(clusters_new, i_cluster)
            p_back = _heat_prob(self._cluster_posterior(state_new, i_cluster, gibbsish,
                                                        counts_new, consider_geo=consider_geo), T)
            pb_vec = torch.where(do_grow[:, None], torch.where(new_cluster, 1.0 - p_back, zero),
                                 torch.where(back_grow_cand, p_back, zero))
            p_bwd = pb_vec / torch.clamp(pb_vec.sum(-1), min=TINY)[:, None]

            lp_fwd = torch.where(do_grow, lp_grow, lp_shrink)
            lp_back = torch.where(do_grow, lp_shrink, lp_grow)
            log_q = torch.log(torch.clamp(p_fwd[ar, obj], min=TINY)) + rs.log_q + lp_fwd
            log_q_back = (torch.log(torch.clamp(p_bwd[ar, obj], min=TINY)) + rs.log_q_back
                          + lp_back)
            log_q, log_q_back, sp_d, ll_d = _reject_where(
                rejected, log_q, log_q_back, rs.source_prior_delta, ll_d)
            # The boundary correction -log 2 on the backward probability.
            boundary = at_min | at_max
            log_q_back = log_q_back - torch.where(boundary & torch.isfinite(log_q_back),
                                                  LOG2, 0.0)
            rows = (torch.where(rejected, N, obj)[:, None], rs.new_rows)
            return OpResult(state_new, log_q, log_q_back, torch.ones(B, device=dev),
                            source_prior_delta=sp_d, ll_delta=ll_d, source_rows=rows)

        return op

    # ==================================================================
    # AlterClusterWide: resample the whole membership vector of one cluster
    # ==================================================================

    def _make_wide_cluster_probs(self, w_stay: float, eps: float, consider_geo: bool = False,
                                 geo_scaler: float = 2.0, effect_proposal: str = "gibbs") -> Callable:
        """(B, N) Bernoulli proposal probabilities of the wide operator:
        the posterior (under ``effect_proposal``) mixed with the current
        cluster, rescaled so the expected proposal size matches the current
        size."""

        def cluster_probs(state, i_cluster, avail, counts=None):
            cluster = _pick_cluster(state.clusters, i_cluster)
            availf = avail.float()
            p_raw = self._cluster_posterior(state, i_cluster, counts=counts,
                                            additive_smoothing=0.0, heat_effect_lh=True,
                                            consider_geo=consider_geo, geo_scaler=geo_scaler,
                                            effect_proposal=effect_proposal)
            p_raw = p_raw * availf
            p = (p_raw + EPS32) / torch.clamp((p_raw + EPS32 * availf).sum(-1, keepdim=True),
                                              min=TINY) * availf
            p_n = (p + eps) / torch.clamp((p + eps * availf).sum(-1, keepdim=True), min=TINY)
            stay = cluster.float()
            stay_n = stay / torch.clamp(stay.sum(-1, keepdim=True), min=TINY)
            p = ((1 - w_stay) * p_n + w_stay * stay_n) * availf
            old_size = (cluster & avail).sum(-1, keepdim=True).float()
            done = torch.zeros_like(old_size, dtype=torch.bool)
            for _ in range(10):
                new_exp = p.sum(-1, keepdim=True)
                p2 = torch.clamp(p * old_size / torch.clamp(new_exp, min=TINY), eps, 1 - eps) * availf
                p2 = torch.where(done, p, p2)
                done = done | (p2.sum(-1, keepdim=True) > 0.975 * old_size)
                p = p2
            return p * availf

        return cluster_probs

    def _make_em_cluster_probs(self, consider_geo: bool, w_stay: float, eps: float,
                               n_em_steps: int = 10) -> Callable:
        """(B, N) Bernoulli proposal probabilities of the EM proposal: soft-EM
        responsibilities (B, Gt, N) over the K clusters and every confounder
        group (Gt = K + (C-1) Gmax, rows of unavailable groups at -inf before
        the softmax over groups), annealed at temperature (n_steps / (1 +
        i))^2 and seeded at step 0 with the cluster's Gibbs effect; then the
        stay mixture and the expected-size rescale of the wide operator.
        The first rescale divides by the total responsibility mass (N), as
        the JAX package and sBayes do."""
        c = self.consts
        N, K = c.N, c.K
        ga = torch.cat([torch.ones((K, N), dtype=torch.bool, device=c.device),
                        ((c.groups > 0) & c.group_valid[..., None]).reshape(-1, N)])
        prior_counts = 0.5 * c.applicable.float()
        feats_filled = torch.where(c.na[..., None], torch.ones((), device=c.device), c.features)
        neg_inf = torch.full((), NEG_INF, device=c.device)

        def cluster_probs(state, i_cluster, avail, counts=None):
            if self.sample_from_prior:
                return avail.float() * 0.5
            B = state.n_chains
            ar = torch.arange(B, device=avail.device)
            cluster = _pick_cluster(state.clusters, i_cluster)
            cl_counts, conf_counts = self._state_counts(state) if counts is None else counts
            p_clust = self.cluster_effect_proposal_gibbs(state, cl_counts, conf_counts, i_cluster)
            z = ga.float().expand(B, -1, -1).clone()
            z[:, :K] = state.clusters.float()
            z[ar, i_cluster] = torch.where(avail, 1.0, z[ar, i_cluster])
            z = z / torch.clamp(z.sum(1, keepdim=True), min=TINY)
            for i_step in range(n_em_steps):
                p = normalize(torch.einsum("bgn,nfs->bgfs", z, c.features) + prior_counts)
                if i_step == 0:
                    p[ar, i_cluster] = p_clust
                log_pw = torch.einsum("bgfs,nfs->bgn", torch.log(torch.clamp(p, min=TINY)),
                                      feats_filled)
                log_lh = log_pw / (n_em_steps / (1.0 + i_step)) ** 2
                if consider_geo:
                    geo_log = -(torch.softmax(N * z, dim=2) @ c.cost_matrix) / c.geo.scale / 2.0
                    geo_log[:, K:] = torch.log(torch.clamp(torch.exp(geo_log[:, :K]).mean(1),
                                                           min=TINY))[:, None]
                    log_lh = geo_log + log_lh
                log_lh = torch.where(ga, log_lh, neg_inf)
                log_lh[ar, i_cluster] = torch.where(avail, log_lh[ar, i_cluster], neg_inf)
                z = torch.softmax(log_lh, dim=1)

            availf = avail.float()
            z_cl = torch.where(avail, z[ar, i_cluster], 0.0)
            z_cl = z_cl / torch.clamp(z_cl.sum(-1, keepdim=True), min=TINY)
            z_eps = (z_cl + eps) * availf
            z_eps = z_eps / torch.clamp(z_eps.sum(-1, keepdim=True), min=TINY)
            stay = (cluster & avail).float()
            stay_n = stay / torch.clamp(stay.sum(-1, keepdim=True), min=TINY)
            p = (1 - w_stay) * z_eps + w_stay * stay_n
            old_size = stay.sum(-1, keepdim=True)
            prev_exp = z.sum((1, 2))[:, None]
            done = torch.zeros_like(old_size, dtype=torch.bool)
            for _ in range(10):
                p2 = torch.clamp(p * old_size / torch.clamp(prev_exp, min=TINY), eps,
                                 1 - eps) * availf
                p2 = torch.where(done, p, p2)
                prev_exp = p2.sum(-1, keepdim=True)
                done = done | (prev_exp > 0.975 * old_size)
                p = p2
            return torch.where(avail, p, 0.0)

        return cluster_probs

    def make_alter_cluster_wide(self, consider_geo: bool = False, w_stay: float = 0.15,
                                eps: float = None, geo_scaler: float = 2.0,
                                effect_proposal: str = "gibbs", em_proposal: bool = False,
                                n_em_steps: int = 10) -> Callable:
        """Resample the full membership of one cluster (redraw until the
        proposal differs, at most 100 rounds) with a gathered-rows source
        resample over the changed objects, at most ``wide_rows_cap`` of
        them: a move that changes more is rejected (its ``step_size``, the
        flip count, still says how many). The proposal probabilities come
        from the collapsed posterior under ``effect_proposal``, or with
        ``em_proposal`` from ``n_em_steps`` steps of soft EM."""
        cond = self.cond
        K, N = self.consts.K, self.consts.N
        min_size, max_size = self.consts.min_size, self.consts.max_size
        M = self.wide_rows_cap
        if eps is None:
            eps = 0.01 / N
        if em_proposal:
            cluster_probs = self._make_em_cluster_probs(consider_geo, w_stay, eps, n_em_steps)
        else:
            cluster_probs = self._make_wide_cluster_probs(w_stay, eps, consider_geo, geo_scaler,
                                                          effect_proposal)

        def op(gen, state):
            B = state.n_chains
            dev = state.clusters.device
            ar = torch.arange(B, device=dev)
            i_cluster = torch.randint(0, K, (B,), generator=gen, device=dev)
            cluster_old = _pick_cluster(state.clusters, i_cluster)
            avail = (~state.clusters.any(dim=1)) | cluster_old
            counts = self._state_counts(state)
            p = cluster_probs(state, i_cluster, avail, counts)

            # Redraw until the proposal differs from the current cluster
            # (masked over chains; at most 100 draws per chain).
            current = cluster_old & avail
            draw = (torch.rand(p.shape, generator=gen, device=dev) < p) & avail
            same = (draw == current).all(-1)
            for _ in range(99):
                any_same = same.any()
                with span("sbt.sync/wide.redraw"):
                    if not bool(any_same):
                        break
                redraw = (torch.rand(p.shape, generator=gen, device=dev) < p) & avail
                draw = torch.where(same[:, None], redraw, draw)
                same = same & (draw == current).all(-1)

            cluster_new = torch.where(avail, draw, cluster_old)
            new_size = cluster_new.sum(-1)
            standstill = (cluster_new == cluster_old).all(-1)
            rejected = (new_size < min_size) | (new_size > max_size) | standstill

            zero = torch.zeros((), device=dev)

            def site_logp(prob, chosen):
                q = torch.where(chosen, prob, 1.0 - prob)
                return torch.where(avail, torch.log(torch.clamp(q, min=TINY)), zero).sum(-1)

            log_q = site_logp(p, draw) - torch.log1p(
                -torch.clamp(torch.exp(site_logp(p, cluster_old)), max=1 - 1e-7))

            clusters_new = state.clusters.clone()
            clusters_new[ar, i_cluster] = cluster_new
            changed = cluster_old != cluster_new
            m = changed.sum(-1)
            rejected = rejected | (m > M)
            obj_idx = compact_indices(changed, M, N)
            valid = torch.arange(M, device=dev)[None] < m[:, None]
            src_rows_old = gather_rows(state.source, obj_idx, self.consts.C)
            rs = cond.gibbs_resample_source_rows(gen, state, clusters_new, obj_idx, valid,
                                                 i_cluster, counts)
            feats_m = cond.gather_obj(obj_idx)[0]
            counts_new = cond.delta_counts_rows_move(counts, state.clusters, clusters_new,
                                                     obj_idx, valid, src_rows_old, rs.new_rows,
                                                     feats_m)
            pat_new = self._delta_pat(
                state.pat_counts, obj_idx, valid, gather_cols(state.clusters, obj_idx).any(1),
                gather_cols(clusters_new, obj_idx).any(1), src_rows_old, rs.new_rows)
            state_new = state._replace(
                clusters=clusters_new, pat_counts=pat_new, cl_counts=counts_new[0],
                conf_counts=counts_new[1],
                geo_agg=self._update_geo(state.geo_agg, clusters_new, i_cluster))

            p_back = cluster_probs(state_new, i_cluster, avail, counts_new)
            log_q_back = site_logp(p_back, cluster_old) - torch.log1p(
                -torch.clamp(torch.exp(site_logp(p_back, cluster_new)), max=1 - 1e-7))

            log_q, log_q_back, sp_d = _reject_where(
                rejected, log_q + rs.log_q, log_q_back + rs.log_q_back, rs.source_prior_delta)
            rows = (torch.where(rejected[:, None], N, obj_idx), rs.new_rows)
            return OpResult(state_new, log_q, log_q_back, m.float(), source_prior_delta=sp_d,
                            source_rows=rows)

        return op

    def make_ml_cluster_step(self, consider_geo: bool = True, w_stay: float = 0.1,
                             eps: float = 1e-6, geo_scaler: float = 2.0) -> Callable:
        """Deterministic maximum-likelihood cluster step of the initializer:
        threshold the wide proposal probabilities at the current size.
        Returns ``step(gen, state, i_cluster)`` for an int ``i_cluster``."""
        cond = self.cond
        consts = self.consts
        cluster_probs = self._make_wide_cluster_probs(w_stay, eps, consider_geo, geo_scaler)

        def ml_step(gen, state, i_cluster: int):
            B = state.n_chains
            dev = state.clusters.device
            ar = torch.arange(B, device=dev)
            ic = torch.full((B,), i_cluster, dtype=torch.long, device=dev)
            cluster_old = state.clusters[:, i_cluster]
            avail = (~state.clusters.any(dim=1)) | cluster_old
            p = torch.where(avail, cluster_probs(state, ic, avail),
                            torch.full((), NEG_INF, device=dev))
            size = torch.clamp(cluster_old.sum(-1), consts.min_size, consts.max_size)
            sorted_p = torch.sort(p, dim=-1, descending=True).values
            thresh = sorted_p[ar, torch.clamp(size - 1, min=0)]
            cluster_new = (p >= thresh[:, None]) & avail
            n_new = cluster_new.sum(-1)
            ok = (consts.min_size <= n_new) & (n_new <= consts.max_size)
            cluster_new = torch.where(ok[:, None], cluster_new, cluster_old)
            clusters_new = state.clusters.clone()
            clusters_new[:, i_cluster] = cluster_new
            changed = cluster_old != cluster_new
            rs = cond.gibbs_resample_source(gen, state, clusters_new, changed, ic)
            state_new = state._replace(
                clusters=clusters_new, source=rs.source,
                geo_agg=self._update_geo(state.geo_agg, clusters_new, ic))
            if state.cl_counts is not None:
                cl, conf = cond.post.feature_counts(clusters_new, rs.source)
                state_new = state_new._replace(cl_counts=cl, conf_counts=conf)
            if state.pat_counts is not None:
                state_new = state_new._replace(
                    pat_counts=cond.post.pattern_counts(clusters_new, rs.source))
            return state_new

        return ml_step

    # ==================================================================
    # ClusterJump: move one object between two clusters
    # ==================================================================

    def _jump_probability(self, state, counts, i_src, i_tgt, logspace: bool):
        """(B, N) probability that each member of cluster ``i_src`` (B,)
        prefers cluster ``i_tgt`` (B,); meaningful at the members of i_src.

        One launch of the marginal kernel scores both memberships: effect
        rows [source, target], ``hc_flip = hc`` and ``incl = 1``, so the
        "with" marginal is staying and the "without" marginal is the jump.
        ``logspace``: sigmoid((log m_jump - log m_stay) / T) from the
        two-effect ratio form; else both marginals are exponentiated in f32
        and floored at EPS (products that underflow give 0.5)."""
        c = self.consts
        cl_counts, conf_counts = counts

        def effect(i):
            return conditional_effect_mean(c.conc_cluster[None], _pick_cluster(cl_counts, i),
                                           c.unif_conc[None], self.Tp, self.T)

        p_eff = torch.stack([effect(i_src), effect(i_tgt)], dim=1).contiguous()
        conf_eff = conditional_effect_mean(c.conc_conf[None], conf_counts,
                                           c.unif_conc[None, None, None], self.Tp, self.T)
        hc = self.cond.post.has_components(state.clusters).float()
        wh = self.cond.heat_prior(state.weights)
        incl = torch.ones(hc.shape[:2], device=hc.device)
        if logspace:
            diff = marginal(self.cond.object_layout, p_eff, conf_eff, wh, hc, hc, incl, None,
                            ratio=True, two_eff=True)
            return torch.sigmoid(-diff / per_chain(self.T, diff))
        out = marginal(self.cond.object_layout, p_eff, conf_eff, wh, hc, hc, incl, None,
                       ratio=False)
        t = per_chain(self.T, out[..., 0])
        lh_jump = torch.exp(out[..., 0] / t) + EPS32
        lh_stay = torch.exp(out[..., 1] / t) + EPS32
        return lh_jump / (lh_jump + lh_stay)

    def make_cluster_jump(self, gibbsish: bool = True, logspace: Optional[bool] = None) -> Callable:
        """Move one object from a random cluster to another random cluster
        (per chain a random ordered pair), chosen among the source cluster's
        members by how much each prefers the target, with a resample of its
        source row. Rejected when the source cluster is at its minimum or
        the target at its maximum size. ``logspace`` picks the form of
        ``_jump_probability`` (default: log-space from 512 features on, where
        the f32 products underflow)."""
        cond = self.cond
        consts = self.consts
        K, N = consts.K, consts.N
        if logspace is None:
            logspace = consts.F >= 512
        informed = gibbsish and not self.sample_from_prior
        # The two membership writes take device values: a Python scalar would
        # be copied to the card in every step, and wait for it.
        out = torch.zeros((), dtype=torch.bool, device=consts.device)
        into = torch.ones((), dtype=torch.bool, device=consts.device)

        def op(gen, state):
            B = state.n_chains
            dev = state.clusters.device
            ar = torch.arange(B, device=dev)
            i_src, i_tgt = _random_cluster_pair(gen, B, K, dev)
            source_cluster = _pick_cluster(state.clusters, i_src)
            target_cluster = _pick_cluster(state.clusters, i_tgt)
            rejected = ((source_cluster.sum(-1) <= consts.min_size)
                        | (target_cluster.sum(-1) >= consts.max_size))

            counts = self._state_counts(state)
            ones = torch.ones((B, N), device=dev)
            zero = torch.zeros((), device=dev)
            pj = self._jump_probability(state, counts, i_src, i_tgt, logspace) if informed else ones
            pj_vec = torch.where(source_cluster, pj, zero)
            p_jump = pj_vec / torch.clamp(pj_vec.sum(-1, keepdim=True), min=TINY)

            obj = _masked_categorical(gen, pj_vec, source_cluster)
            clusters_new = state.clusters.clone()
            clusters_new[ar, i_src, obj] = out
            clusters_new[ar, i_tgt, obj] = into
            obj_idx = obj[:, None]
            valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
            rs = cond.gibbs_resample_source_jump_rows(
                gen, state, clusters_new, obj_idx, valid, i_cluster_new=i_tgt,
                i_cluster_old=i_src, counts=counts)
            src_obj = gather_rows(state.source, obj_idx, self.consts.C)          # (B, 1, F, C)
            cl_new, conf_new, ll_d = self._delta_counts(
                counts, obj, state.clusters, clusters_new, src_obj[:, 0], rs.new_rows[:, 0])
            pat_new = self._delta_pat(
                state.pat_counts, obj_idx, valid, state.clusters[ar, :, obj].any(-1)[:, None],
                clusters_new[ar, :, obj].any(-1)[:, None], src_obj, rs.new_rows)
            state_new = state._replace(
                clusters=clusters_new, pat_counts=pat_new, cl_counts=cl_new, conf_counts=conf_new,
                geo_agg=self._update_geo(state.geo_agg, clusters_new, i_src, i_tgt))

            # The reverse move: the object jumps back from the target.
            pjb = (self._jump_probability(state_new, (cl_new, conf_new), i_tgt, i_src, logspace)
                   if informed else ones)
            pjb_vec = torch.where(_pick_cluster(clusters_new, i_tgt), pjb, zero)
            p_jump_back = pjb_vec / torch.clamp(pjb_vec.sum(-1, keepdim=True), min=TINY)

            log_q = torch.log(torch.clamp(p_jump[ar, obj], min=TINY)) + rs.log_q
            log_q_back = torch.log(torch.clamp(p_jump_back[ar, obj], min=TINY)) + rs.log_q_back
            log_q, log_q_back, sp_d, ll_d = _reject_where(
                rejected, log_q, log_q_back, rs.source_prior_delta, ll_d)
            rows = (torch.where(rejected, N, obj)[:, None], rs.new_rows)
            return OpResult(state_new, log_q, log_q_back, torch.ones(B, device=dev),
                            source_prior_delta=sp_d, ll_delta=ll_d, source_rows=rows)

        return op

    # ==================================================================
    # GibbsSampleSource
    # ==================================================================

    def make_gibbs_sample_source(self, object_selector: str, max_size: int) -> Callable:
        """Resample the source of a random subset, of a random group's
        members (at most ``max_size`` objects), or of all objects. The
        capped selectors draw their rows at once with an MH correction
        (``op_rows``), or, where ``source_sweep`` (F >= 512) and outside
        prior mode, one object after the other from its exact leave-self-out
        conditional (``op_rows_sweep``: always accepted, as its log_q is the
        Gibbs sentinel -inf, and it returns its exact likelihood delta). All
        objects: over the model's feature tiles."""
        cond = self.cond
        consts = self.consts
        N, K, C = consts.N, consts.K, consts.C
        n_conf = len(consts.conf_names)
        if N <= 10:
            object_selector = "all"
        if object_selector == "all" and hasattr(cond, "split"):
            raise NotImplementedError("the source resample of all objects does not run on a "
                                      "chains x objects grid (nor does a split of 10 objects "
                                      "or fewer)")
        k_cap = min(max_size, N)
        # Per component (the clusters, then each confounder): its number of
        # groups and its first row in the stacked memberships of a group draw.
        n_groups = torch.tensor([K] + [int(n) for n in consts.n_groups], device=consts.device)
        offsets = torch.tensor([0] + [K + i * consts.Gmax for i in range(n_conf)],
                               device=consts.device)

        def select_subset_idx(gen, state):
            """(obj_idx (B, k), valid (B, k)): distinct indices per chain."""
            B = state.n_chains
            dev = state.clusters.device
            if object_selector == "random_subset":
                perm = torch.argsort(torch.rand((B, N), generator=gen, device=dev), dim=-1)
                return perm[:, :k_cap], torch.ones((B, k_cap), dtype=torch.bool, device=dev)
            comp = torch.randint(0, 1 + n_conf, (B,), generator=gen, device=dev)
            g_idx = torch.randint(0, 10 ** 9, (B,), generator=gen, device=dev) % n_groups[comp]
            stacked = torch.cat([state.clusters, (consts.groups > 0).reshape(1, -1, N)
                                 .expand(B, -1, -1)], dim=1)                   # (B, K + n_conf*G, N)
            member = stacked[torch.arange(B, device=dev), offsets[comp] + g_idx]
            scores = torch.where(member, _gumbel(gen, (B, N), dev),
                                 torch.full((), NEG_INF, device=dev))
            top_vals, top_idx = torch.topk(scores, k_cap, dim=-1)
            return top_idx, torch.isfinite(top_vals)

        def posterior_probs(state, counts, sl):
            if self.sample_from_prior:
                w = normalize_weights(state.weights[:, sl],
                                      cond.post.has_components(state.clusters))
                return normalize(cond.heat_prior(w))
            return cond.source_posterior(state.clusters, state.weights, state.source,
                                         counts=counts, sl=sl)

        def op_rows(gen, state):
            counts_old = self._state_counts(state)
            obj_idx, valid = select_subset_idx(gen, state)
            feats_m, na_m, hc_conf_m = cond.gather_obj(obj_idx)
            old_rows = gather_rows(state.source, obj_idx, C)
            hc_m = cond.rows_availability(state.clusters, obj_idx, hc_conf_m)
            if self.sample_from_prior:
                p = normalize(cond.heat_prior(normalize_weights(state.weights, hc_m)))
            else:
                p = cond.source_posterior_rows(state.clusters, state.weights, counts_old,
                                               obj_idx, feats_m, na_m, hc_conf_m)
            x = sample_categorical_onehot(gen, p) & ~na_m[..., None]
            new_rows = torch.where(valid[:, :, None, None], x, old_rows)
            log_q = cond._rows_logp(p, new_rows, valid, na_m)
            counts_new = cond.delta_counts_rows(counts_old, state.clusters, obj_idx, valid,
                                                old_rows, new_rows, feats_m)
            hc0 = hc_m[..., 0]
            pat_new = self._delta_pat(state.pat_counts, obj_idx, valid, hc0, hc0, old_rows,
                                      new_rows)
            state_new = state._replace(pat_counts=pat_new, cl_counts=counts_new[0],
                                       conf_counts=counts_new[1])
            if self.sample_from_prior:
                p_back = p
            else:
                p_back = cond.source_posterior_rows(state.clusters, state.weights, counts_new,
                                                    obj_idx, feats_m, na_m, hc_conf_m)
            log_q_back = cond._rows_logp(p_back, old_rows, valid, na_m)
            sp_delta = (cond.source_prior_rows_logp(state.weights, hc_m, new_rows, valid, na_m)
                        - cond.source_prior_rows_logp(state.weights, hc_m, old_rows, valid,
                                                      na_m))
            step_size = ((new_rows ^ old_rows) & valid[:, :, None, None]).sum((1, 2, 3)).float()
            idx = torch.where(valid, obj_idx, N)
            return OpResult(state_new, log_q, log_q_back, step_size,
                            source_prior_delta=sp_delta, source_rows=(idx, new_rows))

        def op_rows_sweep(gen, state):
            """Exact sequential Gibbs over the selected objects (the JAX
            package's ``op_rows_sweep``): one object after the other, batched
            over chains, from its leave-self-out collapsed conditional (its
            cells factor over features), with the carried counts updated
            between objects; the exact log-likelihood change of each
            sub-step is the log ratio of the new and old cells' predictive
            values, which the conditional already holds."""
            B = state.n_chains
            ar = torch.arange(B, device=state.clusters.device)
            cl_counts, conf_counts = (x.clone() for x in self._state_counts(state))
            obj_idx, valid = select_subset_idx(gen, state)
            feats_m, na_m, hc_conf_m = cond.gather_obj(obj_idx)
            old_rows = gather_rows(state.source, obj_idx, C)                 # (B, k, F, C)
            mem = gather_cols(state.clusters, obj_idx)                        # (B, K, k)
            hc0 = mem.any(1)
            hc_m = torch.cat([hc0[..., None], hc_conf_m], dim=-1)
            w_heat = cond.heat_prior(normalize_weights(state.weights, hc_m))  # (B, k, F, C)
            k_of = mem.to(torch.uint8).argmax(1)                              # (B, k)
            g_of = torch.clamp(consts.group_idx.long()[:, torch.clamp(obj_idx, max=N - 1)],
                               min=0)                                         # (C-1, B, k)
            rows = old_rows.clone()
            ll_delta = torch.zeros(B, device=ar.device)
            tiny = torch.full((), TINY, device=ar.device)
            for j in range(obj_idx.shape[1]):
                f_o = feats_m[:, j]                                           # (B, F, S)
                row_old = rows[:, j].float()                                  # (B, F, C)
                v = valid[:, j].float()[:, None, None]
                na_j = na_m[:, j]
                in_comp = [hc0[:, j].float()[:, None, None] * v] + [
                    hc_conf_m[:, j, i].float()[:, None, None] * v for i in range(n_conf)]
                count_rows = [(cl_counts, (ar, k_of[:, j]), consts.conc_cluster)] + [
                    (conf_counts, (ar, i, g_of[i, :, j]), consts.conc_conf[i, g_of[i, :, j]])
                    for i in range(n_conf)]
                lh = torch.stack([
                    (normalize(counts[at] - f_o * row_old[..., i:i + 1] * in_comp[i] + conc)
                     * f_o).sum(-1)
                    for i, (counts, at, conc) in enumerate(count_rows)], dim=-1)  # (B, F, C)
                lh = torch.where(na_j[..., None], torch.ones((), device=lh.device), lh)
                p = normalize(cond.heat_lh(lh) * w_heat[:, j])
                new_row = sample_categorical_onehot(gen, p) & ~na_j[..., None]
                new_row = torch.where(valid[:, j, None, None], new_row, rows[:, j])
                nr = new_row.float()
                ok = (~na_j) & valid[:, j, None]
                d_j = (torch.log(torch.maximum((lh * nr).sum(-1), tiny))
                       - torch.log(torch.maximum((lh * row_old).sum(-1), tiny)))
                ll_delta = ll_delta + torch.where(ok, d_j, torch.zeros((), device=d_j.device)
                                                  ).sum(-1)
                for i, (counts, at, _) in enumerate(count_rows):
                    counts[at] += f_o * (nr[..., i:i + 1] - row_old[..., i:i + 1]) * in_comp[i]
                rows[:, j] = new_row
            pat_new = self._delta_pat(state.pat_counts, obj_idx, valid, hc0, hc0, old_rows, rows)
            state_new = state._replace(pat_counts=pat_new, cl_counts=cl_counts,
                                       conf_counts=conf_counts)
            sp_delta = (cond.source_prior_rows_logp(state.weights, hc_m, rows, valid, na_m)
                        - cond.source_prior_rows_logp(state.weights, hc_m, old_rows, valid,
                                                      na_m))
            step_size = ((rows ^ old_rows) & valid[:, :, None, None]).sum((1, 2, 3)).float()
            return OpResult(state_new, torch.full((B,), NEG_INF, device=ar.device),
                            torch.zeros(B, device=ar.device), step_size,
                            source_prior_delta=sp_delta, ll_delta=ll_delta,
                            source_rows=(torch.where(valid, obj_idx, N), rows))

        def op_all(gen, state):
            counts_old = self._state_counts(state)
            every = torch.ones((state.n_chains, N), dtype=torch.bool,
                               device=state.clusters.device)
            new_tiles, log_q = [], []
            for sl in feature_tiles(consts.F, consts.feature_chunk):
                p = posterior_probs(state, counts_old, sl)
                na = consts.na[:, sl]
                x = sample_categorical_onehot(gen, p) & ~na[None, :, :, None]
                new_tiles.append(pack_source(x) if consts.source_packed else x)
                log_q.append(cond._masked_logp(p, new_tiles[-1], every, na))
            source_new = cat_tiles(new_tiles, dim=2)
            cl, conf = cond.post.feature_counts(state.clusters, source_new)
            pat_new = (None if state.pat_counts is None
                       else cond.post.pattern_counts(state.clusters, source_new))
            state_new = state._replace(source=source_new, pat_counts=pat_new, cl_counts=cl,
                                       conf_counts=conf)
            log_q_back = add_tiles([
                cond._masked_logp(posterior_probs(state_new, (cl, conf), sl),
                                  state.source[:, :, sl], every, consts.na[:, sl])
                for sl in feature_tiles(consts.F, consts.feature_chunk)])
            return OpResult(state_new, add_tiles(log_q), log_q_back,
                            source_n_changed(source_new, state.source))

        if object_selector == "all":
            return op_all
        return op_rows_sweep if self.sweeps(object_selector) else op_rows

    # ==================================================================
    # GibbsSampleWeights: per-feature independent MH on two components
    # ==================================================================

    def make_gibbs_sample_weights(self) -> Callable:
        cond = self.cond
        consts = self.consts
        C, F = consts.C, consts.F
        pat_bits = consts.pat_bits                                           # (P, C)

        def source_lh_by_feature(cnt, weights):
            """(B, F) source log-likelihood from the pattern counts."""
            logw = torch.log(torch.clamp(weights, min=TINY))
            z = torch.einsum("pc,bfc->bpf", pat_bits, weights)
            logz = torch.log(torch.clamp(z, min=TINY))
            return (torch.einsum("bpfc,bfc->bf", cnt, logw)
                    - torch.einsum("bpf,bpf->bf", cnt.sum(-1), logz))

        def beta_logpdf(x, a, b):
            betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
            return (a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x) - betaln

        def op(gen, state):
            B = state.n_chains
            dev = state.weights.device
            ar = torch.arange(B, device=dev)
            w = state.weights
            cnt = state.pat_counts
            if cnt is None:
                cnt = cond.post.pattern_counts(state.clusters, state.source)
            ll_old = source_lh_by_feature(cnt, w)
            lp_old = cond.post.weights_prior_pointwise(w)

            pair = torch.argsort(torch.rand((B, C), generator=gen, device=dev), dim=-1)
            i1, i2 = pair[:, 0], pair[:, 1]
            both = (pat_bits[:, i1] * pat_bits[:, i2]).T                         # (B, P)
            counts = torch.einsum("bp,bpfc->bfc", both, cnt) + consts.conc_weights[None]
            tp = per_chain(self.Tp, counts[:, :, 0])                           # (B, 1) or float
            c1 = counts[ar, :, i1] / tp
            c2 = counts[ar, :, i2] / tp
            a_beta, b_beta = 1.0 + c2, 1.0 + c1
            ga = torch._standard_gamma(a_beta, generator=gen)
            gb = torch._standard_gamma(b_beta, generator=gen)
            a2 = torch.clamp(ga / (ga + gb), 1e-7, 1 - 1e-7)

            w02 = w[ar, :, i1] + w[ar, :, i2]
            w_new = w.clone()
            w_new[ar, :, i1] = (1 - a2) * w02
            w_new[ar, :, i2] = a2 * w02
            w_new = normalize(w_new)

            a2_old = torch.clamp(w[ar, :, i2] / torch.clamp(w02, min=TINY), 1e-7, 1 - 1e-7)
            log_q = beta_logpdf(a2, a_beta, b_beta)
            log_q_back = beta_logpdf(a2_old, a_beta, b_beta)
            ll_new = source_lh_by_feature(cnt, w_new)
            lp_new = cond.post.weights_prior_pointwise(w_new)

            p_accept = torch.exp((ll_new + lp_new - ll_old - lp_old + log_q_back - log_q) / tp)
            accept = torch.rand((B, F), generator=gen, device=dev) < p_accept
            weights_final = torch.where(accept[..., None], w_new, w)
            sp_delta = torch.where(accept, ll_new - ll_old, torch.zeros((), device=dev)).sum(-1)
            return OpResult(state._replace(weights=weights_final),
                            torch.full((B,), NEG_INF, device=dev), torch.zeros(B, device=dev),
                            accept.float().mean(-1), source_prior_delta=sp_delta)

        return op

    # ==================================================================
    # AlterWeights: a Dirichlet move of two components of one feature
    # ==================================================================

    def make_alter_weights(self, step_precision: float = 15.0) -> Callable:
        """Per chain, a random feature and a random ordered pair of distinct
        components: their share of the feature's weight is redrawn from a
        Dirichlet centred on the current share (concentration ``1 +
        step_precision * share``), the draw clipped to [1e-7, 1 - 1e-7] and
        renormalised."""
        C, F = self.consts.C, self.consts.F

        def op(gen, state):
            B = state.n_chains
            dev = state.weights.device
            ar = torch.arange(B, device=dev)
            f_id = torch.randint(0, F, (B,), generator=gen, device=dev)
            i1, i2 = _random_cluster_pair(gen, B, C, dev)
            w = state.weights
            w_curr = torch.stack([w[ar, f_id, i1], w[ar, f_id, i2]], dim=-1)   # (B, 2)
            w_sum = w_curr.sum(-1, keepdim=True)
            w_t = w_curr / w_sum
            alpha = 1 + step_precision * w_t
            g = torch._standard_gamma(alpha, generator=gen)
            w_new_t = torch.clamp(g / g.sum(-1, keepdim=True), 1e-7, 1 - 1e-7)
            w_new_t = w_new_t / w_new_t.sum(-1, keepdim=True)
            log_q = dirichlet_logpdf(w_new_t, alpha)
            log_q_back = dirichlet_logpdf(w_t, 1 + step_precision * w_new_t)
            w_new = w_new_t * w_sum
            weights = w.clone()
            weights[ar, f_id, i1] = w_new[:, 0]
            weights[ar, f_id, i2] = w_new[:, 1]
            step_size = (weights - w).abs().sum((1, 2))
            return OpResult(state._replace(weights=weights), log_q, log_q_back, step_size)

        return op


class OperatorSpec(NamedTuple):
    name: str
    weight: float
    fn: Callable
    changes: str = "clusters"
    parameters: dict = {}
    graphable: bool = True
    sweep: bool = False
    """``changes``: the state group the operator can modify ('clusters',
    'source' or 'weights'); the MH kernel recomputes only those terms.
    ``graphable``: the step reads nothing from the host, so that a CUDA
    graph can replay it (``sampling/graphs.py``). ``sweep``: the step is the
    sequential source sweep (``op_rows_sweep``), run in the span
    ``sbt.sweep``."""


def get_operator_schedule(cond: Conditionals, operators_config,
                          p_grow: float = 0.5) -> list[OperatorSpec]:
    """The scheduled operators with the JAX package's names and weights
    (normalized): the cluster share splits 0.025 / 0.025 / 0.025 / 0.025 /
    0.6 / 0.05 / 0.25 over the naive, Gibbsish, wide and jump operators (the
    jump only with more than one cluster), the source share 0.4 / 0.6 over
    the random-subset and per-group resamples. Under a cost-based geo prior
    the main Gibbsish and the wide operator weight their proposals by it;
    the naive operators never do, whatever their names. No CUDA graph
    replays the wide operator (its redraw loop reads the card), nor, under
    the Delaunay skeleton (computed on the host), any cluster operator."""
    factory = OperatorFactory(cond, p_grow=p_grow)
    consts = cond.consts
    geo_on = consts.geo.prior_type == "cost_based"
    host_geo = cond.post.carry_geo and skeleton_of(consts.geo) == "delaunay"
    w_c = operators_config.clusters
    w_w = operators_config.weights
    w_s = operators_config.source

    ops = [
        OperatorSpec("cluster_naive_n1", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=False, neighbourhood="direct"),
                     "clusters", {"neighbours": "direct", "gibbsish": False}),
        OperatorSpec("cluster_naive_n1_geo", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=False, neighbourhood="direct"),
                     "clusters", {"neighbours": "direct", "gibbsish": False}),
        OperatorSpec("cluster_naive_n2_geo", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=False, neighbourhood="twostep"),
                     "clusters", {"neighbours": "twostep", "gibbsish": False}),
        OperatorSpec("cluster_gibbsish", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=True, neighbourhood="everywhere"),
                     "clusters"),
        OperatorSpec("cluster_gibbsish_geo", 0.6 * w_c,
                     factory.make_alter_cluster(gibbsish=True, neighbourhood="everywhere",
                                                consider_geo=geo_on),
                     "clusters", {"geo": geo_on}),
        OperatorSpec("gibbsish_sample_cluster_wide_geo", 0.05 * w_c,
                     factory.make_alter_cluster_wide(consider_geo=geo_on),
                     "clusters", {"geo": geo_on, "w_stay": 0.15}, graphable=False),
        OperatorSpec("cluster_jump_gibbsish", 0.25 * w_c if consts.K > 1 else 0.0,
                     factory.make_cluster_jump(gibbsish=True),
                     "clusters"),
        OperatorSpec("gibbs_sample_sources", 0.4 * w_s,
                     factory.make_gibbs_sample_source("random_subset", max_size=20),
                     "source", {"object_selector": "RANDOM_SUBSET", "max_step_size": 20},
                     sweep=factory.sweeps("random_subset")),
        OperatorSpec("gibbs_sample_sources_groups", 0.6 * w_s,
                     factory.make_gibbs_sample_source("groups", max_size=30),
                     "source", {"object_selector": "GROUPS", "max_step_size": 30},
                     sweep=factory.sweeps("groups")),
        OperatorSpec("gibbs_sample_weights", 1.0 * w_w,
                     factory.make_gibbs_sample_weights(),
                     "weights"),
    ]
    ops = [o for o in ops if o.weight > 0]
    total = sum(o.weight for o in ops)
    return [o._replace(weight=o.weight / total,
                       graphable=o.graphable and not (host_geo and o.changes == "clusters"))
            for o in ops]
