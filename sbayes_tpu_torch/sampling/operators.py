"""The MCMC operators of the default schedule, batched over chains.

Port of the scheduled K = 1 operators of ``sbayes_tpu/sampling/operators.py``: grow/shrink
(naive and Gibbsish), the wide membership resample, the initializer's ML
cluster step, source Gibbs resampling (random subset, groups, all) and the
weights Gibbs step. Each operator is ``op(gen, state) -> OpResult`` on a
batch of chains; one operator runs for the whole batch per step. Sentinel
transition probabilities force acceptance (Gibbs: log_q = -inf,
log_q_back = 0) or rejection (log_q = 0, log_q_back = -inf).

The membership marginal of the Gibbsish operators runs the CUDA kernel of
``ops/marginal.py`` on CUDA tensors (``_marginal_impl``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from sbayes_tpu_torch.model.math import (
    compact_indices,
    dirichlet_categorical_delta,
    gather_cols,
    gather_rows,
    normalize,
    normalize_weights,
    sample_categorical_onehot,
)
from sbayes_tpu_torch.ops.marginal import marginal
from sbayes_tpu_torch.sampling.conditionals import EPS32, Conditionals, _pick_cluster
from sbayes_tpu_torch.sampling.state import ChainState

TINY = 1e-35
NEG_INF = float("-inf")


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


def _heat_prob(p, temperature):
    """p**(1/T) / (p**(1/T) + (1-p)**(1/T)) via logits (stable)."""
    logit = torch.log(torch.clamp(p, min=TINY)) - torch.log(torch.clamp(1.0 - p, min=TINY))
    return torch.sigmoid(logit / temperature)


def _reject_where(rejected, log_q, log_q_back, *deltas):
    """Apply the forced-reject sentinels (and zero deltas) on rejected chains."""
    zero = torch.zeros((), device=log_q.device)
    out = [torch.where(rejected, zero, log_q),
           torch.where(rejected, torch.full((), NEG_INF, device=log_q.device), log_q_back)]
    return out + [None if d is None else torch.where(rejected, zero, d) for d in deltas]


class OperatorFactory:
    """Builds the batched operator suite for one model and temperature."""

    def __init__(self, cond: Conditionals, p_grow: float = 0.5):
        self.cond = cond
        self.consts = cond.consts
        self.T = cond.T
        self.Tp = cond.Tp
        self.sample_from_prior = cond.sample_from_prior
        self.p_grow = p_grow

    # ==================================================================
    # Shared cluster-posterior math
    # ==================================================================

    def _state_counts(self, state):
        if state.cl_counts is None:
            return self.cond.post.feature_counts(state.clusters, state.source)
        return state.cl_counts, state.conf_counts

    def _marginal_impl(self, state, i_cluster, counts, heat_effect_lh, ratio):
        """Collapsed membership marginals of every object for cluster
        ``i_cluster`` (B,): the signed log-odds (B, N) when ``ratio``, else
        (log_m0, log_m1). The kernel of ``ops/marginal.py``."""
        c = self.consts
        cl_counts, conf_counts = self._state_counts(state) if counts is None else counts
        hc = self.cond.post.has_components(state.clusters)
        hc_flip = hc.clone()
        hc_flip[..., 0] = ~hc[..., 0]
        use_heat = heat_effect_lh and self.T != 1.0
        unif = c.unif_conc[None]
        p_eff = normalize(unif + (c.conc_cluster[None] - unif) / self.Tp
                          + _pick_cluster(cl_counts, i_cluster) / self.T)       # (B, F, S)
        conf_eff = normalize(conf_counts + c.conc_conf[None])
        p_rows = p_eff[:, None] if ratio else torch.stack([p_eff, p_eff], dim=1)
        B = p_eff.shape[0]
        inv_t = (torch.full((B,), 1.0 / self.T, device=p_eff.device) if use_heat else None)
        out = marginal(c, p_rows.contiguous(), conf_eff, state.weights ** (1.0 / self.Tp),
                       hc.float(), hc_flip.float(), hc[..., 0].float(), inv_t, ratio=ratio)
        if ratio:
            return out / self.T
        return out[..., 0] / self.T, out[..., 1] / self.T

    def _cluster_log_odds(self, state, i_cluster, counts=None, heat_effect_lh=False):
        """(B, N) signed log-odds log_m1 - log_m0 of cluster membership."""
        return self._marginal_impl(state, i_cluster, counts, heat_effect_lh, ratio=True)

    def _log_marginal_with_without(self, state, i_cluster, counts=None, heat_effect_lh=False):
        """(log_m0, log_m1): absolute log-marginals without / with membership."""
        return self._marginal_impl(state, i_cluster, counts, heat_effect_lh, ratio=False)

    def _cluster_posterior(self, state, i_cluster, gibbsish=True, counts=None,
                           additive_smoothing=1e-6, heat_effect_lh=False):
        """(B, N) membership probability of each object."""
        B, N = state.clusters.shape[0], self.consts.N
        if self.sample_from_prior or not gibbsish:
            return torch.full((B, N), 0.5, device=state.clusters.device)
        odds = self._cluster_log_odds(state, i_cluster, counts, heat_effect_lh)
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
        feats_o = c.features[obj]                                              # (B, F, S)
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

    def make_alter_cluster(self, gibbsish: bool, neighbourhood: str) -> Callable:
        """Grow or shrink one cluster by one object.

        Divergence from the JAX package: there the proposal densities always
        carry log p_grow / log p_shrink and only a move FROM a bound size is
        corrected (-log 2 on log_q_back), so a move INTO a bound size (the
        reverse of which is forced) is accepted half as often as detailed
        balance asks: under the prior, bound sizes are sampled at half their
        probability (tests/test_torch_slice.py). Here both directions use the
        probability the operator really gives them."""
        cond = self.cond
        K, N = self.consts.K, self.consts.N
        min_size, max_size = self.consts.min_size, self.consts.max_size
        p_grow, T = self.p_grow, self.T
        lp_grow, lp_shrink = math.log(p_grow), math.log1p(-p_grow)

        def log_p_direction(size, grow):
            """log P(the operator picks this direction at this cluster size):
            forced (log 1) at the size bounds, else log p_grow / p_shrink."""
            forced = torch.where(grow, size == min_size, size == max_size)
            return torch.where(forced, 0.0, torch.where(grow, lp_grow, lp_shrink))

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
            p_post = _heat_prob(self._cluster_posterior(state, i_cluster, gibbsish, counts), T)
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
            src_obj = gather_rows(state.source, obj_idx)                       # (B, 1, F, C)
            cl_new, conf_new, ll_d = self._delta_counts(
                counts, obj, state.clusters, clusters_new, src_obj[:, 0], rs.new_rows[:, 0])
            counts_new = (cl_new, conf_new)
            pat_new = self._delta_pat(
                state.pat_counts, obj_idx, valid, state.clusters[ar, :, obj].any(-1)[:, None],
                clusters_new[ar, :, obj].any(-1)[:, None], src_obj, rs.new_rows)
            state_new = state._replace(clusters=clusters_new, pat_counts=pat_new,
                                       cl_counts=cl_new, conf_counts=conf_new)

            back_grow_cand = self._grow_candidates(clusters_new, i_cluster, neighbourhood)
            rejected = rejected | (~do_grow & ~back_grow_cand[ar, obj])
            new_cluster = _pick_cluster(clusters_new, i_cluster)
            p_back = _heat_prob(self._cluster_posterior(state_new, i_cluster, gibbsish,
                                                        counts_new), T)
            pb_vec = torch.where(do_grow[:, None], torch.where(new_cluster, 1.0 - p_back, zero),
                                 torch.where(back_grow_cand, p_back, zero))
            p_bwd = pb_vec / torch.clamp(pb_vec.sum(-1), min=TINY)[:, None]

            # The direction probabilities of both moves, forced ones included:
            # the reverse of a move INTO a bound size is forced as well.
            size_new = size + torch.where(do_grow, 1, -1)
            log_q = (torch.log(torch.clamp(p_fwd[ar, obj], min=TINY)) + rs.log_q
                     + log_p_direction(size, do_grow))
            log_q_back = (torch.log(torch.clamp(p_bwd[ar, obj], min=TINY)) + rs.log_q_back
                          + log_p_direction(size_new, ~do_grow))
            log_q, log_q_back, sp_d, ll_d = _reject_where(
                rejected, log_q, log_q_back, rs.source_prior_delta, ll_d)
            rows = (torch.where(rejected, N, obj)[:, None], rs.new_rows)
            return OpResult(state_new, log_q, log_q_back, torch.ones(B, device=dev),
                            source_prior_delta=sp_d, ll_delta=ll_d, source_rows=rows)

        return op

    # ==================================================================
    # AlterClusterWide: resample the whole membership vector of one cluster
    # ==================================================================

    def _make_wide_cluster_probs(self, w_stay: float, eps: float) -> Callable:
        """(B, N) Bernoulli proposal probabilities of the wide operator:
        the posterior mixed with the current cluster, rescaled so the
        expected proposal size matches the current size."""

        def cluster_probs(state, i_cluster, avail, counts=None):
            cluster = _pick_cluster(state.clusters, i_cluster)
            availf = avail.float()
            p_raw = self._cluster_posterior(state, i_cluster, counts=counts,
                                            additive_smoothing=0.0, heat_effect_lh=True)
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

    def make_alter_cluster_wide(self, w_stay: float = 0.15, eps: float = None) -> Callable:
        """Resample the full membership of one cluster (redraw until the
        proposal differs, at most 100 rounds) with a gathered-rows source
        resample over the changed objects."""
        cond = self.cond
        K, N = self.consts.K, self.consts.N
        min_size, max_size = self.consts.min_size, self.consts.max_size
        if eps is None:
            eps = 0.01 / N
        cluster_probs = self._make_wide_cluster_probs(w_stay, eps)

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
                if not bool(same.any()):
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
            # Every changed object is resampled (the scale path's row cap,
            # which auto-rejects moves above it, is not ported yet).
            obj_idx = compact_indices(changed, N, N)
            valid = torch.arange(N, device=dev)[None] < m[:, None]
            src_rows_old = gather_rows(state.source, obj_idx)
            rs = cond.gibbs_resample_source_rows(gen, state, clusters_new, obj_idx, valid,
                                                 i_cluster, counts)
            feats_m = cond.gather_obj(obj_idx)[0]
            counts_new = cond.delta_counts_rows_move(counts, state.clusters, clusters_new,
                                                     obj_idx, valid, src_rows_old, rs.new_rows,
                                                     feats_m)
            pat_new = self._delta_pat(
                state.pat_counts, obj_idx, valid, gather_cols(state.clusters, obj_idx).any(1),
                gather_cols(clusters_new, obj_idx).any(1), src_rows_old, rs.new_rows)
            state_new = state._replace(clusters=clusters_new, pat_counts=pat_new,
                                       cl_counts=counts_new[0], conf_counts=counts_new[1])

            p_back = cluster_probs(state_new, i_cluster, avail, counts_new)
            log_q_back = site_logp(p_back, cluster_old) - torch.log1p(
                -torch.clamp(torch.exp(site_logp(p_back, cluster_new)), max=1 - 1e-7))

            log_q, log_q_back, sp_d = _reject_where(
                rejected, log_q + rs.log_q, log_q_back + rs.log_q_back, rs.source_prior_delta)
            rows = (torch.where(rejected[:, None], N, obj_idx), rs.new_rows)
            return OpResult(state_new, log_q, log_q_back, m.float(), source_prior_delta=sp_d,
                            source_rows=rows)

        return op

    def make_ml_cluster_step(self, w_stay: float = 0.1, eps: float = 1e-6) -> Callable:
        """Deterministic maximum-likelihood cluster step of the initializer:
        threshold the wide proposal probabilities at the current size.
        Returns ``step(gen, state, i_cluster)`` for an int ``i_cluster``."""
        cond = self.cond
        consts = self.consts
        cluster_probs = self._make_wide_cluster_probs(w_stay, eps)

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
            state_new = state._replace(clusters=clusters_new, source=rs.source)
            if state.cl_counts is not None:
                cl, conf = cond.post.feature_counts(clusters_new, rs.source)
                state_new = state_new._replace(cl_counts=cl, conf_counts=conf)
            if state.pat_counts is not None:
                state_new = state_new._replace(
                    pat_counts=cond.post.pattern_counts(clusters_new, rs.source))
            return state_new

        return ml_step

    # ==================================================================
    # GibbsSampleSource
    # ==================================================================

    def make_gibbs_sample_source(self, object_selector: str, max_size: int) -> Callable:
        """Resample the source of a random subset, of a random group's
        members (at most ``max_size`` objects), or of all objects."""
        cond = self.cond
        consts = self.consts
        N, K = consts.N, consts.K
        n_conf = len(consts.conf_names)
        if N <= 10:
            object_selector = "all"
        k_cap = min(max_size, N)
        if object_selector != "all" and consts.F >= 512 and not self.sample_from_prior:
            raise NotImplementedError(
                "the sequential source sweep used at F >= 512 is not ported yet (scale-path slice)")

        def select_subset_idx(gen, state):
            """(obj_idx (B, k), valid (B, k)): distinct indices per chain."""
            B = state.n_chains
            dev = state.clusters.device
            if object_selector == "random_subset":
                perm = torch.argsort(torch.rand((B, N), generator=gen, device=dev), dim=-1)
                return perm[:, :k_cap], torch.ones((B, k_cap), dtype=torch.bool, device=dev)
            comp = torch.randint(0, 1 + n_conf, (B,), generator=gen, device=dev)
            n_groups = torch.tensor([K] + [int(n) for n in consts.n_groups], device=dev)
            g_idx = torch.randint(0, 10 ** 9, (B,), generator=gen, device=dev) % n_groups[comp]
            offsets = torch.tensor([0] + [K + i * consts.Gmax for i in range(n_conf)], device=dev)
            stacked = torch.cat([state.clusters, (consts.groups > 0).reshape(1, -1, N)
                                 .expand(B, -1, -1)], dim=1)                   # (B, K + n_conf*G, N)
            member = stacked[torch.arange(B, device=dev), offsets[comp] + g_idx]
            scores = torch.where(member, _gumbel(gen, (B, N), dev),
                                 torch.full((), NEG_INF, device=dev))
            top_vals, top_idx = torch.topk(scores, k_cap, dim=-1)
            return top_idx, torch.isfinite(top_vals)

        def posterior_probs(state, counts):
            if self.sample_from_prior:
                w = normalize_weights(state.weights, cond.post.has_components(state.clusters))
                return normalize(w ** (1.0 / self.Tp))
            return cond.source_posterior(state.clusters, state.weights, state.source,
                                         counts=counts)

        def op_rows(gen, state):
            counts_old = self._state_counts(state)
            obj_idx, valid = select_subset_idx(gen, state)
            feats_m, na_m, hc_conf_m = cond.gather_obj(obj_idx)
            old_rows = gather_rows(state.source, obj_idx)
            hc_m = cond.rows_availability(state.clusters, obj_idx, hc_conf_m)
            if self.sample_from_prior:
                p = normalize(normalize_weights(state.weights, hc_m) ** (1.0 / self.Tp))
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

        def op_all(gen, state):
            counts_old = self._state_counts(state)
            p = posterior_probs(state, counts_old)
            source_new = sample_categorical_onehot(gen, p) & ~consts.na[None, :, :, None]
            every = torch.ones(source_new.shape[:2], dtype=torch.bool, device=p.device)
            log_q = cond._masked_logp(p, source_new, every, consts.na)
            cl, conf = cond.post.feature_counts(state.clusters, source_new)
            pat_new = (None if state.pat_counts is None
                       else cond.post.pattern_counts(state.clusters, source_new))
            state_new = state._replace(source=source_new, pat_counts=pat_new, cl_counts=cl,
                                       conf_counts=conf)
            p_back = posterior_probs(state_new, (cl, conf))
            log_q_back = cond._masked_logp(p_back, state.source, every, consts.na)
            step_size = (source_new ^ state.source).sum((1, 2, 3)).float()
            return OpResult(state_new, log_q, log_q_back, step_size)

        return op_all if object_selector == "all" else op_rows

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
            c1 = counts[ar, :, i1] / self.Tp
            c2 = counts[ar, :, i2] / self.Tp
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

            p_accept = torch.exp((ll_new + lp_new - ll_old - lp_old + log_q_back - log_q) / self.Tp)
            accept = torch.rand((B, F), generator=gen, device=dev) < p_accept
            weights_final = torch.where(accept[..., None], w_new, w)
            sp_delta = torch.where(accept, ll_new - ll_old, torch.zeros((), device=dev)).sum(-1)
            return OpResult(state._replace(weights=weights_final),
                            torch.full((B,), NEG_INF, device=dev), torch.zeros(B, device=dev),
                            accept.float().mean(-1), source_prior_delta=sp_delta)

        return op


class OperatorSpec(NamedTuple):
    name: str
    weight: float
    fn: Callable
    changes: str = "clusters"
    parameters: dict = {}
    """``changes``: the state group the operator can modify ('clusters',
    'source' or 'weights'); the MH kernel recomputes only those terms."""


def get_operator_schedule(cond: Conditionals, operators_config,
                          p_grow: float = 0.5) -> list[OperatorSpec]:
    """The scheduled operators with the JAX package's weights (normalized).

    The inter-cluster jump (weight 0 at K = 1) and the cost-based geo
    variants belong to a later slice."""
    factory = OperatorFactory(cond, p_grow=p_grow)
    consts = cond.consts
    if consts.K > 1:
        raise NotImplementedError(
            "K >= 2 needs the cluster jump operator, which is not ported yet (K >= 2 slice)")
    w_c = operators_config.clusters
    w_w = operators_config.weights
    w_s = operators_config.source
    geo_on = False   # the uniform geo prior: no geo-weighted proposals

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
                     factory.make_alter_cluster(gibbsish=True, neighbourhood="everywhere"),
                     "clusters", {"geo": geo_on}),
        OperatorSpec("gibbsish_sample_cluster_wide_geo", 0.05 * w_c,
                     factory.make_alter_cluster_wide(),
                     "clusters", {"geo": geo_on, "w_stay": 0.15}),
        OperatorSpec("gibbs_sample_sources", 0.4 * w_s,
                     factory.make_gibbs_sample_source("random_subset", max_size=20),
                     "source", {"object_selector": "RANDOM_SUBSET", "max_step_size": 20}),
        OperatorSpec("gibbs_sample_sources_groups", 0.6 * w_s,
                     factory.make_gibbs_sample_source("groups", max_size=30),
                     "source", {"object_selector": "GROUPS", "max_step_size": 30}),
        OperatorSpec("gibbs_sample_weights", 1.0 * w_w,
                     factory.make_gibbs_sample_weights(),
                     "weights"),
    ]
    ops = [o for o in ops if o.weight > 0]
    total = sum(o.weight for o in ops)
    return [o._replace(weight=o.weight / total) for o in ops]
