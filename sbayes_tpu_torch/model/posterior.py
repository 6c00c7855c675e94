"""The posterior of a batch of chains: likelihood, priors, carried counts.

Port of ``sbayes_tpu/model/posterior.py``. Every chain-state tensor has a
leading chain axis ``B``; every result is per chain, shape ``(B,)``.
``log_likelihood`` runs the collapsed-likelihood kernel (``ops/loglh.py``)
for CUDA tensors. The port supports the uniform geo prior only (0) so far.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from sbayes_tpu_torch.model.constants import ModelConstants
from sbayes_tpu_torch.model.math import (
    compute_feature_counts,
    dirichlet_categorical_logpdf,
    dirichlet_logpdf,
    normalize_weights,
    source_pick,
)
from sbayes_tpu_torch.ops import loglh


class PosteriorParts(NamedTuple):
    """Decomposition of the posterior (columns of the stats file), (B,) each."""

    log_lh: torch.Tensor
    size_prior: torch.Tensor
    geo_prior: torch.Tensor
    weights_prior: torch.Tensor
    source_prior: torch.Tensor

    @property
    def log_prior(self):
        return self.size_prior + self.geo_prior + self.weights_prior + self.source_prior

    def prior_vector(self):
        """(B, 4) [size, geo, weights, source] — ChainState.prior_parts order."""
        return torch.stack([self.size_prior, self.geo_prior, self.weights_prior,
                            self.source_prior], dim=-1)


class Posterior:
    """Likelihood and priors of a model, evaluated for a batch of chains."""

    def __init__(self, consts: ModelConstants, sample_from_prior: bool = False):
        if consts.geo.prior_type != "uniform":
            raise NotImplementedError(
                f"geo prior `{consts.geo.prior_type}` is not ported yet (cost-based geo "
                "prior slice)")
        self.consts = consts
        self.sample_from_prior = sample_from_prior

    # ---------------- mixture components ----------------

    def feature_counts(self, clusters, source):
        """(B, K, F, S) cluster counts and (B, C-1, Gmax, F, S) confounder counts."""
        c = self.consts
        return compute_feature_counts(clusters, source, c.features, c.groups)

    def log_likelihood_from_counts(self, cluster_counts, conf_counts):
        c = self.consts
        lh_cl = dirichlet_categorical_logpdf(cluster_counts, c.conc_cluster[None, None])
        lh_conf = dirichlet_categorical_logpdf(conf_counts, c.conc_conf[None])
        return lh_cl.sum((-1, -2)) + lh_conf.sum((-1, -2, -3))

    def log_likelihood_diff_from_counts(self, counts_new, counts_old):
        """Exact ``log_likelihood_from_counts(new) - (old)`` per chain.

        Diff-then-sum: the lgamma argument stacks of both count sets are
        built identically, so unchanged count cells give bitwise-identical
        terms whose difference is exactly 0 and the result carries only the
        true change — never the difference of two large totals. The
        lgamma(a) / lgamma(sum_a) constants cancel and are not computed."""
        c = self.consts
        a_cl = c.conc_cluster[None, None]        # (1, 1, F, S)
        a_conf = c.conc_conf[None]               # (1, C-1, G, F, S)

        def stack(cl, conf):
            B = cl.shape[0]
            one = torch.ones((), dtype=cl.dtype, device=cl.device)
            cells_cl = torch.where(a_cl > 0, cl + a_cl, one)
            cells_conf = torch.where(a_conf > 0, conf + a_conf, one)
            tot_cl = cl.sum(-1) + a_cl.sum(-1)
            tot_conf = conf.sum(-1) + a_conf.sum(-1)
            return (torch.cat([cells_cl.reshape(B, -1), cells_conf.reshape(B, -1)], 1),
                    torch.cat([tot_cl.reshape(B, -1), tot_conf.reshape(B, -1)], 1))

        cells_new, tot_new = stack(*counts_new)
        cells_old, tot_old = stack(*counts_old)
        return ((torch.lgamma(cells_new) - torch.lgamma(cells_old)).sum(-1)
                - (torch.lgamma(tot_new) - torch.lgamma(tot_old)).sum(-1))

    def log_likelihood(self, state):
        """(B,) collapsed log-likelihood recomputed from clusters and source:
        the CUDA kernel for CUDA tensors, its plain version on the CPU."""
        return loglh.log_likelihood(self.consts, state.clusters, state.source)

    # ---------------- weights ----------------

    def has_components(self, clusters):
        """(B, N, C) availability of each mixture component at each object."""
        c = self.consts
        hc0 = clusters.any(dim=1)
        return torch.cat([hc0[:, :, None], c.hc_conf[None].expand(hc0.shape[0], -1, -1)], dim=2)

    # ---------------- availability-pattern source counts ----------------

    def source_patterns(self, clusters):
        """(B, N) pattern id: static confounder pattern + any-cluster bit."""
        c = self.consts
        n_static = c.pat_bits.shape[0] // 2
        return c.static_pat[None] + clusters.any(dim=1).long() * n_static

    def pattern_counts(self, clusters, source):
        """(B, P, F, C) source counts per availability pattern (exact)."""
        c = self.consts
        P = c.pat_bits.shape[0]
        pat_oh = torch.nn.functional.one_hot(self.source_patterns(clusters), P).float()
        return torch.einsum("bnp,bnfc->bpfc", pat_oh, source.float())

    # ---------------- priors ----------------

    def size_prior(self, clusters):
        """(B,) cluster-size prior."""
        c = self.consts
        sizes = clusters.sum(-1).float()                       # (B, K)
        if c.size_prior_type == "uniform_area":
            return torch.zeros(sizes.shape[0], device=sizes.device)
        if c.size_prior_type == "uniform_size":
            n = torch.tensor(float(c.N), device=sizes.device)
            rest = n - sizes.sum(-1)
            log_multinom = (torch.lgamma(n + 1.0) - torch.lgamma(sizes + 1.0).sum(-1)
                            - torch.lgamma(rest + 1.0))
            return -log_multinom
        if c.size_prior_type == "quadratic":
            return -torch.log(sizes ** 2).sum(-1)
        raise ValueError(f"Unknown size prior type {c.size_prior_type}")

    def geo_prior_per_cluster(self, clusters):
        """(B, K) geo-prior log-probabilities: 0 under the uniform geo prior."""
        return torch.zeros(clusters.shape[:2], device=clusters.device)

    def weights_prior(self, weights):
        """(B,) Dirichlet prior on the mixture weights."""
        if self.consts.weights_prior_uniform:
            return torch.zeros(weights.shape[0], device=weights.device)
        return self.weights_prior_pointwise(weights).sum(-1)

    def weights_prior_pointwise(self, weights):
        """(B, F) per-feature weights prior."""
        return dirichlet_logpdf(weights, self.consts.conc_weights[None].expand_as(weights))

    def source_prior(self, clusters, weights, source):
        """(B,) log P(source | weights)."""
        c = self.consts
        w = normalize_weights(weights, self.has_components(clusters))
        p = source_pick(w, source)                              # (B, N, F)
        valid = ~c.na[None]
        return torch.where(valid, torch.log(torch.where(valid, p, torch.ones_like(p))),
                           torch.zeros_like(p)).sum((-1, -2))

    # ---------------- bundles ----------------

    def parts(self, state, counts=None) -> PosteriorParts:
        """Full posterior decomposition; ``counts`` may pass the state's
        carried counts (else the likelihood is recomputed by the kernel)."""
        B = state.clusters.shape[0]
        if self.sample_from_prior:
            log_lh = torch.zeros(B, device=state.clusters.device)
        elif counts is not None:
            log_lh = self.log_likelihood_from_counts(*counts)
        else:
            log_lh = self.log_likelihood(state)
        return PosteriorParts(
            log_lh=log_lh,
            size_prior=self.size_prior(state.clusters),
            geo_prior=self.geo_prior_per_cluster(state.clusters).sum(-1),
            weights_prior=self.weights_prior(state.weights),
            source_prior=self.source_prior(state.clusters, state.weights, state.source),
        )

    def fill_state(self, state):
        """The state with log_lh / log_prior / prior_parts and the carried
        counts and pattern counts recomputed exactly."""
        counts = self.feature_counts(state.clusters, state.source)
        p = self.parts(state, counts=counts)
        return state._replace(
            log_lh=p.log_lh, log_prior=p.log_prior, prior_parts=p.prior_vector(),
            cl_counts=counts[0], conf_counts=counts[1], geo_agg=None,
            pat_counts=self.pattern_counts(state.clusters, state.source),
        )
