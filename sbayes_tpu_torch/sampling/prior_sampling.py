"""Samples from the prior, batched.

Port of ``sbayes_tpu/sampling/prior_sampling.py``:
  * clusters: a uniform component label per object ("no cluster"
    included), redrawn for the states whose sizes leave the bounds (at most
    10 000 rounds),
  * weights: Dirichlet draws from the weights prior's concentration,
  * source: a categorical draw from each object's normalized weights.

``generate_prior_samples`` fills in the log-likelihood (the likelihood
kernel on CUDA) and the geo prior: the importance weights of a posterior
estimate from prior samples are ``exp(log_lh + geo_prior)``, since the
proposal covers every other prior factor.
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.model.math import normalize_weights, sample_categorical_onehot
from sbayes_tpu_torch.sampling.conditionals import Conditionals
from sbayes_tpu_torch.sampling.state import ChainState

MAX_ROUNDS = 10_000


def generate_prior_clusters(gen, cond: Conditionals, n: int):
    """(n, K, N) uniform-label clusters, each state redrawn until every
    cluster size lies within the bounds (at most ``MAX_ROUNDS`` rounds)."""
    c = cond.consts
    K, N = c.K, c.N

    def draw():
        labels = torch.randint(0, K + 1, (n, N), generator=gen, device=c.device)
        return torch.nn.functional.one_hot(labels, K + 1)[..., :K].permute(0, 2, 1).bool()

    def out_of_bounds(clusters):
        sizes = clusters.sum(-1)
        return ((sizes < c.min_size) | (sizes > c.max_size)).any(-1)

    clusters = draw()
    bad = out_of_bounds(clusters)
    for _ in range(MAX_ROUNDS):
        if not bool(bad.any()):
            break
        clusters = torch.where(bad[:, None, None], draw(), clusters)
        bad = out_of_bounds(clusters)
    return clusters


def generate_prior_sample(gen, cond: Conditionals, n: int) -> ChainState:
    """(n,) states drawn from the prior; no posterior terms filled in."""
    c = cond.consts
    clusters = generate_prior_clusters(gen, cond, n)
    g = torch._standard_gamma(c.conc_weights[None].expand(n, -1, -1).contiguous(),
                              generator=gen)
    weights = g / g.sum(-1, keepdim=True)                                   # (n, F, C)
    w_normed = normalize_weights(weights, cond.post.has_components(clusters))
    source = cond.post.source_form(sample_categorical_onehot(gen, w_normed)
                                   & ~c.na[None, :, :, None])
    minus_inf = torch.full((n,), float("-inf"), device=c.device)
    return ChainState(clusters, weights, source, minus_inf, minus_inf,
                      torch.full((n, 4), float("-inf"), device=c.device))


def generate_prior_samples(gen, cond: Conditionals, n_samples: int) -> ChainState:
    """``n_samples`` prior samples with ``log_lh`` (the collapsed
    likelihood) and ``log_prior`` (the geo prior) filled in."""
    state = generate_prior_sample(gen, cond, n_samples)
    return state._replace(log_lh=cond.post.log_likelihood(state),
                          log_prior=cond.post.geo_prior_per_cluster(state.clusters).sum(-1))
