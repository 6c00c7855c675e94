"""Initial samples: annealed EM soft clustering, refinement, best of attempts.

Port of the ``em`` method of ``sbayes_tpu/sampling/initializer.py``,
batched over chains: annealed EM over clusters and confounder groups, a
discretization with a per-cluster minimum size and a truncated-normal total
size, a prior source draw followed by a full Gibbs source step, two rounds of
ML cluster steps with a weights re-estimate between them, and the best of
``attempts`` by likelihood (the likelihood kernel on CUDA).
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.model.math import normalize, normalize_weights, sample_categorical_onehot
from sbayes_tpu_torch.sampling.conditionals import Conditionals
from sbayes_tpu_torch.sampling.operators import OperatorFactory
from sbayes_tpu_torch.sampling.state import ChainState


def _truncnorm_sample(gen, n, mid, lower, upper, scale, device):
    """(n,) truncated-normal draws by inverse CDF."""
    a = torch.special.ndtr(torch.tensor((lower - mid) / scale, device=device))
    b = torch.special.ndtr(torch.tensor((upper - mid) / scale, device=device))
    u = a + (b - a) * torch.rand(n, generator=gen, device=device)
    return mid + scale * torch.special.ndtri(u)


class Initializer:
    def __init__(self, cond: Conditionals, initial_size: int, attempts: int,
                 initial_cluster_steps: bool = True, n_em_steps: int = 50, method: str = "em"):
        if method != "em":
            raise NotImplementedError(
                f"initializer method `{method}` is not ported yet (only `em`)")
        self.cond = cond
        self.consts = cond.consts
        self.initial_size = int(initial_size)
        self.attempts = int(attempts)
        self.initial_cluster_steps = bool(initial_cluster_steps)
        self.n_em_steps = int(n_em_steps)

        self.factory = OperatorFactory(cond)
        self.full_source_op = self.factory.make_gibbs_sample_source("all", max_size=10 ** 9)
        self.ml_step = self.factory.make_ml_cluster_step()

        c = self.consts
        rows = [torch.ones((c.K, c.N), dtype=torch.bool, device=c.device)]
        for i_c in range(len(c.conf_names)):
            rows.append(c.groups[i_c, :int(c.n_groups[i_c])] > 0)
        self.groups_available = torch.cat(rows, dim=0)               # (G_all, N)

    def generate_clusters_em(self, gen, n: int):
        """(n, K, N) initial clusters from annealed EM."""
        c = self.consts
        dev = c.device
        N, K = c.N, c.K
        avail = self.groups_available
        G = avail.shape[0]
        total_size = _truncnorm_sample(
            gen, n, mid=float(K * self.initial_size), lower=float(K * c.min_size),
            upper=float(min(N, K * c.max_size)),
            scale=float(max(20.0, K * self.initial_size - K * c.min_size)), device=dev)
        total_size = torch.clamp(torch.round(total_size).long(), K * c.min_size, N)

        prior_counts = 0.5 * c.applicable.float()
        z = torch.rand((n, G, N), generator=gen, device=dev) * avail
        z = z / torch.clamp(z.sum(1, keepdim=True), min=1e-35)
        f_ar = torch.arange(c.F, device=dev)[None]
        feat_idx = c.feat_idx.long()                                    # (N, F), S = NA

        for i_step in range(self.n_em_steps):
            state_counts = torch.einsum("bgn,nfs->bgfs", z, c.features)
            p = normalize(state_counts + prior_counts)
            # NA observations count as "any state": their term is sum_s p.
            p_obs = torch.cat([p, p.sum(-1, keepdim=True)], dim=-1)[:, :, f_ar, feat_idx]
            group_lls = torch.log(torch.clamp(p_obs, min=1e-35)).sum(-1)   # (n, G, N)
            temperature = (self.n_em_steps / (1.0 + i_step)) ** 3
            lh = torch.where(avail, group_lls / temperature,
                             torch.full((), float("-inf"), device=dev))
            z = torch.softmax(lh, dim=1)
        return self._discretize_fuzzy_clusters(z, total_size)

    def _discretize_fuzzy_clusters(self, z, total_size):
        """Discretize soft assignments with a min-size guarantee."""
        c = self.consts
        K, N = c.K, c.N
        n = z.shape[0]
        fuzzy = z[:, :K].clone()
        for i_c in range(K):
            best_ids = torch.topk(fuzzy[:, i_c], c.min_size, dim=-1).indices
            col = torch.zeros((n, N), dtype=torch.bool, device=z.device)
            col.scatter_(1, best_ids, True)
            fuzzy = torch.where(col[:, None], torch.zeros((), device=z.device), fuzzy)
            fuzzy[:, i_c] = torch.where(col, torch.ones((), device=z.device), fuzzy[:, i_c])
        best_value, best = fuzzy.max(dim=1)
        sorted_vals = torch.sort(best_value, dim=-1).values
        threshold = sorted_vals[torch.arange(n, device=z.device),
                                torch.clamp(N - total_size, min=0)]
        best = torch.where(best_value < threshold[:, None], K, best)
        return torch.nn.functional.one_hot(best, K + 1)[..., :K].permute(0, 2, 1).bool()

    def generate_sample_attempt(self, gen, n: int) -> ChainState:
        """(n,) independent initial states."""
        c = self.consts
        cond = self.cond
        dev = c.device
        clusters = self.generate_clusters_em(gen, n)
        weights = torch.full((n, c.F, c.C), 1.0 / c.C, device=dev)
        w_normed = normalize_weights(weights, cond.post.has_components(clusters))
        source = sample_categorical_onehot(gen, w_normed) & ~c.na[None, :, :, None]
        minus_inf = torch.full((n,), float("-inf"), device=dev)
        state = ChainState(clusters, weights, source, minus_inf, minus_inf,
                           torch.full((n, 4), float("-inf"), device=dev))

        state = self.full_source_op(gen, state).state
        if self.initial_cluster_steps:
            for i_c in range(c.K):
                state = self.ml_step(gen, state, i_c)
            # Re-estimate the weights from the source ratios.
            hc = cond.post.has_components(state.clusters).float()
            s_counts = state.source.float().sum(1)                        # (n, F, C)
            s_ratio = s_counts / torch.clamp(hc.sum(1, keepdim=True), min=1e-35)
            state = state._replace(weights=normalize(1.0 + s_ratio))
            state = self.full_source_op(gen, state).state
            for i_c in range(c.K):
                state = self.ml_step(gen, state, i_c)
        return state

    def generate_sample(self, gen, n_chains: int) -> ChainState:
        """Best of ``attempts`` initial samples per chain, by likelihood."""
        A = self.attempts
        states = self.generate_sample_attempt(gen, n_chains * A)
        lh = self.cond.post.log_likelihood(states).view(n_chains, A)
        best = lh.argmax(dim=1) + torch.arange(n_chains, device=lh.device) * A
        return states.select(best)
