"""Initial samples: initial clusters, refinement, best of attempts.

Port of ``sbayes_tpu/sampling/initializer.py``, batched over chains. The
initial clusters come from one of three methods: ``em`` (annealed EM over
clusters and confounder groups, with the geo term under a cost-based geo
prior, and a discretization with a per-cluster minimum size and a
truncated-normal total size), ``seed_points`` (one random object per
cluster) or ``random_growth`` (each cluster grown from a random free seed by
``initial_size - 1`` random steps to a free neighbour; a cluster without a
free neighbour stops growing, as in the JAX package). Then a prior source
draw followed by a full Gibbs source step, two rounds of ML cluster steps
with a weights re-estimate between them, and the best of ``attempts`` by
likelihood (the likelihood kernel on CUDA). The prior source draw runs over
the model's feature tiles, and the source is stored in the model's form
(packed int8 at scale), as in the JAX package.

The EM's group log-likelihoods are one contraction over (feature, state) of
the log effect table with the one-hot features, (n, G, N) in memory, and its
geo term multiplies the cost matrix by the K cluster rows only. The JAX
package computes the same numbers from a gathered (n, G, N, F) table, 272 GB
for 640 attempt-chains at Grambank's 2,467 objects x 195 features in 215
families, and from a geo product over all G = 221 rows, 44 times the K rows'.

At many features the clusters' responsibilities underflow and the JAX
package's discretization leaves clusters below the minimum size (ROADMAP
C.4): the port draws such chains anew from the log responsibilities
(``Initializer._in_bounds``). Where the attempt-chains' full-width tensors
would pass ``BATCH_BYTES``, the chains are initialised in batches, each
chain's attempts in one (``Initializer.chains_per_batch``).

Spans ``sbt.init/em`` (the EM and its discretization) and ``sbt.init/refine``
(the source passes, the ML cluster steps and the best of attempts); the
module's ``record`` keeps what the last ``generate_sample`` measured.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from sbayes_tpu_torch.model.math import (
    cat_tiles,
    feature_tiles,
    normalize,
    normalize_weights,
    pack_source,
    sample_categorical_onehot,
    source_comp,
)
from sbayes_tpu_torch.sampling.conditionals import Conditionals
from sbayes_tpu_torch.sampling.operators import OperatorFactory, _gumbel
from sbayes_tpu_torch.sampling.state import ChainState
from sbayes_tpu_torch.tracing import span


@dataclasses.dataclass
class InitRecord:
    """What the last ``Initializer.generate_sample`` measured. ``em_s``: host
    seconds of the EM and its discretization, synchronised at its end on CUDA
    (None under the other methods). ``peak_bytes``:
    ``torch.cuda.max_memory_allocated()`` at the end of the init, read without
    a reset, so the peak since the caller's last reset (None on the CPU)."""

    em_s: Optional[float] = None
    peak_bytes: Optional[int] = None


record = InitRecord()

# The most bytes one float32 (attempt-chains, N, F, C) tensor of a batch of
# the init may take (``Initializer.chains_per_batch``): 8 GiB, so that
# grambank_k5's 640 attempt-chains (3.7 GB) start in one batch and
# phoible_k5's 320 (26.7 GB) in four.
BATCH_BYTES = 1 << 33


def _truncnorm_sample(gen, n, mid, lower, upper, scale, device):
    """(n,) truncated-normal draws by inverse CDF."""
    a = torch.special.ndtr(torch.tensor((lower - mid) / scale, device=device))
    b = torch.special.ndtr(torch.tensor((upper - mid) / scale, device=device))
    u = a + (b - a) * torch.rand(n, generator=gen, device=device)
    return mid + scale * torch.special.ndtri(u)


class Initializer:
    def __init__(self, cond: Conditionals, initial_size: int, attempts: int,
                 initial_cluster_steps: bool = True, n_em_steps: int = 50, method: str = "em"):
        self.method = method
        self.cond = cond
        self.consts = cond.consts
        self.initial_size = int(initial_size)
        self.attempts = int(attempts)
        self.initial_cluster_steps = bool(initial_cluster_steps)
        self.n_em_steps = int(n_em_steps)

        self.factory = OperatorFactory(cond)
        self.full_source_op = self.factory.make_gibbs_sample_source("all", max_size=10 ** 9)
        self.ml_step = self.factory.make_ml_cluster_step(consider_geo=True)

        c = self.consts
        rows = [torch.ones((c.K, c.N), dtype=torch.bool, device=c.device)]
        for i_c in range(len(c.conf_names)):
            rows.append(c.groups[i_c, :int(c.n_groups[i_c])] > 0)
        self.groups_available = torch.cat(rows, dim=0)               # (G_all, N)

    def generate_clusters_em(self, gen, n: int):
        """(n, K, N) initial clusters from annealed EM; sets ``record.em_s``."""
        t0 = time.perf_counter()
        c = self.consts
        dev = c.device
        N, K = c.N, c.K
        with span("sbt.init/em"):
            avail = self.groups_available
            total_size = _truncnorm_sample(
                gen, n, mid=float(K * self.initial_size), lower=float(K * c.min_size),
                upper=float(min(N, K * c.max_size)),
                scale=float(max(20.0, K * self.initial_size - K * c.min_size)), device=dev)
            total_size = torch.clamp(torch.round(total_size).long(), K * c.min_size, N)

            z = torch.rand((n, avail.shape[0], N), generator=gen, device=dev) * avail
            z = z / torch.clamp(z.sum(1, keepdim=True), min=1e-35)
            lh = None
            for i_step in range(self.n_em_steps):
                lh = self.em_logits(z, i_step)
                z = torch.softmax(lh, dim=1)
                if i_step < self.n_em_steps - 1:
                    lh = None
            clusters = self._discretize_fuzzy_clusters(z, total_size)
            clusters = self._in_bounds(clusters, self._log_responsibilities(z, lh), total_size)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record.em_s = time.perf_counter() - t0
        return clusters

    def em_step(self, z, i_step: int):
        """One annealed EM step of the (n, G, N) responsibilities ``z`` over
        the K clusters and the G - K valid confounder groups."""
        return torch.softmax(self.em_logits(z, i_step), dim=1)

    def em_logits(self, z, i_step: int):
        """The (n, G, N) logits of ``em_step``: the annealed group
        log-likelihoods with the geo term, -inf at unavailable groups."""
        c = self.consts
        N, K = c.N, c.K
        n, G = z.shape[:2]
        state_counts = torch.einsum("bgn,nfs->bgfs", z, c.features)
        log_p = torch.log(torch.clamp(normalize(state_counts + 0.5 * c.applicable.float()),
                                      min=1e-35))
        # sum_f log p[f, x_nf] as a product with the one-hot rows; an NA row
        # is all zeros and adds log sum_s p = log 1 = 0.
        group_lls = (log_p.reshape(n * G, -1) @ c.features.reshape(N, -1).T).view(n, G, N)
        lh = group_lls / (self.n_em_steps / (1.0 + i_step)) ** 3
        if c.geo.prior_type == "cost_based":
            # Geo term: the mean cost from each object to a cluster's
            # (sharpened) members; confounder groups get the clusters' mean.
            avg_dist = torch.softmax(N * z[:, :K], dim=2) @ c.cost_matrix
            log_geo = -avg_dist / c.geo.scale / 2.0
            mean_cluster_geo = (torch.logsumexp(log_geo.reshape(n, -1), dim=-1)
                                - math.log(K * N))
            lh[:, :K] += log_geo
            lh[:, K:] += mean_cluster_geo[:, None, None]
        return torch.where(self.groups_available, lh, torch.full((), float("-inf"),
                                                                 device=z.device))

    def _log_responsibilities(self, z, lh):
        """(n, K, N) log responsibilities of the clusters after the EM:
        ``log z`` from the last step's logits ``lh``, finite where ``z``
        underflows to 0. Each object's largest responsibility (at least 1 /
        G) gives the normaliser: log z_k = lh_k - lh_max + log z_max."""
        K = self.consts.K
        if lh is None:
            return torch.log(z[:, :K])
        z_max, g_max = z.max(dim=1, keepdim=True)
        return lh[:, :K] - lh.gather(1, g_max) + torch.log(z_max)

    def _in_bounds(self, clusters, log_z, total_size):
        """``clusters`` (n, K, N) where each of a chain's clusters holds at
        least ``min_size`` objects; every other chain's clusters drawn anew
        from the log responsibilities ``log_z`` (n, K, N): each cluster in
        turn takes the ``min_size`` objects most likely in it among those not
        yet taken, then the free objects, most likely first, each join their
        most likely cluster while it holds fewer than ``max_size``, up to
        ``total_size`` objects in all.

        ``_discretize_fuzzy_clusters`` (the JAX package's) ranks objects by
        the responsibilities themselves. At many features those of the
        clusters underflow to 0, and a cluster's top objects tie with the
        ones an earlier cluster was guaranteed: it takes them, the earlier
        cluster ends below ``min_size``, and the chain starts with one
        cluster of nearly every object and the others empty (ROADMAP C.4),
        which no operator moves into bounds. Only such chains are drawn
        anew; a cluster above ``max_size`` beside clusters of at least
        ``min_size`` is left as the JAX package leaves it, and every other
        chain keeps its clusters bit for bit."""
        c = self.consts
        K, N, dev = c.K, c.N, log_z.device
        ok = (clusters.sum(-1) >= c.min_size).all(-1)
        n = clusters.shape[0]
        neg_inf = torch.full((), float("-inf"), device=dev)
        taken = torch.zeros((n, N), dtype=torch.bool, device=dev)
        best = torch.full((n, N), K, dtype=torch.long, device=dev)
        for i_c in range(K):
            ids = torch.topk(torch.where(taken, neg_inf, log_z[:, i_c]), c.min_size,
                             dim=-1).indices
            taken.scatter_(1, ids, True)
            best.scatter_(1, ids, i_c)
        value, choice = torch.where(taken[:, None], neg_inf, log_z).max(dim=1)      # (n, N)
        order = torch.argsort(value, dim=-1, descending=True)
        choice = choice.gather(1, order)
        # Each free object's place among those of its cluster, in this order.
        onehot = torch.nn.functional.one_hot(choice, K)
        place = (onehot.cumsum(1) * onehot).sum(-1) - 1
        room = (place < c.max_size - c.min_size) & ~taken.gather(1, order)
        join = room & (room.cumsum(1) <= (total_size - K * c.min_size)[:, None])
        best.scatter_(1, order, torch.where(join, choice, best.gather(1, order)))
        drawn = torch.nn.functional.one_hot(best, K + 1)[..., :K].permute(0, 2, 1).bool()
        return torch.where(ok[:, None, None], clusters, drawn)

    def generate_clusters_seed_points(self, gen, n: int):
        """(n, K, N) clusters of one random object each, distinct per chain;
        the ML cluster steps grow them to the minimum size."""
        c = self.consts
        seeds = torch.argsort(torch.rand((n, c.N), generator=gen, device=c.device),
                              dim=-1)[:, :c.K]
        clusters = torch.zeros((n, c.K, c.N), dtype=torch.bool, device=c.device)
        return clusters.scatter_(2, seeds[..., None], True)

    def generate_clusters_random_growth(self, gen, n: int):
        """(n, K, N) clusters, each grown from a random free seed by
        ``initial_size - 1`` grow steps: an (n, N) x (N, N) adjacency product
        and a Gumbel-max pick among the free neighbours. A cluster without a
        free neighbour stops growing."""
        c = self.consts
        dev = c.device
        ar = torch.arange(n, device=dev)
        adj = c.adjacency.float()
        neg_inf = torch.full((), float("-inf"), device=dev)
        clusters = torch.zeros((n, c.K, c.N), dtype=torch.bool, device=dev)
        occupied = torch.zeros((n, c.N), dtype=torch.bool, device=dev)

        def pick(candidates):
            return torch.argmax(torch.where(candidates, _gumbel(gen, (n, c.N), dev), neg_inf),
                                dim=-1)

        for i_c in range(c.K):
            seed = pick(~occupied)
            cluster = torch.zeros((n, c.N), dtype=torch.bool, device=dev)
            cluster[ar, seed] = True
            occupied[ar, seed] = True
            for _ in range(self.initial_size - 1):
                neigh = ((cluster.float() @ adj.T) > 0) & ~occupied
                can_grow = neigh.any(-1)
                j = pick(neigh)
                cluster[ar, j] |= can_grow
                occupied[ar, j] |= can_grow
            clusters[:, i_c] = cluster
        return clusters

    def generate_initial_clusters(self, gen, n: int):
        if self.method == "seed_points":
            return self.generate_clusters_seed_points(gen, n)
        if self.method == "random_growth":
            return self.generate_clusters_random_growth(gen, n)
        return self.generate_clusters_em(gen, n)

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

    def prior_source(self, gen, clusters, weights):
        """A source drawn from the normalized weights, NA cells empty, in the
        model's form, over the feature tiles."""
        c = self.consts
        hc = self.cond.post.has_components(clusters)
        tiles = []
        for sl in feature_tiles(c.F, c.feature_chunk):
            x = (sample_categorical_onehot(gen, normalize_weights(weights[:, sl], hc))
                 & ~c.na[None, :, sl, None])
            tiles.append(pack_source(x) if c.source_packed else x)
        return cat_tiles(tiles, dim=2)

    def generate_sample_attempt(self, gen, n: int) -> ChainState:
        """(n,) independent initial states."""
        clusters = self.generate_initial_clusters(gen, n)
        with span("sbt.init/refine"):
            return self.refine(gen, clusters)

    def refine(self, gen, clusters) -> ChainState:
        """States from initial ``clusters``: a prior source draw, a full Gibbs
        source pass, and with ``initial_cluster_steps`` the ML cluster steps
        around a weights re-estimate and a second source pass."""
        c = self.consts
        cond = self.cond
        dev = c.device
        n = clusters.shape[0]
        weights = torch.full((n, c.F, c.C), 1.0 / c.C, device=dev)
        source = self.prior_source(gen, clusters, weights)
        minus_inf = torch.full((n,), float("-inf"), device=dev)
        state = ChainState(clusters, weights, source, minus_inf, minus_inf,
                           torch.full((n, 4), float("-inf"), device=dev))

        state = self.full_source_op(gen, state).state
        if self.initial_cluster_steps:
            for i_c in range(c.K):
                state = self.ml_step(gen, state, i_c)
            # Re-estimate the weights from the source ratios.
            hc = cond.post.has_components(state.clusters).float()
            s_counts = torch.stack([source_comp(state.source, i).sum(1) for i in range(c.C)],
                                   dim=-1).float()                         # (n, F, C)
            s_ratio = s_counts / torch.clamp(hc.sum(1, keepdim=True), min=1e-35)
            state = state._replace(weights=normalize(1.0 + s_ratio))
            state = self.full_source_op(gen, state).state
            for i_c in range(c.K):
                state = self.ml_step(gen, state, i_c)
        return state

    def chains_per_batch(self, n_chains: int) -> int:
        """Chains whose attempts are initialised together: all of them while
        one float32 (attempt-chains, N, F, C) tensor stays within
        ``BATCH_BYTES``, else as few even batches as keep it there (the
        init's temporaries of the source and its feature tiles scale with
        the attempt-chains of a batch)."""
        c = self.consts
        per_chain = 4 * self.attempts * c.N * c.F * c.C
        n_batches = -(-n_chains * per_chain // BATCH_BYTES)
        return -(-n_chains // max(1, n_batches))

    def generate_sample(self, gen, n_chains: int) -> ChainState:
        """Best of ``attempts`` initial samples per chain, by likelihood, in
        batches of ``chains_per_batch`` chains (each chain's attempts in one
        batch); fills ``record``."""
        record.em_s = record.peak_bytes = None
        per = self.chains_per_batch(n_chains)
        parts, em_s = [], None
        for lo in range(0, n_chains, per):
            parts.append(self._best_of_attempts(gen, min(per, n_chains - lo)))
            if record.em_s is not None:
                em_s = (em_s or 0.0) + record.em_s
        record.em_s = em_s
        states = parts[0] if len(parts) == 1 else ChainState.concat(parts)
        if states.clusters.device.type == "cuda":
            record.peak_bytes = int(torch.cuda.max_memory_allocated(states.clusters.device))
        return states

    def _best_of_attempts(self, gen, n_chains: int) -> ChainState:
        A = self.attempts
        clusters = self.generate_initial_clusters(gen, n_chains * A)
        with span("sbt.init/refine"):
            states = self.refine(gen, clusters)
            lh = self.cond.post.log_likelihood(states).view(n_chains, A)
            best = lh.argmax(dim=1) + torch.arange(n_chains, device=lh.device) * A
            return states.select(best)
