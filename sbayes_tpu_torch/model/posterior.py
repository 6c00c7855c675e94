"""The posterior of a batch of chains: likelihood, priors, carried counts.

Port of ``sbayes_tpu/model/posterior.py``. Every chain-state tensor has a
leading chain axis ``B``; every result is per chain, shape ``(B,)``.
``log_likelihood`` runs the collapsed-likelihood kernel (``ops/loglh.py``)
for CUDA tensors.

The geo prior of a cluster is a function of its skeleton's aggregate, the
triple [total, n_edges, max_edge] (``skeleton_triple``: the MST by the
batched Prim of ``ops/mst.py``, the complete graph, or the Delaunay graph on
the host). The triples are carried in ``ChainState.geo_agg`` (B, K, 3) and
re-derived only for the clusters an operator changed, so the MH step maps
the carried triples (``geo_prior_from_agg``) instead of running K MSTs. The
masked reductions over the (N, N) cost matrix (each object's cheapest edge
to a cluster, the complete graph's longest edge) run over tiles of cost rows
(``auto_cost_row_tile``), where XLA fuses them in the JAX package: no
(B, N, N) temporary at scale.

The source may be bool one-hot or packed int8 (``ModelConstants.
source_packed``); with ``ModelConstants.feature_chunk`` the counts, pattern
counts and the source prior run over feature tiles (JAX ``feature_tile`` /
``lax.map``), so no (B, N, F, ...) intermediate is built at scale.

``ObjectSplitPosterior`` is the posterior of a chain shard whose objects are
split over blocks (``parallel/mesh.py``): the counts come from the
likelihood kernel's ``loglh_counts`` on each block, the pattern counts and
the source prior from each block's own ``Posterior``, all added on the head
in block order; the log-likelihood from the summed counts through
``loglh_from_counts``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sbayes_tpu_torch.model.constants import ModelConstants, auto_cost_row_tile
from sbayes_tpu_torch.model.math import (
    add_tiles,
    cat_tiles,
    compute_feature_counts,
    dirichlet_logpdf,
    feature_tiles,
    normalize_weights,
    pack_source,
    source_comp,
    source_is_packed,
    source_onehot,
    source_pick,
)
from sbayes_tpu_torch.ops import loglh
from sbayes_tpu_torch.ops.mst import cluster_mst_stats, update_mst_stats, update_rows
from sbayes_tpu_torch.tracing import span


def skeleton_of(geo) -> str:
    """The skeleton whose aggregates a geo prior takes (the simulated type
    always takes the MST)."""
    return "mst" if geo.prior_type == "simulated" else geo.skeleton


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
        self.consts = consts
        self.sample_from_prior = sample_from_prior

    # ---------------- mixture components ----------------

    def feature_counts(self, clusters, source):
        """(B, K, F, S) cluster counts and (B, C-1, Gmax, F, S) confounder counts."""
        c = self.consts
        return compute_feature_counts(clusters, source, c.features, c.groups, c.feature_chunk)

    def source_form(self, source):
        """``source`` (either form) in the form the model's states hold."""
        if self.consts.source_packed:
            return source if source_is_packed(source) else pack_source(source)
        return source_onehot(source, self.consts.C)

    def log_likelihood_from_counts(self, cluster_counts, conf_counts):
        """(B,) likelihood of the counts: the Dirichlet-categorical log-pdf
        (the plain version of the likelihood kernel's ``loglh_from_counts``)."""
        return loglh.loglh_from_counts_plain(self.consts, cluster_counts, conf_counts)

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
        tiles = [torch.stack([torch.einsum("bnp,bnf->bpf", pat_oh,
                                           source_comp(source[:, :, sl], i, torch.float32))
                              for i in range(c.C)], dim=-1)
                 for sl in feature_tiles(c.F, c.feature_chunk)]
        return cat_tiles(tiles, dim=2)

    # ---------------- priors ----------------

    def size_prior(self, clusters):
        """(B,) cluster-size prior."""
        c = self.consts
        sizes = clusters.sum(-1).float()                       # (B, K)
        if c.size_prior_type == "uniform_area":
            return torch.zeros(sizes.shape[0], device=sizes.device)
        if c.size_prior_type == "uniform_size":
            n = torch.full((), float(c.N), device=sizes.device)
            rest = n - sizes.sum(-1)
            log_multinom = (torch.lgamma(n + 1.0) - torch.lgamma(sizes + 1.0).sum(-1)
                            - torch.lgamma(rest + 1.0))
            return -log_multinom
        if c.size_prior_type == "quadratic":
            return -torch.log(sizes ** 2).sum(-1)
        raise ValueError(f"Unknown size prior type {c.size_prior_type}")

    # ---------------- geo prior ----------------

    @property
    def carry_geo(self) -> bool:
        """Whether states carry per-cluster skeleton aggregates."""
        return self.consts.geo.prior_type != "uniform"

    def _geo_cost_matrix(self):
        c = self.consts
        if c.geo.prior_type == "simulated":
            return c.cost_matrix * (0.020838 / c.geo.mean_edge_length)
        return c.cost_matrix

    def updated_geo_agg(self, geo_agg, clusters, changed):
        """A copy of the carried (B, K, 3) skeleton aggregates ``geo_agg`` of
        ``clusters`` with row ``[b, i[b]]`` of each (B,) index ``i`` in
        ``changed`` re-derived from ``clusters``: for the MST one
        ``update_mst_stats`` (one launch on the card), else one
        ``skeleton_triple`` call for all of them."""
        if skeleton_of(self.consts.geo) == "mst":
            return update_mst_stats(self._geo_cost_matrix(), geo_agg, clusters, changed)
        return update_rows(geo_agg, clusters, changed, self.skeleton_triple)

    def skeleton_triple(self, mask, row_tile=None):
        """(M, 3) [total, n_edges, max_edge] of the skeleton of each cluster
        in ``mask`` (M, N) bool. ``row_tile``: the complete graph's longest
        edge in tiles of that many cost rows (None: ``auto_cost_row_tile``)."""
        c = self.consts
        cost = self._geo_cost_matrix()
        skeleton = skeleton_of(c.geo)
        if skeleton == "mst":
            return cluster_mst_stats(cost, mask)
        if skeleton == "complete_graph":
            # The full (m, m) submatrix, diagonal included.
            m = mask.to(cost.dtype)
            total = torch.einsum("bi,ij,bj->b", m, cost, m)
            n_edges = m.sum(-1) ** 2
            # The longest edge between two members: per column, the longest
            # edge from the members (over row tiles), then over the members.
            col_max = _masked_row_reduce(cost, mask, largest=True, row_tile=row_tile)
            max_e = torch.where(mask, col_max, float("-inf")).amax(-1)
            return torch.stack([total, n_edges, torch.clamp(max_e, min=0.0)], dim=-1)
        if skeleton == "delaunay":
            with span("sbt.sync/geo.delaunay"):
                locations = c.locations.cpu().numpy()
            with span("sbt.sync/geo.delaunay"):
                cost_np = c.cost_matrix.cpu().numpy()
            with span("sbt.sync/geo.delaunay"):
                masks = mask.cpu().numpy()
            rows = [_delaunay_host(m, locations, cost_np) for m in masks]
            with span("sbt.sync/geo.delaunay"):
                return torch.as_tensor(np.stack(rows).reshape(-1, 3), dtype=cost.dtype,
                                       device=cost.device)
        if skeleton == "diameter":
            raise NotImplementedError("skeleton=diameter is not implemented")
        raise ValueError(f"Unknown skeleton {skeleton}")

    def geo_agg_of(self, clusters):
        """(B, K, 3) carried skeleton aggregates, or None when not carried."""
        if not self.carry_geo:
            return None
        B, K, N = clusters.shape
        return self.skeleton_triple(clusters.reshape(B * K, N)).view(B, K, 3)

    def _aggregate_of_triple(self, triple):
        g = self.consts.geo
        total, n_edges, max_e = triple[..., 0], triple[..., 1], triple[..., 2]
        if g.aggregation == "sum":
            return total
        if g.aggregation == "mean":
            return total / torch.clamp(n_edges, min=1.0)
        if g.aggregation == "max":
            return torch.clamp(max_e, min=0.0)
        raise ValueError(f"Unknown aggregation {g.aggregation}")

    def _geo_probability_function(self, agg_cost):
        g = self.consts.geo
        if g.probability_function == "exponential":
            return -agg_cost / g.scale
        if g.probability_function == "sigmoid":
            x0, s = g.inflection_point, g.scale
            log_expit = torch.nn.functional.logsigmoid
            log_p = log_expit(-(agg_cost - x0) / s)
            offset = torch.full((), x0 / s, dtype=agg_cost.dtype, device=agg_cost.device)
            return log_p - log_expit(offset)
        raise ValueError(f"Unknown probability_function {g.probability_function}")

    def geo_prior_from_agg(self, clusters, geo_agg):
        """(B, K) geo-prior log-probabilities from the skeleton aggregates
        ``geo_agg`` (B, K, 3) of ``clusters``."""
        g = self.consts.geo
        if g.prior_type == "cost_based":
            return self._geo_probability_function(self._aggregate_of_triple(geo_agg))
        if g.prior_type == "simulated":
            return _simulated_sigmoid(geo_agg[..., 0], clusters.sum(-1).to(geo_agg.dtype))
        raise ValueError(f"Unknown geo prior type {g.prior_type}")

    def geo_prior_per_cluster(self, clusters):
        """(B, K) geo-prior log-probabilities, the skeletons recomputed."""
        if not self.carry_geo:
            return torch.zeros(clusters.shape[:2], device=clusters.device)
        return self.geo_prior_from_agg(clusters, self.geo_agg_of(clusters))

    def geo_prior_costs_per_object(self, clusters, i_cluster, geo_agg=None, row_tile=None):
        """(B, N) change of the log geo prior of cluster ``i_cluster`` (B,) if
        each object were added to it (the cheapest edge to the cluster joins
        the aggregate). ``geo_agg`` may pass the state's carried aggregates;
        without them the cluster's MST is computed here. The cheapest edges
        are a running minimum over tiles of ``row_tile`` member rows of the
        cost matrix (None: ``auto_cost_row_tile``), with no (B, N, N)
        temporary."""
        c = self.consts
        g = c.geo
        cost = c.cost_matrix
        if g.prior_type == "uniform":
            return torch.zeros((clusters.shape[0], c.N), device=clusters.device)
        ar = torch.arange(clusters.shape[0], device=clusters.device)
        cluster = clusters[ar, i_cluster]                                   # (B, N)
        m = cluster.sum(-1, keepdim=True).to(cost.dtype)
        cost_to_cluster = _masked_row_reduce(cost, cluster, largest=False, row_tile=row_tile)
        # The carried aggregates of the simulated type are on the scaled cost
        # matrix and those of other skeletons are no MST: only cost_based with
        # the MST skeleton reuses them here.
        if geo_agg is not None and g.prior_type == "cost_based" and g.skeleton == "mst":
            triple = geo_agg[ar, i_cluster]
        else:
            triple = cluster_mst_stats(cost, cluster)
        total, count, max_edge = triple[:, 0:1], triple[:, 1:2], triple[:, 2:3]
        if g.aggregation == "mean":
            before = total / torch.clamp(count, min=1.0)
            after = (cost_to_cluster + m * before) / (1 + m)
        elif g.aggregation == "sum":
            before = total
            after = cost_to_cluster + before
        elif g.aggregation == "max":
            before = max_edge
            after = torch.maximum(cost_to_cluster, before)
        else:
            raise ValueError(f"Aggregation {g.aggregation} not implemented for costs per object")
        return self._geo_probability_function(after) - self._geo_probability_function(before)

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
        hc = self.has_components(clusters)

        def tile(sl):
            w = normalize_weights(weights[:, sl], hc)
            p = source_pick(w, source[:, :, sl])                # (B, N, f)
            valid = ~c.na[None, :, sl]
            return torch.where(valid, torch.log(torch.where(valid, p, torch.ones_like(p))),
                               torch.zeros_like(p)).sum((-1, -2))

        return add_tiles([tile(sl) for sl in feature_tiles(c.F, c.feature_chunk)])

    # ---------------- bundles ----------------

    def parts(self, state, counts=None, geo_agg=None) -> PosteriorParts:
        """Full posterior decomposition; ``counts`` may pass the state's
        carried counts (else the likelihood is recomputed by the kernel) and
        ``geo_agg`` its skeleton aggregates (else they are recomputed)."""
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
            geo_prior=(self.geo_prior_per_cluster(state.clusters) if geo_agg is None
                       else self.geo_prior_from_agg(state.clusters, geo_agg)).sum(-1),
            weights_prior=self.weights_prior(state.weights),
            source_prior=self.source_prior(state.clusters, state.weights, state.source),
        )

    def fill_state(self, state):
        """The state with log_lh / log_prior / prior_parts and the carried
        counts, pattern counts and geo aggregates recomputed exactly."""
        counts = self.feature_counts(state.clusters, state.source)
        geo_agg = self.geo_agg_of(state.clusters)
        p = self.parts(state, counts=counts, geo_agg=geo_agg)
        return state._replace(
            log_lh=p.log_lh, log_prior=p.log_prior, prior_parts=p.prior_vector(),
            cl_counts=counts[0], conf_counts=counts[1],
            geo_agg=geo_agg,
            pat_counts=self.pattern_counts(state.clusters, state.source),
        )


class ObjectSplitPosterior(Posterior):
    """The posterior of a chain shard on a grid row (``parallel.mesh.
    ObjectSplit``): ``consts`` are the head's (no O(N F) arrays), states hold
    a ``SplitSource``, and each term that reads the source or the features
    is a sum of per-block partials, added on the head in block order. The
    counts are integer-valued, so they and the log-likelihood equal the
    unsplit ones bit for bit; the source prior is a float sum in another
    order. Everything of O(K N) (sizes, the geo prior, availabilities) is
    the unsplit ``Posterior``'s, on the head."""

    def __init__(self, split, sample_from_prior: bool = False):
        super().__init__(split.head, sample_from_prior)
        self.split = split
        self.blocks = [Posterior(c, sample_from_prior) for c in split.blocks]

    def feature_counts(self, clusters, source):
        sp = self.split
        return sp.reduce(lambda j: loglh.loglh_counts(sp.blocks[j], sp.cols(j, clusters),
                                                      source.blocks[j]))

    def log_likelihood_from_counts(self, cluster_counts, conf_counts):
        return loglh.loglh_from_counts(self.consts, cluster_counts, conf_counts)

    def log_likelihood(self, state):
        return self.log_likelihood_from_counts(*self.feature_counts(state.clusters,
                                                                    state.source))

    def source_form(self, source):
        return source

    def pattern_counts(self, clusters, source):
        sp = self.split
        return sp.reduce(lambda j: self.blocks[j].pattern_counts(sp.cols(j, clusters),
                                                                 source.blocks[j]))

    def source_prior(self, clusters, weights, source):
        sp = self.split
        return sp.reduce(lambda j: self.blocks[j].source_prior(
            sp.cols(j, clusters), sp.to_block(j, weights), source.blocks[j]))


def _masked_row_reduce(cost, mask, largest: bool, row_tile=None):
    """(M, N): per cluster of ``mask`` (M, N) and column j, the min (the max
    with ``largest``) of ``cost[i, j]`` over the members i (+inf, -inf for
    an empty cluster). A running reduction over tiles of ``row_tile`` rows
    (None: ``auto_cost_row_tile``): an (M, rows, N) temporary per tile, and
    bit-equal to one tile of all N rows, as a min or a max is exact."""
    M, N = mask.shape
    rows = auto_cost_row_tile(M, N) if row_tile is None else int(row_tile)
    fill = torch.full((), float("-inf") if largest else float("inf"), dtype=cost.dtype,
                      device=cost.device)
    out = None
    for r0 in range(0, N, rows):
        sl = slice(r0, min(r0 + rows, N))
        part = torch.where(mask[:, sl, None], cost[None, sl], fill)
        part = part.amax(1) if largest else part.amin(1)
        out = part if out is None else (torch.maximum if largest else torch.minimum)(out, part)
    return out


def _delaunay_host(mask, locations, cost):
    """(3,) [total, n_edges, max_edge] over the Delaunay graph of ONE
    cluster's own points, on the host. Fewer than 3 points, collinear points
    or an empty graph fall back to the complete graph."""
    from sbayes_tpu_torch.data.geo import compute_delaunay

    idx = np.flatnonzero(np.asarray(mask))
    m = idx.size
    if m < 2:
        return np.zeros(3, np.float32)
    sub_cost = np.asarray(cost)[np.ix_(idx, idx)]
    if m == 2:
        e = float(sub_cost[0, 1])
        return np.asarray([e, 1.0, e], np.float32)
    try:
        adj = compute_delaunay(np.asarray(locations)[idx]).toarray() > 0
        np.fill_diagonal(adj, False)
        iu = np.triu(adj)
    except Exception:
        iu = np.triu(np.ones((m, m), bool), k=1)
    edges = sub_cost[iu]
    if edges.size == 0:
        edges = sub_cost[np.triu(np.ones((m, m), bool), k=1)]
    return np.asarray([edges.sum(), float(edges.size), edges.max()], np.float32)


def _simulated_sigmoid(total_distance, n):
    """The fitted logistic areality prior of the simulated geo prior."""
    logn = torch.log(torch.clamp(n, min=1.0))
    a, b, c, d = -1.62973132061948, 12.7679075267602, -25.4137798184766, 17.237407405487
    intercept = a * logn ** 3 + b * logn ** 2 + c * logn + d
    a2, b2, c2, d2 = -31.397363895626, 1.02000702311327, -94.0788824218419, 0.93626444975598
    coeff = a2 * b2 ** (-n) + c2 / torch.clamp(n, min=1.0) + d2
    return torch.nn.functional.logsigmoid(coeff * total_distance + intercept)
