"""The Metropolis-Hastings step of a batch of chains.

Port of ``sbayes_tpu/sampling/kernel.py``: apply one operator to every
chain of the batch, evaluate only the posterior terms that operator can
change (from the operator's exact deltas), accept or reject per chain with
the Gibbs and reject sentinels, and write the deferred source rows of the
accepted chains.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from sbayes_tpu_torch.model.math import scatter_rows
from sbayes_tpu_torch.sampling.conditionals import Conditionals
from sbayes_tpu_torch.sampling.operators import OperatorSpec
from sbayes_tpu_torch.sampling.state import PRIOR_GEO, PRIOR_SIZE, PRIOR_SOURCE, PRIOR_WEIGHTS


class OperatorStats(NamedTuple):
    """Per-chain, per-operator accept/reject counters and step sizes."""

    accepts: torch.Tensor        # int32 (B, n_ops)
    rejects: torch.Tensor        # int32 (B, n_ops)
    step_size_sum: torch.Tensor  # f32 (B, n_ops), summed over accepted steps
    non_finite: torch.Tensor     # int32 (B,) accepted non-finite posteriors

    @classmethod
    def zeros(cls, n_chains: int, n_ops: int, device) -> "OperatorStats":
        return cls(
            accepts=torch.zeros((n_chains, n_ops), dtype=torch.int32, device=device),
            rejects=torch.zeros((n_chains, n_ops), dtype=torch.int32, device=device),
            step_size_sum=torch.zeros((n_chains, n_ops), device=device),
            non_finite=torch.zeros(n_chains, dtype=torch.int32, device=device),
        )

    def record(self, op_idx: int, accept, step_size, nf) -> "OperatorStats":
        acc = accept.int()
        accepts, rejects, sss = self.accepts.clone(), self.rejects.clone(), self.step_size_sum.clone()
        accepts[:, op_idx] += acc
        rejects[:, op_idx] += 1 - acc
        sss[:, op_idx] += torch.where(accept, step_size, torch.zeros((), device=accept.device))
        return OperatorStats(accepts, rejects, sss, self.non_finite + nf.int())


def make_mh_apply_fn(cond: Conditionals, op_specs: Sequence[OperatorSpec]) -> Callable:
    """``apply(op_idx, gen, state) -> (new_state, accept, step_size, nf)``:
    operator ``op_idx`` (one draw for the whole batch) and the MH step."""
    post = cond.post
    T, Tp = cond.T, cond.Tp
    sfp = cond.sample_from_prior

    def candidate_log_lh(old, cand, ll_delta):
        """(log_lh, exact d_ll): the operator's delta, else the diff-then-sum
        of the carried counts (unchanged cells cancel exactly)."""
        if sfp:
            z = torch.zeros_like(old.log_lh)
            return z, z
        if ll_delta is not None:
            return old.log_lh + ll_delta, ll_delta
        d = post.log_likelihood_diff_from_counts((cand.cl_counts, cand.conf_counts),
                                                 (old.cl_counts, old.conf_counts))
        return old.log_lh + d, d

    def evaluate_candidate(spec, old, cand, sp_delta, ll_delta):
        """(cand with log_lh / log_prior / prior_parts, d_ll, d_prior).
        Without ``sp_delta`` (whole-source moves) the candidate's source
        prior is recomputed from its own source."""
        pp = old.prior_parts.clone()
        if sp_delta is None:
            pp[:, PRIOR_SOURCE] = post.source_prior(cand.clusters, cand.weights, cand.source)
            sp_delta = pp[:, PRIOR_SOURCE] - old.prior_parts[:, PRIOR_SOURCE]
        else:
            pp[:, PRIOR_SOURCE] = old.prior_parts[:, PRIOR_SOURCE] + sp_delta
        if spec.changes == "clusters":
            ll, d_ll = candidate_log_lh(old, cand, ll_delta)
            pp[:, PRIOR_SIZE] = post.size_prior(cand.clusters)
            pp[:, PRIOR_GEO] = post.geo_prior_per_cluster(cand.clusters).sum(-1)
        elif spec.changes == "source":
            ll, d_ll = candidate_log_lh(old, cand, ll_delta)
        elif spec.changes == "weights":
            ll, d_ll = old.log_lh, torch.zeros_like(old.log_lh)
            pp[:, PRIOR_WEIGHTS] = post.weights_prior(cand.weights)
        else:
            raise ValueError(f"Unknown operator change group {spec.changes}")
        d_parts = pp - old.prior_parts
        d_parts[:, PRIOR_SOURCE] = sp_delta
        cand = cand._replace(log_lh=ll, log_prior=pp.sum(-1), prior_parts=pp)
        return cand, d_ll, d_parts.sum(-1)

    def apply(op_idx: int, gen, state):
        spec = op_specs[op_idx]
        res = spec.fn(gen, state)
        if res.source_rows is not None and res.source_prior_delta is None:
            # The deferred-rows candidate carries the OLD source buffer: every
            # source-dependent term must arrive as an exact delta.
            raise ValueError(f"operator {spec.name}: source_rows requires source_prior_delta")
        cand, d_ll, d_prior = evaluate_candidate(spec, state, res.state,
                                                 res.source_prior_delta, res.ll_delta)
        gibbs = torch.isneginf(res.log_q)
        direct_reject = torch.isneginf(res.log_q_back)
        mh_ratio = d_ll / T + d_prior / Tp - (res.log_q - res.log_q_back)
        u = torch.log(torch.rand(mh_ratio.shape, generator=gen, device=mh_ratio.device))
        accept = (~direct_reject) & (gibbs | (u < mh_ratio))
        nf = accept & (~torch.isfinite(cand.log_lh) | ~torch.isfinite(cand.log_prior))
        new_state = cand.where(accept, state)
        if res.source_rows is not None:
            # Deferred row write: only accepted chains write their rows.
            idx, rows = res.source_rows
            idx = torch.where(accept[:, None], idx, state.source.shape[1])
            new_state = new_state._replace(source=scatter_rows(state.source, idx, rows))
        return new_state, accept, res.step_size, nf

    return apply
