"""The comparison that decides ``correct``: what the program's timed path
produced against what the plain reference works out from the same data and
the same states.

Numbers (each held to a limit of the cell's ``limits``):

* ``count_mismatch``: cells of the carried collapsed counts (clusters,
  confounder groups, availability patterns) and skeleton edge counts that
  differ from the reference's integers (exact: limit 0);
* ``invalid_chains``: chains whose end state breaks the configuration's
  constraints: an object in two clusters, or a cluster size outside the
  size prior's bounds (exact: limit 0);
* ``unmoved_chains``: in an ensemble, chains whose clusters and weights
  the window left exactly as they were; on a ladder, whose swaps move
  states between rungs at chunk ends, (checked chain, chunk) pairs whose
  clusters, weights and source a chunk left as they were (every chain of
  an MCMC takes accepted steps within a chunk; exact: limit 0);
* ``log_lh_gap``, ``prior_gap``: the carried log-likelihood and each part
  of the log-prior (and their sum) against the reference, the largest
  |program - reference| / max(1, |reference|) over the chains;
* ``geo_agg_gap``: the carried skeleton totals and longest edges, the same
  (cells with a cost-based geo prior);
* ``chunk_end_gap``: the log-posterior the program reported at the end of
  each chunk of the window (the trace's last row; a ladder's carried
  values), against the reference on the states of that moment, for the
  sample of chains the cell checks;
* ``marginal_gap``: the marginal kernel's log-odds on the end states
  against the reference's;
* ``swap_attempt_gap`` (MC3): swap proposals made against those due,
  min(attempts, pairs) per multiple of the swap interval passed (exact).
"""
from __future__ import annotations

import numpy as np


def rel_gap(program, reference) -> float:
    p = np.asarray(program, dtype=np.float64)
    r = np.asarray(reference, dtype=np.float64)
    if p.size == 0:
        return 0.0
    gap = np.abs(p - r) / np.maximum(1.0, np.abs(r))
    return float(np.nan_to_num(gap, nan=np.inf).max())


def state_numbers(program: dict, ref: dict, min_size: int, max_size: int) -> dict:
    """Numbers of the end states: ``program`` holds the carried fields as
    numpy arrays, ``ref`` what ``Reference.evaluate`` gave for them."""
    mismatch = 0
    for key in ("cl_counts", "conf_counts", "pat_counts"):
        p, r = np.asarray(program[key]), np.asarray(ref[key])
        if p.shape != r.shape:
            mismatch += max(p.size, r.size)
            continue
        mismatch += int((p != r).sum())
    out = {}
    if "geo_agg" in ref:
        p, r = np.asarray(program["geo_agg"], np.float64), ref["geo_agg"]
        mismatch += int((p[..., 1] != r[..., 1]).sum())
        out["geo_agg_gap"] = rel_gap(p[..., [0, 2]], r[..., [0, 2]])
    sizes = ref["sizes"]
    bad = ref["overlap"] | ((sizes < min_size) | (sizes > max_size)).any(-1)
    out.update({
        "count_mismatch": mismatch,
        "invalid_chains": int(bad.sum()),
        "log_lh_gap": rel_gap(program["log_lh"], ref["log_lh"]),
        "prior_gap": max(rel_gap(program["prior_parts"], ref["prior_parts"]),
                         rel_gap(program["log_prior"], ref["log_prior"])),
    })
    return out


def decide(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or below its
    limit; a number without a limit, or a limit without a number, fails."""
    rows, ok = [], True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        passed = (value is not None and limit is not None and np.isfinite(value)
                  and value <= limit)
        ok &= bool(passed)
        rows.append((name, value, limit))
    return ok, rows
