"""Convergence diagnostics over results files: ESS and split-R-hat.

The reference delegates trace diagnostics to the external Tracer GUI on
the stats files (user_manual.md:481-489); this tool computes them
headlessly: per-(experiment, K) effective sample sizes of the posterior /
likelihood traces and cross-run split-R-hat.

Copy of ``sbayes_tpu/tools/diagnostics.py`` for the PyTorch port, without
pandas: the stats files through ``Results``, the table a ``utils.Table``
with the columns and types of the JAX tool's data frame.

Usage: python -m sbayes_tpu_torch.tools.diagnostics <results_dir> [burnin]
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np

from sbayes_tpu_torch.results.ess import effective_sample_size, split_rhat
from sbayes_tpu_torch.results.results import Results
from sbayes_tpu_torch.utils import Table


def analyze(results_dir: Path, burn_in: float = 0.1) -> Table:
    runs = defaultdict(list)
    for stats_path in sorted(Path(results_dir).rglob("stats_K*_*.txt")):
        if ".chain" in stats_path.name or ".aligned" in stats_path.name:
            continue
        clusters_path = stats_path.with_name(stats_path.name.replace("stats_", "clusters_"))
        if not clusters_path.exists():
            continue
        *_, experiment, k_folder, _fname = stats_path.parts
        run_id = int(stats_path.stem.rpartition("_")[-1])
        k = int(k_folder[1:])
        res = Results.from_csv_files(clusters_path, stats_path, burn_in=burn_in)
        runs[(experiment, k)].append((run_id, res))

    rows = []
    for (experiment, k), run_list in sorted(runs.items()):
        traces = {
            "posterior": [r.posterior for _, r in run_list],
            "likelihood": [r.likelihood for _, r in run_list],
        }
        for param, trace_list in traces.items():
            ess_per_run = [effective_sample_size(t) for t in trace_list]
            min_len = min(len(t) for t in trace_list)
            rhat = (
                split_rhat(np.stack([t[:min_len] for t in trace_list]))
                if len(trace_list) > 1 and min_len >= 4
                else np.nan
            )
            rows.append({
                "experiment": experiment,
                "K": k,
                "parameter": param,
                "runs": len(run_list),
                "samples_per_run": min_len,
                "ess_total": round(sum(ess_per_run), 1),
                "ess_min_run": round(min(ess_per_run), 1),
                "split_rhat": round(float(rhat), 4) if np.isfinite(rhat) else None,
            })
    return Table.from_records(rows)


def main(args=None):
    parser = argparse.ArgumentParser(description="ESS / R-hat diagnostics over results files.")
    parser.add_argument("results", type=Path, help="Results directory to scan.")
    parser.add_argument("burnin", type=float, nargs="?", default=0.1)
    ns = parser.parse_args(args)
    df = analyze(ns.results, ns.burnin)
    if not df.n_rows:
        print(f"No results files found under {ns.results}")
        return df
    print(df.to_string())
    rhat = np.array([np.nan if r is None else r for r in df["split_rhat"]], dtype=float)
    if np.any(rhat > 1.1):
        print("\nWARNING: split-R-hat > 1.1 for some parameters — chains may not have converged.")
    return df


if __name__ == "__main__":
    main()
