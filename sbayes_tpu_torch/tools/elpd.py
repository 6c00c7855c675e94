"""PSIS-LOO model comparison over logged likelihood files.

Counterpart of the reference ELPD tool (sbayes/tools/elpd.py): walks a
results directory for ``likelihood_K*_*.h5`` files, computes the PSIS-LOO
ELPD of each run (own PSIS implementation — no arviz dependency) and
writes a comparison plot + table. Copy of ``sbayes_tpu/tools/elpd.py`` for
the PyTorch port, without pandas: the table is a ``utils.Table`` with the
JAX tool's columns and types. The likelihood files are read by
``results/hdf5.py``; h5py is imported only for a file in a layout that
reader does not read (chunked, as the JAX logger writes it), and
matplotlib only for the plot.
"""
from __future__ import annotations

import argparse
import warnings
from pathlib import Path

import numpy as np

from sbayes_tpu_torch.results.hdf5 import UnsupportedLayout, read_datasets
from sbayes_tpu_torch.tools.psis import psis_loo
from sbayes_tpu_torch.utils import Table

PathLike = Path | str


def _read_with_h5py(likelihood_path: PathLike) -> dict:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"'{likelihood_path}' is an HDF5 file in a layout that only h5py reads (chunked or "
            f"compressed, as the JAX logger writes it), and h5py is not installed") from e
    with h5py.File(likelihood_path, "r") as f:
        return {name: np.asarray(f[name]) for name in ("likelihood", "na_values") if name in f}


def read_log_likelihood(likelihood_path: PathLike, burnin: float) -> np.ndarray:
    """(n_samples, n_valid_observations) log-likelihood matrix."""
    try:
        datasets = read_datasets(likelihood_path)
    except UnsupportedLayout:
        datasets = _read_with_h5py(likelihood_path)
    lik = datasets["likelihood"]
    if "na_values" in datasets:
        is_na = datasets["na_values"]
    else:
        warnings.warn(
            f"No `na_values` array found in `{likelihood_path}`. Assuming observations "
            f"with constant likelihood 1.0 are NAs."
        )
        is_na = np.all(np.isclose(lik, 1), axis=0)

    lik = lik[:, ~is_na]
    burnin_int = int(burnin * len(lik))
    lik = lik[burnin_int:]
    return np.log(np.maximum(lik, 1e-35))


def sbayes_psis_loo(likelihood_path: PathLike, burnin: float) -> float:
    log_lik = read_log_likelihood(likelihood_path, burnin)
    elpd, _elpd_i, khats = psis_loo(log_lik)
    n_bad = int(np.sum(khats > 0.7))
    if n_bad:
        warnings.warn(
            f"{n_bad} of {len(khats)} observations have Pareto k > 0.7 in "
            f"{likelihood_path}; the PSIS-LOO estimate may be unreliable."
        )
    return elpd


def main(results_dir: Path, burnin: float = 0.1, plot_path: Path | None = None) -> Table:
    rows = []
    for run_path in sorted(Path(results_dir).rglob("likelihood_K*_*.h5")):
        *_, experiment, k_folder, file_name = run_path.parts
        if ".chain" in file_name:
            continue  # skip hot MC3 chains
        run_id = int(run_path.stem.rpartition("_")[-1])
        k = int(k_folder[1:])
        try:
            loo = sbayes_psis_loo(run_path, burnin)
            print("ELPD-LOO for", (experiment, k, run_id), ":", loo)
            rows.append({"experiment": experiment, "k": k, "run": run_id, "elpd_loo": loo})
        except Exception as e:
            warnings.warn(
                f"Error in likelihood file '{run_path}'. Skipped in model comparison.\n\t| {e}"
            )

    df = Table.from_records(rows)
    if not df.n_rows:
        warnings.warn(f"No results with valid likelihood files found in '{results_dir}'.")
        return df

    if plot_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        experiments = sorted(set(df["experiment"]))
        if len(set(df["k"])) == 1:
            ax.boxplot([df["elpd_loo"][df["experiment"] == e] for e in experiments],
                       tick_labels=experiments)
            ax.set_xlabel("experiment")
            ax.set_title("elpd_loo")
        else:
            for exp in experiments:
                at = df["experiment"] == exp
                ks = sorted(set(df["k"][at]))
                means = [df["elpd_loo"][at & (df["k"] == k)].mean() for k in ks]
                ax.plot(ks, means, ls="dashed", lw=0.8, marker="o", label=exp)
            ax.set_xlabel("number of clusters K")
            ax.set_ylabel("ELPD (PSIS-LOO)")
            ax.legend()
        fig.tight_layout(pad=0.5)
        fig.savefig(plot_path)
        print(f"Comparison plot written to {plot_path}")
    return df


def cli(args=None):
    parser = argparse.ArgumentParser(
        description="Bayesian cross validation of runs using PSIS-LOO."
    )
    parser.add_argument("results", type=Path, help="Directory with likelihood files.")
    parser.add_argument("burnin", type=float, default=0.1, nargs="?",
                        help="Fraction of samples discarded as burn-in.")
    parser.add_argument("--plot", type=Path, default=None, help="Optional output plot path.")
    ns = parser.parse_args(args)
    return main(ns.results, ns.burnin, ns.plot)


if __name__ == "__main__":
    cli()
