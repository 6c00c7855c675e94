"""Align cluster labels (and all dependent stats columns) across runs.

Counterparts of the reference tools (sbayes/tools/align_clusters.py and
realign_clusters_within_run.py): Hungarian matching of cluster labels
between two runs (or within one run over time), with the areal-effect and
size columns of the stats file permuted consistently. Copy of
``sbayes_tpu/tools/align_clusters.py`` for the PyTorch port, without pandas:
the parameters are a ``utils.Table`` (``Results``), written back as pandas'
``to_csv`` writes them (``utils.write_table``), so the aligned files equal
the JAX tool's byte for byte.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from numpy.typing import NDArray
from scipy.optimize import linear_sum_assignment

from sbayes_tpu_torch.results.results import Results
from sbayes_tpu_torch.utils import Table, format_cluster_columns, parse_cluster_columns, write_table


def load_clusters(filename) -> NDArray:
    """(n_samples, n_clusters, n_objects) int array from a clusters file."""
    with open(filename, "r") as f:
        return np.array([parse_cluster_columns(line.strip()) for line in f], dtype=int)


def write_clusters(filename, cluster_samples):
    with open(filename, "w") as f:
        f.writelines(format_cluster_columns(sample) + "\n" for sample in cluster_samples)


def cluster_agreement(a1, a2):
    return np.matmul(a1, a2.T)


def permute_cluster_params(params: Table, cluster_names, permutation) -> Table:
    """Permute areal-effect and size columns according to ``permutation``
    (in place; returns ``params``)."""
    cluster_names = np.array(cluster_names)
    remap = {}
    for clust_i, clust_j in zip(cluster_names, cluster_names[permutation]):
        prefix_i, prefix_j = f"areal_{clust_i}_", f"areal_{clust_j}_"
        for k in params:
            if k.startswith(prefix_i):
                remap[k] = params[prefix_j + k[len(prefix_i):]].copy()
    for i, j in enumerate(permutation):
        remap[f"size_a{i}"] = params[f"size_a{j}"].copy()
    for k_old, new_col in remap.items():
        params[k_old] = new_col
    return params


def align_two_runs(results_1: Results, results_2: Results):
    """Best label permutation of run 2 to match run 1; returns
    (aligned clusters of run 2, aligned parameters of run 2)."""
    mean_1 = np.mean(results_1.clusters, axis=1)
    mean_2 = np.mean(results_2.clusters, axis=1)
    d = cluster_agreement(mean_1, mean_2)
    perm = linear_sum_assignment(d, maximize=True)[1]

    clusters_2_aligned = results_2.clusters[perm].transpose((1, 0, 2))
    params_2_aligned = permute_cluster_params(
        Table(results_2.parameters), results_2.cluster_names, perm
    )
    return clusters_2_aligned, params_2_aligned


def realign_within_run(clusters: NDArray, params: Table, cluster_names):
    """Fix label switches within one run: align each sample's labels to the
    running cluster sums (reference: realign_clusters_within_run.py)."""
    clusters = clusters.copy()
    sum_clusters = np.mean(clusters[:, :20, :], axis=1)
    for i_s in range(clusters.shape[1]):
        d = cluster_agreement(sum_clusters, clusters[:, i_s])
        perm = linear_sum_assignment(d, maximize=True)[1]
        if not np.all(perm == np.arange(len(perm))):
            clusters[:, i_s:] = clusters[perm, i_s:]
            permuted = permute_cluster_params(Table(params), cluster_names, perm)
            params = Table((k, np.concatenate([params[k][:i_s], permuted[k][i_s:]]))
                           for k in params)
        sum_clusters += clusters[:, i_s]
    return clusters, params


def cli_align(args=None):
    parser = argparse.ArgumentParser(description="Align clusters in logs of two runs.")
    parser.add_argument("-k", type=int, required=True)
    parser.add_argument("path1", type=Path)
    parser.add_argument("run1", type=int, nargs="?", default=0)
    parser.add_argument("path2", type=Path, nargs="?", default=None)
    parser.add_argument("run2", type=int, nargs="?", default=1)
    ns = parser.parse_args(args)
    K = ns.k

    path2 = ns.path2 if ns.path2 is not None else ns.path1
    clusters_path_1 = ns.path1 / f"K{K}" / f"clusters_K{K}_{ns.run1}.txt"
    parameters_path_1 = ns.path1 / f"K{K}" / f"stats_K{K}_{ns.run1}.txt"
    clusters_path_2 = path2 / f"K{K}" / f"clusters_K{K}_{ns.run2}.txt"
    parameters_path_2 = path2 / f"K{K}" / f"stats_K{K}_{ns.run2}.txt"

    results_1 = Results.from_csv_files(clusters_path_1, parameters_path_1, burn_in=0)
    results_2 = Results.from_csv_files(clusters_path_2, parameters_path_2, burn_in=0)

    clusters_2_aligned, params_2_aligned = align_two_runs(results_1, results_2)
    write_clusters(path2 / f"K{K}" / f"clusters_K{K}_{ns.run2}.aligned.txt", clusters_2_aligned)
    write_table(params_2_aligned, path2 / f"K{K}" / f"stats_K{K}_{ns.run2}.aligned.txt",
                sep="\t")


def cli_realign(args=None):
    parser = argparse.ArgumentParser(description="Realign cluster labels within one run.")
    parser.add_argument("path", type=Path)
    parser.add_argument("k", type=int)
    parser.add_argument("run", type=int, nargs="?", default=0)
    ns = parser.parse_args(args)
    K = ns.k

    clusters_path = ns.path / f"K{K}" / f"clusters_K{K}_{ns.run}.txt"
    parameters_path = ns.path / f"K{K}" / f"stats_K{K}_{ns.run}.txt"
    results = Results.from_csv_files(clusters_path, parameters_path, burn_in=0)
    clusters, params = realign_within_run(
        results.clusters, results.parameters, results.cluster_names
    )
    write_clusters(ns.path / f"K{K}" / f"clusters_K{K}_{ns.run}.aligned.txt",
                   clusters.transpose((1, 0, 2)))
    write_table(params, ns.path / f"K{K}" / f"stats_K{K}_{ns.run}.aligned.txt", sep="\t")


if __name__ == "__main__":
    cli_align()
