"""Chi-squared correlation screening between feature pairs.

Counterpart of the reference tool (sbayes/tools/find_correlated_features.py):
pairwise chi-squared contingency tests over all feature pairs, a heatmap of
significant correlations and a CSV of p-values. Copy of
``sbayes_tpu/tools/find_correlated_features.py`` for the PyTorch port,
without pandas: the data load through the port's CSV reader, the
contingency tables of ``crosstab`` (rows and columns in sorted order, as
pandas' ``crosstab`` gives them) from ``np.unique``, and the p-values
written as pandas' ``to_csv`` writes the JAX tool's data frame
(``utils.write_table``); matplotlib is imported where it is used.
"""
from __future__ import annotations

import argparse
from itertools import combinations
from pathlib import Path

import numpy as np
from numpy.typing import NDArray
from scipy.stats import chi2_contingency

from sbayes_tpu_torch.utils import Table, normalize_str, read_data_csv, write_table

METADATA_COLUMNS = ["id", "name", "family", "x", "y"]


def crosstab(a: NDArray, b: NDArray) -> NDArray:
    """Counts of each (value of ``a``, value of ``b``) pair, rows and columns
    in sorted order of the values."""
    rows, i = np.unique(a, return_inverse=True)
    cols, j = np.unique(b, return_inverse=True)
    table = np.zeros((len(rows), len(cols)), dtype=np.int64)
    np.add.at(table, (i, j), 1)
    return table


def pairwise_chi2(features: Table) -> NDArray:
    """Symmetric (F, F) matrix of chi-squared p-values between the feature
    columns of ``features`` (``None`` is NA), in their order."""
    names = list(features)
    p_values = np.ones((len(names), len(names)))
    for i1, i2 in combinations(range(len(names)), 2):
        a, b = features[names[i1]], features[names[i2]]
        keep = np.array([x is not None and y is not None for x, y in zip(a, b)], dtype=bool)
        a, b = a[keep], b[keep]
        if not keep.any() or len(set(a)) < 2 or len(set(b)) < 2:
            continue
        try:
            _chi2, p, _dof, _exp = chi2_contingency(crosstab(a, b))
        except ValueError:
            continue
        p_values[i1, i2] = p_values[i2, i1] = p
    return p_values


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Find features with significant correlation in a data set."
    )
    parser.add_argument("--input", required=True, type=Path, help="The input CSV file")
    parser.add_argument("--output", required=True, type=Path,
                        help="The output plot file (PDF/PNG)")
    parser.add_argument("-p", "--pThreshold", type=float, default=0.0001,
                        help="Significance level for plotting correlations.")
    ns = parser.parse_args(args)

    data = read_data_csv(ns.input)
    for column in METADATA_COLUMNS:
        if column not in data:
            raise ValueError(f"Required column '{column}' missing in data file.")
    names = [c for c in data if c not in METADATA_COLUMNS]
    features = Table((c, np.array([normalize_str(v) for v in data[c]], dtype=object))
                     for c in names)

    p_values = pairwise_chi2(features)
    write_table(Table((n, p_values[:, j]) for j, n in enumerate(names)),
                Path(ns.output).with_suffix(".csv"), index=names)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    significant = (p_values < ns.pThreshold).astype(float)
    np.fill_diagonal(significant, 0.0)
    fig, ax = plt.subplots(figsize=(max(6, len(p_values) // 4),) * 2)
    im = ax.imshow(-np.log10(np.maximum(p_values, 1e-300)), cmap="viridis")
    ax.set_xticks(range(len(p_values)), names, rotation=90, fontsize=6)
    ax.set_yticks(range(len(p_values)), names, fontsize=6)
    fig.colorbar(im, label="-log10(p)")
    fig.tight_layout()
    fig.savefig(ns.output)

    n_sig = int(significant.sum() / 2)
    print(f"{n_sig} feature pairs significant at p < {ns.pThreshold}")


if __name__ == "__main__":
    main()
