"""Chi-squared correlation screening between feature pairs.

Counterpart of the reference tool (sbayes/tools/find_correlated_features.py):
pairwise chi-squared contingency tests over all feature pairs, a heatmap of
significant correlations and a CSV of p-values. Copy of
``sbayes_tpu/tools/find_correlated_features.py`` for the PyTorch port: the
data load through the port's CSV reader; pandas and matplotlib are imported
where they are used.
"""
from __future__ import annotations

import argparse
from itertools import combinations
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
from scipy.stats import chi2_contingency

from sbayes_tpu_torch.utils import normalize_str, read_data_csv

if TYPE_CHECKING:
    import pandas as pd

METADATA_COLUMNS = ["id", "name", "family", "x", "y"]


def pairwise_chi2(features: pd.DataFrame) -> pd.DataFrame:
    """Symmetric matrix of chi-squared p-values between feature pairs."""
    import pandas as pd

    names = list(features.columns)
    p_values = pd.DataFrame(np.ones((len(names), len(names))), index=names, columns=names)
    for f1, f2 in combinations(names, 2):
        both = features[[f1, f2]].dropna()
        if both.empty or both[f1].nunique() < 2 or both[f2].nunique() < 2:
            continue
        contingency = pd.crosstab(both[f1], both[f2])
        try:
            _chi2, p, _dof, _exp = chi2_contingency(contingency)
        except ValueError:
            continue
        p_values.loc[f1, f2] = p_values.loc[f2, f1] = p
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

    import pandas as pd

    data = pd.DataFrame(read_data_csv(ns.input))
    for column in METADATA_COLUMNS:
        if column not in data.columns:
            raise ValueError(f"Required column '{column}' missing in data file.")
    features = data.drop(METADATA_COLUMNS, axis=1).map(normalize_str)

    p_values = pairwise_chi2(features)
    p_values.to_csv(Path(ns.output).with_suffix(".csv"))

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # a copy: under pandas' copy-on-write ``DataFrame.values`` is read-only
    significant = (p_values < ns.pThreshold).to_numpy(dtype=float, copy=True)
    np.fill_diagonal(significant, 0.0)
    fig, ax = plt.subplots(figsize=(max(6, len(p_values) // 4),) * 2)
    im = ax.imshow(-np.log10(np.maximum(p_values.values, 1e-300)), cmap="viridis")
    ax.set_xticks(range(len(p_values)), p_values.columns, rotation=90, fontsize=6)
    ax.set_yticks(range(len(p_values)), p_values.index, fontsize=6)
    fig.colorbar(im, label="-log10(p)")
    fig.tight_layout()
    fig.savefig(ns.output)

    n_sig = int(significant.sum() / 2)
    print(f"{n_sig} feature pairs significant at p < {ns.pThreshold}")


if __name__ == "__main__":
    main()
