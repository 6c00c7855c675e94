"""Extract empirical Dirichlet prior counts from data files.

Covers both reference tools:
  * ``extract_universal_prior_counts`` — total state counts over all
    objects -> one JSON (sbayes/tools/extract_universal_prior_counts.py)
  * ``extract_inheritance_prior_counts`` — per-family state counts ->
    one JSON per family (sbayes/tools/extract_inheritance_prior_counts.py)

Counts can be capped with ``--scaleCounts`` and offset by a hyper-prior
concentration ``--add``. Copy of ``sbayes_tpu/tools/extract_prior_counts.py``
for the PyTorch port: the data load through the port's CSV reader (no
pandas).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from sbayes_tpu_torch.data.loader import read_features_from_csv
from sbayes_tpu_torch.utils import scale_counts


def _counts_to_dict(counts, features, add: float) -> dict:
    out = {}
    for i_f, feature in enumerate(features.names):
        out[feature] = {}
        for i_s, state in enumerate(features.state_names[i_f]):
            out[feature][state] = add + float(counts[i_f, i_s])
    return out


def extract_universal(data_path, feature_states_path, output_file, add=1.0, max_counts=None):
    _objects, features, _conf = read_features_from_csv(
        data_path=data_path, feature_states_path=feature_states_path,
        confounder_names=["universal"],
    )
    counts = np.sum(features.values, axis=0)
    if max_counts is not None:
        counts = scale_counts(counts, max_counts)
    with open(output_file, "w") as f:
        json.dump(_counts_to_dict(counts, features, add), f, indent=4)


def extract_inheritance(data_path, feature_states_path, output_directory, add=1.0, max_counts=None):
    _objects, features, confounders = read_features_from_csv(
        data_path=data_path, feature_states_path=feature_states_path,
        confounder_names=["family"],
    )
    families = confounders["family"]
    output_directory = Path(output_directory)
    output_directory.mkdir(parents=True, exist_ok=True)
    for i_fam, family_name in enumerate(families.group_names):
        members = families.group_assignment[i_fam]
        counts = np.sum(features.values[members], axis=0)
        if max_counts is not None:
            counts = scale_counts(counts, max_counts)
        with open(output_directory / f"{family_name}.json", "w") as f:
            json.dump(_counts_to_dict(counts, features, add), f, indent=4)


def main_universal(args=None):
    parser = argparse.ArgumentParser(
        description="Extract parameters for an empirical universal prior from data files."
    )
    parser.add_argument("--data", type=Path, required=True)
    parser.add_argument("--featureStates", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--add", nargs="?", default=1.0, type=float,
                        help="Concentration of the hyper-prior (1.0 is uniform)")
    parser.add_argument("--scaleCounts", nargs="?", default=None, type=float,
                        help="Upper bound on the concentration of the prior")
    ns = parser.parse_args(args)
    extract_universal(ns.data, ns.featureStates, ns.output, ns.add, ns.scaleCounts)


def main_inheritance(args=None):
    parser = argparse.ArgumentParser(
        description="Extract parameters for empirical per-family priors from data files."
    )
    parser.add_argument("--data", type=Path, required=True)
    parser.add_argument("--featureStates", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True, help="Output directory")
    parser.add_argument("--add", nargs="?", default=1.0, type=float)
    parser.add_argument("--scaleCounts", nargs="?", default=None, type=float)
    ns = parser.parse_args(args)
    extract_inheritance(ns.data, ns.featureStates, ns.output, ns.add, ns.scaleCounts)


if __name__ == "__main__":
    main_universal()
