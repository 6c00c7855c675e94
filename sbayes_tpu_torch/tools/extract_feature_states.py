"""Extract the set of observed states per feature from data CSV files.

Counterpart of the reference tool (sbayes/tools/extract_feature_states.py):
collects unique (unicode-normalized) states per feature across one or more
data files, orders them alphabetically, and writes a feature_states CSV.
Copy of ``sbayes_tpu/tools/extract_feature_states.py`` for the PyTorch
port: read with the port's CSV reader and written with the ``csv`` module
(no pandas), in the format pandas' ``to_csv(index=False)`` gives.
"""
from __future__ import annotations

import argparse
import csv
import itertools
from pathlib import Path

from sbayes_tpu_torch.utils import normalize_str, read_data_csv

ORDER_STATES = True
METADATA_COLUMNS = ["id", "name", "family", "x", "y"]


def collect_feature_states(features_path) -> dict:
    features = read_data_csv(features_path)
    for column in METADATA_COLUMNS:
        if column not in features:
            raise ValueError(f"Required column '{column}' missing in file {features_path}.")
    return {f: {normalize_str(v) for v in values if v is not None}
            for f, values in features.items() if f not in METADATA_COLUMNS}


def extract(csv_paths, output_path):
    feature_states = None
    for path in csv_paths:
        new_fs = collect_feature_states(path)
        if feature_states is None:
            feature_states = new_fs
        else:
            if set(feature_states.keys()) != set(new_fs.keys()):
                raise ValueError(
                    "Features do not match between the input files:\n"
                    f"\tmissing in {path}: {sorted(set(feature_states) - set(new_fs))}\n"
                    f"\tonly in {path}: {sorted(set(new_fs) - set(feature_states))}"
                )
            for f in feature_states:
                feature_states[f].update(new_fs[f])

    if ORDER_STATES:
        feature_states = {f: sorted(v) for f, v in feature_states.items()}

    with open(output_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(feature_states))
        writer.writerows(itertools.zip_longest(*feature_states.values()))


def main(args=None):
    parser = argparse.ArgumentParser(description="Extract feature states from data files.")
    parser.add_argument("--input", nargs="*", type=Path, required=True, help="The input CSV files")
    parser.add_argument("--output", nargs="?", type=Path, required=True, help="The output CSV file")
    ns = parser.parse_args(args)
    extract(ns.input, ns.output)


if __name__ == "__main__":
    main()
