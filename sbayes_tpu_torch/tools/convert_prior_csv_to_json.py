"""Convert Dirichlet prior parameters from CSV (feature x state) to JSON.

Counterpart of the reference tool (sbayes/tools/convert_prior_csv_to_json.py);
copy of ``sbayes_tpu/tools/convert_prior_csv_to_json.py`` for the PyTorch
port, pandas imported where it is used.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def convert(csv_path, output_path):
    import pandas as pd

    counts_df = pd.read_csv(csv_path, index_col="feature")
    counts_dict = {}
    for feature, row in counts_df.iterrows():
        counts_dict[feature] = {
            k: v for k, v in row.to_dict().items() if not (isinstance(v, float) and np.isnan(v))
        }
    with open(output_path, "w") as json_file:
        json.dump(counts_dict, json_file, indent=4)


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Convert dirichlet prior parameters from CSV to JSON."
    )
    parser.add_argument("--csv", type=Path, required=True, help="The input CSV file")
    parser.add_argument("--output", type=Path, required=True, help="The output JSON file")
    ns = parser.parse_args(args)
    convert(ns.csv, ns.output)


if __name__ == "__main__":
    main()
