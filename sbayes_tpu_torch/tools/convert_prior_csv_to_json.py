"""Convert Dirichlet prior parameters from CSV (feature x state) to JSON.

Counterpart of the reference tool (sbayes/tools/convert_prior_csv_to_json.py);
copy of ``sbayes_tpu/tools/convert_prior_csv_to_json.py`` for the PyTorch
port, without pandas: the CSV is read with its columns typed as pandas'
``read_csv`` types them (``utils.read_typed_table``) and each row's values
take the types pandas' ``iterrows`` gives them, so the JSON equals the JAX
tool's.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from sbayes_tpu_torch.utils import read_typed_table


def _row_values(table, i: int) -> dict:
    """Row ``i`` as ``iterrows().to_dict()`` gives it, NA left out: all
    columns integer -> ints, all numeric -> floats, else each column's own
    type."""
    kinds = {col.dtype.kind for col in table.values()}
    as_float = kinds <= {"i", "f"} and "f" in kinds
    row = {}
    for name, col in table.items():
        v = col[i]
        if v is None or (isinstance(v, (float, np.floating)) and np.isnan(v)):
            continue
        row[name] = float(v) if as_float else (v.item() if isinstance(v, np.generic) else v)
    return row


def convert(csv_path, output_path):
    table = read_typed_table(csv_path)
    features = table.pop("feature")
    counts_dict = {}
    for i, feature in enumerate(features):
        key = feature.item() if isinstance(feature, np.generic) else feature
        counts_dict[key] = _row_values(table, i)
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
