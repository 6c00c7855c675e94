"""Heuristically classify the type of each feature column in a data CSV.

The reference ships this as a tkinter GUI (sbayes/tools/guess_feature_types.py);
this is a headless CLI producing the same kind of summary: per feature, the
guessed type (binary / categorical / numeric-like / constant), the state
inventory, and NA counts, written as a CSV for manual review. Copy of
``sbayes_tpu/tools/guess_feature_types.py`` for the PyTorch port, without
pandas: the data load through the port's CSV reader into a ``Table``, the
summary is a ``Table`` written as pandas' ``to_csv`` writes it
(``utils.write_table``).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from sbayes_tpu_torch.utils import Table, normalize_str, read_data_csv, write_table

METADATA_COLUMNS = ["id", "name", "family", "x", "y"]


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def guess_types(data: Table) -> Table:
    rows = []
    for f in (c for c in data if c not in METADATA_COLUMNS):
        col = [normalize_str(v) for v in data[f]]
        states = sorted({v for v in col if v is not None})
        n_na = sum(v is None for v in col)
        if len(states) <= 1:
            ftype = "constant"
        elif len(states) == 2:
            ftype = "binary"
        elif all(_is_number(s) for s in states):
            ftype = "numeric-like (consider binning or ordinal encoding)"
        else:
            ftype = "categorical"
        rows.append({
            "feature": f,
            "guessed_type": ftype,
            "n_states": len(states),
            "states": "|".join(str(s) for s in states[:20]),
            "n_na": n_na,
        })
    return Table.from_records(rows)


def main(args=None):
    parser = argparse.ArgumentParser(description="Guess the type of each feature column.")
    parser.add_argument("--input", required=True, type=Path, help="The input CSV file")
    parser.add_argument("--output", required=True, type=Path, help="The output CSV file")
    ns = parser.parse_args(args)
    write_table(guess_types(read_data_csv(ns.input)), ns.output)


if __name__ == "__main__":
    main()
