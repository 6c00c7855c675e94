"""Thin results files by keeping every n-th sample row.

Counterpart of the reference tool (sbayes/tools/subsample.py); copy of
``sbayes_tpu/tools/subsample.py`` for the PyTorch port.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def subsample_file(path: Path, interval: int) -> Path:
    path = Path(path)
    out_path = path.with_name(path.stem + "_subsampled" + path.suffix)
    with open(path, "r") as in_file, open(out_path, "w") as out_file:
        lines = in_file.readlines()
        if path.name.startswith("stats_"):
            out_file.write(lines.pop(0))  # keep header
        for i, line in enumerate(lines):
            if i % interval == 0:
                out_file.write(line)
    return out_path


def main(paths, interval: int) -> None:
    for path in paths:
        subsample_file(path, interval)


def cli(args=None):
    parser = argparse.ArgumentParser(description="Subsample results files.")
    parser.add_argument("-f", "--files", nargs="*", type=Path, required=True,
                        help="Results files (stats_*.txt or clusters_*.txt).")
    parser.add_argument("interval", type=int, default=2,
                        help="Interval at which the results are subsampled.")
    ns = parser.parse_args(args)
    return main(ns.files, ns.interval)


if __name__ == "__main__":
    cli()
