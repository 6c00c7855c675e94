"""Readings for the limits of a cell's comparison, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 30

For each seed, in one process: one run of the cell as the benchmark makes
it (its numbers are the sound readings), then the control: the reference
itself, computed in bfloat16 (the precision below the configuration's
float32), put in the program's place for every value the comparison
reads (the carried counts, log-likelihood, prior parts, skeletons, the
reported log-posterior at each chunk end and the marginal), and judged by
the float64 reference like the program. One JSON line per seed. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_numbers(arrays, config, outputs, device) -> dict:
    import numpy as np
    import torch

    from perfbench import harness
    from perfbench.reference.posterior import Reference

    program, snaps, inputs = outputs
    low = Reference(arrays, config["model"], device=device, dtype=torch.bfloat16)

    def in_bf16(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16).double().numpy()

    end = low.evaluate(program["clusters"], program["weights"], program["source"])
    stand_in = dict(program)
    for k in ("cl_counts", "conf_counts", "pat_counts", "log_lh", "log_prior", "prior_parts",
              "geo_agg"):
        if k in end:
            stand_in[k] = in_bf16(end[k])
    stand_in["marginal"] = np.zeros_like(program["marginal"])
    idx = snaps.idx.cpu().numpy()
    stand_in["marginal"][idx] = low.marginal(*[None if x is None else x[idx] for x in inputs])
    low_snaps = harness.Snapshots(idx, "cpu")
    for snap in snaps.items:
        s = low.evaluate(*(snap[k].numpy() for k in ("clusters", "weights", "source")))
        low_snaps.items.append(dict(snap, reported=in_bf16(s["log_lh"] + s["log_prior"])))
    ref = Reference(arrays, config["model"], device=device)
    return harness.judge(ref, stand_in, low_snaps, inputs)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args()
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell, config = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(args.workload, cell, config, seed, args.seconds, False, "cuda",
                          time.perf_counter())
        control = control_numbers(res["ctx"].arrays, config, res["outputs"], "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "sound": res["numbers"],
                          "control": control, "steps": res["ctx"].steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
