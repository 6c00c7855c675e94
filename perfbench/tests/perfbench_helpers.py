"""Shared set-up of the benchmark's CPU tests: the repository on the path
and a cell shrunk to a size the CPU runs in seconds."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str) -> tuple:
    """(cell, config) of ``name`` at 30 objects x 8 features x 4 states,
    3 families, K = 2, a few chains: the same harness path, the same
    limits."""
    from perfbench import harness

    cell, config = harness.load_cell(name)
    config = copy.deepcopy(config)
    config["data"] = {"generator": "small", "n_objects": 30, "n_features": 8, "n_states": 4,
                      "n_families": 3}
    config["model"]["clusters"] = 2
    config["model"]["prior"]["objects_per_cluster"].update(min=2, max=10)
    config["mcmc"]["initialization"] = {"attempts": 2, "em_steps": 5}
    small = dict(chunk=10, warmup_steps=20, op_time_rounds=1)
    if cell["kind"] == "mc3":
        # Set-up passes a swap phase (step 900); the window's first chunk
        # (steps 900-950) none, so a rung left unstepped stays as it was.
        small.update(chunk=50, warmup_steps=50, first_step=850)
        cell = dict(cell, **small, ladder=dict(cell["ladder"], swap_interval=100))
    else:
        cell = dict(cell, **small, chains=8, check_chains=4)
    return cell, config
