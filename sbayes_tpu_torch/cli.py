"""Command-line interface of the PyTorch port.

Port of ``sbayes_tpu/cli.py``: a config file (asked for in a file dialog
when none is given and a display is there), ``-n/--name -t/--threads
-r/--resume -K/--numClusters -i/--runID``, plus ``--device`` (default
``cuda``; a CUDA device without a card raises), and ``run_experiment``,
the JAX package's entry point for one run (plus ``device``). With one
process, several runs of one K execute as one batched chain ensemble
(split over the cards by ``parallel/mesh.py``); one run executes alone
through ``run_experiment``, and so does each run under MC3 (its ladder is
the batch) or ``-r`` (the runs may resume at different steps). With ``-t
N`` (N > 1) every (run, K) configuration runs alone (``mcmc.runs: 1``, its
run id) in a pool of N spawned processes; under ``--device cuda``
configuration i runs on ``cuda:{i % device_count}``.
A configuration's exception reaches this process.
"""
from __future__ import annotations

import argparse
import multiprocessing
import warnings
from concurrent.futures import ProcessPoolExecutor
from copy import deepcopy
from itertools import product
from pathlib import Path

from sbayes_tpu_torch.experiment import Experiment
from sbayes_tpu_torch.utils import PathLike, update_recursive


def _mcmc_setup(config, experiment_name, custom_settings, i_run, device):
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    experiment = Experiment(config_file=config, experiment_name=experiment_name,
                            custom_settings=custom_settings, log=True, i_run=i_run)
    data = Data.from_experiment(experiment)
    data.logger = None
    mcmc = MCMCSetup(data=data, experiment=experiment, device=device)
    mcmc.log_setup()
    return mcmc


def run_experiment(config: PathLike, experiment_name: str, custom_settings: dict = None,
                   resume: bool = False, i_run: int = 0, device: str = "cuda"):
    """One run (``i_run``) of the config's model, as the JAX package's
    ``cli.run_experiment``: MC3 when ``mcmc.mc3.activate``, else one chain;
    ``resume`` continues the run's files. ``device``: the torch device to
    sample on (default the card; a CUDA device without a card raises)."""
    mcmc = _mcmc_setup(config, experiment_name, custom_settings, i_run, device)
    if mcmc.config.mcmc.mc3.activate:
        mcmc.sample_mc3(run=i_run, resume=resume)
    else:
        mcmc.sample(run=i_run, resume=resume)


def runner(args):
    """Pool task: one (run, K) configuration alone, as ``mcmc.runs: 1``."""
    i_run, n_clusters, config, experiment_name, custom_settings, resume, device = args
    run_settings = deepcopy(custom_settings) if custom_settings else {}
    update_recursive(run_settings, {"model": {"clusters": int(n_clusters)},
                                    "mcmc": {"runs": 1}})
    run_experiment(config, experiment_name, run_settings, resume, i_run, device)


def pool_device(device: str, i: int) -> str:
    """The device of pool task ``i``: the cards in turn under a CUDA device
    without an index, else ``device``."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not torch.cuda.is_available():
        return device
    return f"cuda:{i % torch.cuda.device_count()}"


def main(config: PathLike, experiment_name: str = None, custom_settings: dict = None,
         processes: int = 1, resume: bool = False, n_clusters=None, i_run: int = None,
         device: str = "cuda"):
    experiment = Experiment(config_file=config, experiment_name=experiment_name,
                            custom_settings=custom_settings, log=False)
    n_runs = experiment.config.mcmc.runs
    run_ids = list(range(n_runs)) if i_run is None else [i_run]
    if n_clusters is None:
        n_clusters = experiment.config.model.clusters
    else:
        warnings.warn(
            f"The number of clusters was set as a command-line argument, so the config "
            f"entry `clusters={experiment.config.model.clusters}` will be ignored.")
    if isinstance(n_clusters, int):
        n_clusters = [n_clusters]
    if processes > 1:
        tasks = [(r, k, config, experiment.experiment_name, custom_settings, resume,
                  pool_device(device, i))
                 for i, (r, k) in enumerate(product(run_ids, n_clusters))]
        # spawn, never fork: this process may hold a CUDA context. A worker
        # that dies breaks the pool and raises here instead of hanging it.
        with ProcessPoolExecutor(max_workers=processes,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(runner, tasks))
        return
    one_at_a_time = resume or experiment.config.mcmc.mc3.activate or len(run_ids) == 1
    for k in n_clusters:
        run_settings = deepcopy(custom_settings) if custom_settings else {}
        update_recursive(run_settings, {"model": {"clusters": int(k)}})
        if one_at_a_time:
            for r in run_ids:
                run_experiment(config, experiment.experiment_name, run_settings, resume, r,
                               device)
        else:
            _mcmc_setup(config, experiment.experiment_name, run_settings, run_ids[0],
                        device).sample_ensemble(run_ids=run_ids)


def _ask_config_file_dialog() -> "str | None":
    """The config file from a file dialog when none was given, as the JAX
    CLI asks for it; None without a usable display (headless, no tkinter,
    no terminal)."""
    import os
    import sys

    if not (sys.stdin.isatty() and (os.environ.get("DISPLAY")
                                    or sys.platform in ("win32", "darwin"))):
        return None
    try:
        import tkinter as tk
        from tkinter import filedialog
    except ImportError:
        return None
    try:
        tk.Tk().withdraw()
        return filedialog.askopenfilename(
            title="Select a config file in YAML or JSON format.",
            initialdir="..",
            filetypes=(("json files", ".json"),
                       ("yaml files", ".yaml .yml"),
                       ("all files", "*.*")),
        ) or None
    except tk.TclError:
        return None


def _str2bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "y", "on"):
        return True
    if v.lower() in ("0", "false", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"Expected a boolean, got {v!r}")


def cli(args=None):
    parser = argparse.ArgumentParser(
        description="MCMC to detect clusters in the presence of confounders (PyTorch, CUDA).")
    parser.add_argument("config", type=Path, nargs="?",
                        help="The YAML (or JSON) configuration file")
    parser.add_argument("-n", "--name", nargs="?", type=str,
                        help="Experiment name (results directory; default: date/time).")
    parser.add_argument("-t", "--threads", nargs="?", type=int, default=1,
                        help="Number of parallel run processes (default 1: the runs of one K "
                             "as one ensemble).")
    parser.add_argument("-r", "--resume", nargs="?", type=_str2bool, const=True, default=False,
                        help="Resume a previous run (requires matching name, runID, K).")
    parser.add_argument("-K", "--numClusters", nargs="*", type=int,
                        help="Number of clusters (overrides config; multiple => multiple runs).")
    parser.add_argument("-i", "--runID", nargs="?", type=int,
                        help="Index of this run (to distinguish runs with the same K/name).")
    parser.add_argument("--device", default="cuda",
                        help="torch device to sample on (default: cuda).")
    ns = parser.parse_args(args)
    config = ns.config
    if config is None:
        config = _ask_config_file_dialog()
        if not config:
            parser.error("A config file is required (no config argument and "
                         "no interactive display for the file dialog).")
    if not Path(config).is_file():
        parser.error(f"Config file not found: {config}")
    main(config=config, experiment_name=ns.name, processes=ns.threads, resume=ns.resume,
         n_clusters=ns.numClusters, i_run=ns.runID, device=ns.device)


if __name__ == "__main__":
    cli()
