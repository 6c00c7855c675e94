"""Command-line interface of the PyTorch port.

Port of ``sbayes_tpu/cli.py``: a positional config file, ``-n/--name
-r/--resume -K/--numClusters -i/--runID``, plus ``--device`` (default
``cuda``; a CUDA device without a card raises). Several runs of one K
execute as one batched chain ensemble; one run executes alone. Runs execute
in this process (no process pool): the chain batch is the parallelism.
"""
from __future__ import annotations

import argparse
import warnings
from copy import deepcopy
from pathlib import Path

from sbayes_tpu_torch.experiment import Experiment
from sbayes_tpu_torch.utils import PathLike, update_recursive


def _run(config, experiment_name, custom_settings, run_ids, device):
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    experiment = Experiment(config_file=config, experiment_name=experiment_name,
                            custom_settings=custom_settings, log=True, i_run=run_ids[0])
    if experiment.config.mcmc.mc3.activate:
        raise NotImplementedError("MC3 is not ported yet (MC3 slice)")
    data = Data.from_experiment(experiment)
    data.logger = None
    mcmc = MCMCSetup(data=data, experiment=experiment, device=device)
    mcmc.log_setup()
    mcmc.sample_ensemble(run_ids=run_ids)


def main(config: PathLike, experiment_name: str = None, custom_settings: dict = None,
         resume: bool = False, n_clusters=None, i_run: int = None, device: str = "cuda"):
    if resume:
        raise NotImplementedError("resume is not ported yet (resume slice)")
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
    for k in n_clusters:
        run_settings = deepcopy(custom_settings) if custom_settings else {}
        update_recursive(run_settings, {"model": {"clusters": int(k)}})
        _run(config, experiment.experiment_name, run_settings, run_ids, device)


def _str2bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "y", "on"):
        return True
    if v.lower() in ("0", "false", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"Expected a boolean, got {v!r}")


def cli(args=None):
    parser = argparse.ArgumentParser(
        description="MCMC to detect clusters in the presence of confounders (PyTorch, CUDA).")
    parser.add_argument("config", type=Path, help="The YAML (or JSON) configuration file")
    parser.add_argument("-n", "--name", nargs="?", type=str,
                        help="Experiment name (results directory; default: date/time).")
    parser.add_argument("-r", "--resume", nargs="?", type=_str2bool, const=True, default=False,
                        help="Resume a previous run (not ported yet).")
    parser.add_argument("-K", "--numClusters", nargs="*", type=int,
                        help="Number of clusters (overrides config; multiple => multiple runs).")
    parser.add_argument("-i", "--runID", nargs="?", type=int,
                        help="Index of this run (to distinguish runs with the same K/name).")
    parser.add_argument("--device", default="cuda",
                        help="torch device to sample on (default: cuda).")
    ns = parser.parse_args(args)
    if not Path(ns.config).is_file():
        parser.error(f"Config file not found: {ns.config}")
    main(config=ns.config, experiment_name=ns.name, resume=ns.resume,
         n_clusters=ns.numClusters, i_run=ns.runID, device=ns.device)


if __name__ == "__main__":
    cli()
