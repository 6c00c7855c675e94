"""Experiment setup: config loading, results directory, logging.

Counterpart of the reference's ``Experiment`` (sbayes/experiment_setup.py):
results live in ``<results.path>/<experiment_name>/K<k>/``, the config file
is copied into the results directory and log output goes to a stream + a
per-run log file.
"""
from __future__ import annotations

import datetime
import logging
import os
import shutil
from pathlib import Path

from sbayes_tpu_torch.config.schema import SBayesConfig
from sbayes_tpu_torch.results.loggers import require_likelihood_writer
from sbayes_tpu_torch.utils import PathLike


def default_experiment_name() -> str:
    """Timestamp-based experiment name (e.g. '2026-08-16 05-42')."""
    now = datetime.datetime.now().__str__().rsplit(".")[0]
    now = now[:-3]
    now = now.replace(":", "-")
    return now.replace(" ", "_")


class Experiment:
    def __init__(
        self,
        config_file: PathLike,
        experiment_name: str | None = None,
        custom_settings: dict | None = None,
        log: bool = True,
        i_run: int = 0,
    ):
        self.experiment_name = experiment_name or default_experiment_name()
        self.i_run = i_run
        self.config = SBayesConfig.from_config_file(config_file, custom_settings)
        require_likelihood_writer(self.config)
        self.path_results = self.init_results_directory(self.config, self.experiment_name)

        self.logger = self.init_logger()
        if log:
            self.log_experiment()

        shutil.copy(src=config_file, dst=self.path_results / os.path.basename(config_file))

    @staticmethod
    def init_results_directory(config: SBayesConfig, experiment_name: str) -> Path:
        path_results = config.results.path / experiment_name
        os.makedirs(path_results, exist_ok=True)
        return path_results

    @staticmethod
    def init_logger() -> logging.Logger:
        logger = logging.Logger("sbayesTpuLogger", level=logging.DEBUG)
        logger.addHandler(logging.StreamHandler())
        return logger

    def add_logger_file(self, path_results: Path):
        if not self.config.results.log_file:
            return
        # Reference log-file naming: experiment_K{K}_{run}.log
        # (experiment_setup.py:70-76). ``clusters`` may still be a list when
        # invoked from cli.main before per-K resolution.
        k = self.config.model.clusters
        k_str = "-".join(str(int(x)) for x in k) if isinstance(k, (list, tuple)) else str(k)
        log_path = path_results / f"experiment_K{k_str}_{self.i_run}.log"
        if os.path.exists(log_path):
            os.remove(log_path)
        self.logger.addHandler(logging.FileHandler(filename=log_path))

    def log_experiment(self):
        self.add_logger_file(self.path_results)
        self.logger.info("Experiment: %s", self.experiment_name)
        self.logger.info("File location for results: %s", self.path_results)
        self.logger.info(
            "Start time and date: %s", datetime.datetime.now().strftime("%H:%M:%S %d.%m.%Y")
        )

    def close(self):
        for handler in self.logger.handlers[:]:
            handler.close()
