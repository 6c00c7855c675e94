"""Streaming results loggers: the compatibility contract of the framework.

File formats must match the reference exactly so existing consumers work
unchanged (sBlot plots, Tracer traces, the ELPD tool):
  * ``stats_K{k}_{run}.txt``      — TSV of all real-valued params + stats
    (reference: sbayes/sampling/loggers.py:64-262)
  * ``clusters_K{k}_{run}.txt``   — one row per sample: tab-separated
    bit-strings per cluster (ref: loggers.py:265-301)
  * ``likelihood_K{k}_{run}.h5``  — float32 per-observation likelihoods
    (ref: loggers.py:304-359; h5py instead of PyTables, same dataset names)
  * ``operator_stats_K{k}_{run}.txt`` — per-operator statistics table
  * ``state_K{k}_{run}.pickle``   — full chain state for resume
"""
from __future__ import annotations

import pickle
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, TextIO

import numpy as np
from numpy.typing import NDArray

from sbayes_tpu_torch.model.constants import ModelConstants
from sbayes_tpu_torch.utils import format_cluster_columns, get_best_permutation


def _np(x) -> NDArray:
    """A host numpy copy of a model constant (the constants are torch
    tensors on the model's device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class SampleRecord:
    """Host-side snapshot of a chain state at a logging step."""

    i_step: int
    clusters: NDArray            # bool (K, N)
    weights: NDArray             # f32 (F, C)
    source: NDArray              # bool (N, F, C), or the packed int8 (N, F) (C = NA)
    log_lh: float
    log_prior: float
    # prior decomposition
    size_prior: float = 0.0
    geo_prior: float = 0.0
    weights_prior: float = 0.0
    source_prior: float = 0.0
    # sufficient statistics for posterior-mean/sampled effects
    cluster_counts: Optional[NDArray] = None   # (K, F, S)
    conf_counts: Optional[NDArray] = None      # (C-1, Gmax, F, S)
    # per-observation likelihood (for the likelihood logger)
    observation_lh: Optional[NDArray] = None   # (N, F)
    # per-cluster isolated contribution (for log_contribution_per_cluster)
    cluster_contribution_lh: Optional[NDArray] = None     # (K,)
    cluster_contribution_prior: Optional[NDArray] = None  # (K,)
    chain: int = 0

    def to_state_dict(self) -> dict:
        return {
            "clusters": self.clusters,
            "weights": self.weights,
            "source": self.source,
            "log_lh": self.log_lh,
            "log_prior": self.log_prior,
            "prior_parts": np.asarray(
                [self.size_prior, self.geo_prior, self.weights_prior, self.source_prior],
                dtype=np.float32,
            ),
            "i_step": self.i_step,
        }


class ResultsLogger(ABC):
    def __init__(self, path, consts: ModelConstants, data, resume: bool):
        self.path = Path(path)
        self.consts = consts
        self.data = data
        self.file: Optional[TextIO] = None
        self.resume = resume

    @abstractmethod
    def write_header(self, sample: SampleRecord):
        ...

    @abstractmethod
    def _write_sample(self, sample: SampleRecord):
        ...

    def write_sample(self, sample: SampleRecord):
        if self.file is None:
            self.open()
            self.write_header(sample)
        self._write_sample(sample)

    def open(self):
        self.file = open(self.path, "a" if self.resume else "w", buffering=1)

    def close(self):
        if self.file:
            self.file.close()
            self.file = None


def _sample_dirichlet_effects(rng, counts, prior_counts, applicable):
    """Draw categorical effect vectors ~ Dirichlet(counts + prior) per group
    and feature over the applicable states (host-side; reference behavior:
    conditionals.py:125-149 ``conditional_effect_sample``)."""
    conc = counts + prior_counts
    gamma = rng.gamma(np.maximum(conc, 1e-9))
    gamma = np.where(applicable, gamma, 0.0)
    total = gamma.sum(-1, keepdims=True)
    return gamma / np.maximum(total, 1e-35)


class ParametersCSVLogger(ResultsLogger):
    """The tab-separated stats file consumed by Tracer and sBlot."""

    def __init__(self, *args, log_source: bool = False, float_format: str = "%.8g",
                 match_clusters: bool = True, log_sample_id: bool = True, seed: int = 0,
                 log_contribution_per_cluster: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.float_format = float_format
        self.match_clusters = match_clusters
        self.log_source = log_source
        self.log_sample_id = log_sample_id
        self.log_contribution_per_cluster = log_contribution_per_cluster
        self.rng = np.random.default_rng(seed)
        self.cluster_sum = np.zeros((self.consts.K, self.consts.N), dtype=int)
        self.column_names: Optional[list] = None

    def write_header(self, sample: SampleRecord):
        c = self.consts
        feature_names = list(self.data.features.names)
        state_names = self.data.features.state_names

        column_names = ["Sample", "posterior", "likelihood", "prior"]
        if c.K <= 1:
            self.match_clusters = False

        for i in range(c.K):
            column_names.append(f"size_a{i}")

        # weights, interleaved per feature: areal first, then each confounder
        for f in feature_names:
            column_names.append(f"w_areal_{f}")
            for conf in c.conf_names:
                column_names.append(f"w_{conf}_{f}")

        # areal (cluster) effects
        for i_a in range(c.K):
            for i_f, f in enumerate(feature_names):
                for s in state_names[i_f]:
                    column_names.append(f"areal_a{i_a}_{f}_{s}")

        # confounding effects
        for conf in c.conf_names:
            for g in c.group_names[conf]:
                for i_f, f in enumerate(feature_names):
                    for s in state_names[i_f]:
                        column_names.append(f"{conf}_{g}_{f}_{s}")

        if self.log_source:
            for f in feature_names:
                for comp in ["clusters", *c.conf_names]:
                    column_names.append(f"source_{comp}_{f}")

        # per-cluster lh/prior/posterior contributions (reference column
        # order: loggers.py:140-143, right before the prior columns)
        if self.log_contribution_per_cluster:
            for i in range(c.K):
                column_names += [f"post_a{i}", f"lh_a{i}", f"prior_a{i}"]

        column_names += ["cluster_size_prior", "geo_prior", "source_prior", "weights_prior"]
        if self.log_sample_id:
            column_names.append("sample_id")

        self.column_names = column_names
        if not self.resume:
            self.file.write("\t".join(column_names) + "\n")

    def _write_sample(self, sample: SampleRecord):
        c = self.consts
        feature_names = list(self.data.features.names)
        state_names = self.data.features.state_names
        applicable = _np(c.applicable)

        clusters = sample.clusters
        cluster_effect = _sample_dirichlet_effects(
            self.rng, sample.cluster_counts, _np(c.conc_cluster)[None], applicable[None]
        )
        contrib_lh = sample.cluster_contribution_lh
        contrib_prior = sample.cluster_contribution_prior

        if self.match_clusters:
            permutation = get_best_permutation(clusters, self.cluster_sum)
            cluster_effect = cluster_effect[permutation]
            clusters = clusters[permutation]
            if contrib_lh is not None:
                contrib_lh = contrib_lh[permutation]
                contrib_prior = contrib_prior[permutation]
            self.cluster_sum += clusters

        row: dict = {
            "Sample": sample.i_step,
            "posterior": sample.log_lh + sample.log_prior,
            "likelihood": sample.log_lh,
            "prior": sample.log_prior,
        }
        for i, cl in enumerate(clusters):
            row[f"size_a{i}"] = int(np.count_nonzero(cl))

        for i_f, f in enumerate(feature_names):
            row[f"w_areal_{f}"] = sample.weights[i_f, 0]
            for i_conf, conf in enumerate(c.conf_names, start=1):
                row[f"w_{conf}_{f}"] = sample.weights[i_f, i_conf]

        for i_a in range(c.K):
            for i_f, f in enumerate(feature_names):
                for i_s, s in enumerate(state_names[i_f]):
                    row[f"areal_a{i_a}_{f}_{s}"] = cluster_effect[i_a, i_f, i_s]

        for i_conf, conf in enumerate(c.conf_names):
            n_g = len(c.group_names[conf])
            conf_effect = _sample_dirichlet_effects(
                self.rng,
                sample.conf_counts[i_conf, :n_g],
                _np(c.conc_conf)[i_conf, :n_g],
                applicable[None],
            )
            for i_g, g in enumerate(c.group_names[conf]):
                for i_f, f in enumerate(feature_names):
                    for i_s, s in enumerate(state_names[i_f]):
                        row[f"{conf}_{g}_{f}_{s}"] = conf_effect[i_g, i_f, i_s]

        if self.log_source:
            source = sample.source
            if source.dtype == np.int8:  # the packed form: expanded here only
                source = source[..., None] == np.arange(c.C)
            mean_source = source.mean(axis=0)  # (F, C)
            for i_f, f in enumerate(feature_names):
                for i_c, comp in enumerate(["clusters", *c.conf_names]):
                    row[f"source_{comp}_{f}"] = mean_source[i_f, i_c]

        if self.log_contribution_per_cluster:
            for i in range(c.K):
                lh_i = contrib_lh[i] if contrib_lh is not None else float("nan")
                pr_i = contrib_prior[i] if contrib_prior is not None else float("nan")
                row[f"lh_a{i}"] = lh_i
                row[f"prior_a{i}"] = pr_i
                row[f"post_a{i}"] = lh_i + pr_i

        row["cluster_size_prior"] = sample.size_prior
        row["geo_prior"] = sample.geo_prior
        row["source_prior"] = sample.source_prior
        row["weights_prior"] = sample.weights_prior
        if self.log_sample_id:
            row["sample_id"] = sample.chain

        # Integer columns (Sample, size_a*, sample_id) are written exactly:
        # pushing the step counter through float_format ("%.8g") would lose
        # integer precision past 1e8 steps (the reference writes it exactly,
        # loggers.py:186).
        def _fmt(v):
            if isinstance(v, (int, np.integer)):
                return str(int(v))
            return self.float_format % v

        row_str = "\t".join(_fmt(row[k]) for k in self.column_names)
        self.file.write(row_str + "\n")


class ClustersLogger(ResultsLogger):
    """Bit-string cluster rows, label-aligned across samples."""

    def __init__(self, *args, match_clusters: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.match_clusters = match_clusters
        self.cluster_sum: Optional[NDArray] = None

    def write_header(self, sample: SampleRecord):
        if self.consts.K <= 1:
            self.match_clusters = False
        self.cluster_sum = np.zeros((self.consts.K, self.consts.N), dtype=int)

    def _write_sample(self, sample: SampleRecord):
        if self.match_clusters:
            permutation = get_best_permutation(sample.clusters, self.cluster_sum)
            clusters = sample.clusters[permutation]
            self.cluster_sum += clusters
        else:
            clusters = sample.clusters
        self.file.write(format_cluster_columns(clusters) + "\n")


def require_likelihood_writer(config) -> None:
    """Raise before a run starts if it would log the likelihood file (HDF5,
    written with h5py) where h5py is not installed."""
    if config.mcmc.sample_from_prior or not config.results.log_likelihood:
        return
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "`results.log_likelihood` is true, and the likelihood file is HDF5, written with "
            "h5py, which is not installed: set `results.log_likelihood: false` or install "
            "h5py.") from e


class LikelihoodLogger(ResultsLogger):
    """Per-observation likelihoods to HDF5 (same dataset names as the
    reference's PyTables file: 'likelihood' and 'na_values')."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lh_ds = None

    def open(self):
        import h5py

        if self.resume and self.path.exists():
            try:
                self.file = h5py.File(self.path, "a")
                return
            except OSError:
                import logging

                logging.warning(
                    f"Could not append to existing likelihood file '{self.path.name}'. Overwriting."
                )
                self.resume = False
        self.file = h5py.File(self.path, "w")

    def write_header(self, sample: SampleRecord):
        n_obs = self.consts.N * self.consts.F
        if self.resume and "likelihood" in self.file:
            self._lh_ds = self.file["likelihood"]
        else:
            self._lh_ds = self.file.create_dataset(
                "likelihood", shape=(0, n_obs), maxshape=(None, n_obs),
                dtype=np.float32, compression="gzip", compression_opts=4,
                fletcher32=True,
            )
            self.file.create_dataset(
                "na_values", data=_np(self.consts.na).ravel(),
                dtype=bool, compression="gzip", fletcher32=True,
            )

    def _write_sample(self, sample: SampleRecord):
        lh = np.asarray(sample.observation_lh, dtype=np.float32).ravel()[None, :]
        self._lh_ds.resize(self._lh_ds.shape[0] + 1, axis=0)
        self._lh_ds[-1] = lh
        self.file.flush()

    def close(self):
        if self.file:
            self.file.close()
            self.file = None


@dataclass
class OperatorView:
    """Host-side view of one operator's statistics for logging."""

    name: str
    accepts: int
    rejects: int
    step_size_sum: float
    mean_step_time_s: float
    parameters: dict = field(default_factory=dict)

    @property
    def total(self):
        return self.accepts + self.rejects

    @property
    def acceptance_rate(self):
        return self.accepts / self.total if self.total else 0.0


class OperatorStatsLogger(ResultsLogger):
    """Rewrites the operator-statistics table each logging interval
    (reference: loggers.py:362-423)."""

    COLUMNS = {
        "OPERATOR": 27,
        "ACCEPTS": 8,
        "REJECTS": 8,
        "TOTAL": 8,
        "ACCEPT-RATE": 11,
        "STEP-SIZE": 11,
        "STEP-TIME": 11,
        "PARAMETERS": 0,
    }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.operators: list[OperatorView] = []
        self.probed = False      # STEP-TIME from the per-operator timing probe

    def write_sample(self, sample: SampleRecord):
        with open(self.path, "w") as f:
            if self.probed:
                f.write("# STEP-TIME is a per-run probe estimate (each operator timed "
                        "alone on a copy of the chain batch at run start and mid-run), "
                        "not an in-run distribution.\n")
            else:
                f.write("# STEP-TIME is the run's mean wall time per step over all "
                        "operators (the timing probe is off).\n")
            f.write(self.get_log_message_header() + "\n")
            for op in self.operators:
                f.write(self.get_log_message_row(op) + "\n")

    @classmethod
    def get_log_message_header(cls) -> str:
        return " ".join(col.ljust(w) for col, w in cls.COLUMNS.items())

    @classmethod
    def get_log_message_row(cls, op: OperatorView) -> str:
        if op.total == 0:
            cells = [op.name] + ["-"] * (len(cls.COLUMNS) - 1)
            return " ".join(str(x).ljust(w) for x, w in zip(cells, cls.COLUMNS.values()))
        mean_step_size = op.step_size_sum / op.accepts if op.accepts else 0.0
        params_str = "[" + ", ".join(f"{k}={v}" for k, v in op.parameters.items()) + "]"
        cells = [
            op.name.ljust(cls.COLUMNS["OPERATOR"]),
            str(op.accepts).ljust(cls.COLUMNS["ACCEPTS"]),
            str(op.rejects).ljust(cls.COLUMNS["REJECTS"]),
            str(op.total).ljust(cls.COLUMNS["TOTAL"]),
            f"{op.acceptance_rate:.2%}".ljust(cls.COLUMNS["ACCEPT-RATE"]),
            f"{mean_step_size:.2f}".ljust(cls.COLUMNS["STEP-SIZE"]),
            f"{1000 * op.mean_step_time_s:.2f} ms".ljust(cls.COLUMNS["STEP-TIME"]),
            params_str,
        ]
        return " ".join(cells)

    def write_header(self, sample: SampleRecord):
        pass

    def _write_sample(self, sample: SampleRecord):
        pass


class StateDumper(ResultsLogger):
    """Checkpoints the full chain state each logging interval (resume)."""

    def write_header(self, sample: SampleRecord):
        pass

    def _write_sample(self, sample: SampleRecord):
        pass

    def open(self):
        pass

    def close(self):
        pass

    def write_sample(self, sample: SampleRecord):
        with open(self.path, "wb") as f:
            pickle.dump(sample.to_state_dict(), f)
