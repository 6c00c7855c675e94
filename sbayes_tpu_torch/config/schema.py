"""Config schema: the sections, keys, defaults and checks of
``sbayes_tpu/config/schema.py``, written with stdlib dataclasses.

The JAX package validates with pydantic; the PyTorch port must import on
machines without it, so each class here keeps the same field names,
defaults, enums and validators and builds from nested dicts through
``from_dict``:

* unknown keys raise (pydantic ``extra="forbid"``), deprecated keys warn
  and are dropped, a missing key of a field without a default raises
  (``required`` in the field's metadata);
* "before" validators run on the raw dict (``_before``), "after"
  validators on the built object (``_after``);
* relative file and directory paths resolve against the config file's
  directory (``RelativePath.BASE_DIR``).

JSON configs are read with ``json``, YAML configs with the port's own
reader (``config/yaml_reader.py``, no PyYAML).
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field, fields, is_dataclass
from enum import Enum
from pathlib import Path
from typing import Dict, List, Optional, Union

from sbayes_tpu_torch.config import yaml_reader
from sbayes_tpu_torch.utils import PathLike, decompose_config_path, fix_relative_path, update_recursive


class RelativePath:
    """Paths resolved relative to the config file location.

    ``BASE_DIR`` is set by ``SBayesConfig.from_config_file`` before parsing.
    """

    BASE_DIR = "."

    @classmethod
    def fix_path(cls, value: PathLike) -> Path:
        return fix_relative_path(value, cls.BASE_DIR)


# ----------------------------- converters -----------------------------


def _file_path(v) -> Path:
    path = RelativePath.fix_path(v)
    if not path.is_file():
        raise ValueError(f"Path does not point to a file: {path}")
    return path


def _dir_path(v) -> Path:
    path = RelativePath.fix_path(v)
    os.makedirs(path, exist_ok=True)
    if not path.is_dir():
        raise ValueError(f"Path does not point to a directory: {path}")
    return path


def _number(v, kind, positive=False, non_negative=False, name=""):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"`{name}` must be a number, got {v!r}")
    if kind is int:
        if float(v) != int(v):
            raise ValueError(f"`{name}` must be an integer, got {v!r}")
        v = int(v)
    else:
        v = float(v)
    if positive and not v > 0:
        raise ValueError(f"`{name}` must be > 0, got {v!r}")
    if non_negative and not v >= 0:
        raise ValueError(f"`{name}` must be >= 0, got {v!r}")
    return v


def _pos_int(v, name=""):
    return _number(v, int, positive=True, name=name)


def _pos_float(v, name=""):
    return _number(v, float, positive=True, name=name)


def _non_neg_float(v, name=""):
    return _number(v, float, non_negative=True, name=name)


def _bool(v, name=""):
    if not isinstance(v, bool):
        raise ValueError(f"`{name}` must be a boolean, got {v!r}")
    return v


def _conv(fn, required: bool = False):
    """Field metadata carrying the value converter/validator, and whether
    the field has no default (pydantic's required field)."""
    return {"conv": fn, "required": required}


def _sub(cls):
    return lambda v, name="": v if isinstance(v, cls) else cls.from_dict(v)


def _enum(enum_cls):
    return lambda v, name="": enum_cls(v)


@dataclass
class BaseConfig:
    """Base class: forbid unknown keys, warn on deprecated ones, convert
    and validate each field, then run the class's "after" validator."""

    def __getitem__(self, key):
        return getattr(self, key)

    @classmethod
    def deprecated_attributes(cls) -> list:
        return []

    @classmethod
    def _before(cls, values: dict) -> dict:
        return values

    def _after(self):
        pass

    def __post_init__(self):
        for f in fields(self):
            conv = f.metadata.get("conv")
            if conv is not None:
                setattr(self, f.name, conv(getattr(self, f.name), name=f.name))
        self._after()

    @classmethod
    def from_dict(cls, values) -> "BaseConfig":
        if not isinstance(values, dict):
            raise ValueError(f"{cls.__name__} expects a mapping, got {type(values).__name__}")
        values = dict(values)
        for key in cls.deprecated_attributes():
            if key in values:
                warnings.warn(
                    f"The {key} key in {cls.__name__} is deprecated "
                    f"and will be removed in future versions."
                )
                values.pop(key)
        missing = [f.name for f in fields(cls)
                   if f.metadata.get("required") and f.name not in values]
        if missing:
            raise ValueError(f"{cls.__name__}: missing required fields {missing}")
        values = cls._before(values)
        names = {f.name for f in fields(cls)}
        extra = sorted(set(values) - names)
        if extra:
            raise ValueError(f"{cls.__name__}: extra inputs are not permitted: {extra}")
        return cls(**values)

    def model_dump(self) -> dict:
        return {f.name: _dump(getattr(self, f.name)) for f in fields(self)}


def _dump(v):
    if is_dataclass(v):
        return v.model_dump()
    if isinstance(v, dict):
        return {k: _dump(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dump(x) for x in v]
    return v


# ============================= PRIOR CONFIGS =============================


class _GeoTypes(str, Enum):
    UNIFORM = "uniform"
    COST_BASED = "cost_based"
    SIMULATED = "simulated"


class _Aggregation(str, Enum):
    MEAN = "mean"
    SUM = "sum"
    MAX = "max"


class _ProbabilityFunction(str, Enum):
    EXPONENTIAL = "exponential"
    SIGMOID = "sigmoid"


class _Skeleton(str, Enum):
    MST = "mst"
    DELAUNAY = "delaunay"
    DIAMETER = "diameter"
    COMPLETE = "complete_graph"


def _costs(v, name=""):
    return v if v == "from_data" else _file_path(v)


def _opt(conv):
    return lambda v, name="": None if v is None else conv(v, name=name)


@dataclass
class GeoPriorConfig(BaseConfig):
    """Configuration of the geo-prior."""

    Types = _GeoTypes
    AggregationStrategies = _Aggregation
    ProbabilityFunction = _ProbabilityFunction
    Skeleton = _Skeleton

    type: _GeoTypes = field(default=_GeoTypes.UNIFORM, metadata=_conv(_enum(_GeoTypes)))
    """Type of prior distribution. Choose from: [uniform, cost_based, simulated]."""
    costs: Union[Path, str] = field(default="from_data", metadata=_conv(_costs))
    """Source of geographic costs: `from_data` (geodesic distances) or a CSV file path."""
    aggregation: _Aggregation = field(default=_Aggregation.MEAN, metadata=_conv(_enum(_Aggregation)))
    """How costs of single edges are aggregated: [mean, sum, max]."""
    probability_function: _ProbabilityFunction = field(
        default=_ProbabilityFunction.EXPONENTIAL, metadata=_conv(_enum(_ProbabilityFunction)))
    """Monotonic function mapping aggregated costs to prior probabilities."""
    rate: Optional[float] = field(default=None, metadata=_conv(_opt(_pos_float)))
    """Rate of probability decrease for a cost_based geo-prior (required if cost_based)."""
    inflection_point: Optional[float] = field(
        default=None, metadata=_conv(_opt(lambda v, name="": _number(v, float, name=name))))
    """Sigmoid inflection point (required if probability_function=sigmoid)."""
    skeleton: _Skeleton = field(default=_Skeleton.MST, metadata=_conv(_enum(_Skeleton)))
    """Graph along which costs are aggregated: [mst, delaunay, diameter, complete_graph]."""

    @classmethod
    def _before(cls, values):
        if values.get("type") == "cost_based" and values.get("rate") is None:
            raise ValueError("Field `rate` is required for geo-prior of type `cost_based`.")
        return values


class _SizeTypes(str, Enum):
    UNIFORM_AREA = "uniform_area"
    UNIFORM_SIZE = "uniform_size"
    QUADRATIC_SIZE = "quadratic"


@dataclass
class ClusterSizePriorConfig(BaseConfig):
    """Configuration of the cluster-size prior."""

    Types = _SizeTypes

    type: _SizeTypes = field(default=None, metadata=_conv(_enum(_SizeTypes), required=True))
    """Type of prior distribution: [uniform_area, uniform_size, quadratic]."""
    min: int = field(default=2, metadata=_conv(_pos_int))
    """Minimum cluster size."""
    max: int = field(default=10000, metadata=_conv(_pos_int))
    """Maximum cluster size."""


class _DirichletTypes(str, Enum):
    UNIFORM = "uniform"
    DIRICHLET = "dirichlet"
    JEFFREYS = "jeffreys"
    BBS = "BBS"
    UNIVERSAL = "universal"
    SYMMETRIC_DIRICHLET = "symmetric_dirichlet"


def _opt_dict(v, name=""):
    if v is not None and not isinstance(v, dict):
        raise ValueError(f"`{name}` must be a mapping")
    return v


@dataclass
class DirichletPriorConfig(BaseConfig):

    Types = _DirichletTypes

    type: _DirichletTypes = field(default=_DirichletTypes.UNIFORM,
                                  metadata=_conv(_enum(_DirichletTypes)))
    """Type of prior: [uniform, dirichlet, jeffreys, BBS, symmetric_dirichlet]."""
    file: Optional[Path] = field(default=None, metadata=_conv(_opt(lambda v, name="": _file_path(v))))
    """Path to Dirichlet parameters (YAML or JSON). This or `parameters` required if dirichlet."""
    parameters: Optional[Dict] = field(default=None, metadata=_conv(_opt_dict))
    """Inline Dirichlet parameters. This or `file` required if type=dirichlet."""
    prior_concentration: Optional[float] = field(
        default=None, metadata=_conv(_opt(lambda v, name="": _number(v, float, name=name))))
    """Concentration value (required if type=symmetric_dirichlet or universal)."""

    @classmethod
    def _before(cls, values):
        if "type" not in values:
            warnings.warn(f"No `type` defined for `{cls.__name__}`. Using `uniform` as a default.")
        return values

    def _after(self):
        cls_name = type(self).__name__
        T = _DirichletTypes
        if self.type == T.DIRICHLET:
            if self.file is None and self.parameters is None:
                raise ValueError(f"Provide `file` or `parameters` for `{cls_name}` of type `dirichlet`.")
        elif self.type in [T.UNIVERSAL, T.SYMMETRIC_DIRICHLET]:
            if self.prior_concentration is None:
                raise ValueError(f"Provide `prior_concentration` for `{cls_name}` of type `{self.type}`.")
        if self.type == T.UNIVERSAL:
            type_options = [t.value for t in T if t != T.UNIVERSAL]
            raise NotImplementedError(
                f"The hierarchical prior type `universal` is not implemented yet."
                f" Choose one of the following prior types: {type_options}"
            )

    def dict(self) -> dict:
        self_dict = self.model_dump()
        if self.type is _DirichletTypes.UNIFORM:
            self_dict.pop("file", None)
            self_dict.pop("parameters", None)
        elif self.file is not None:
            self_dict.pop("parameters", None)
        elif self.parameters is not None:
            self_dict.pop("file", None)
        return self_dict


@dataclass
class WeightsPriorConfig(DirichletPriorConfig):
    """Prior on the weights of the mixture components."""


@dataclass
class ConfoundingEffectPriorConfig(DirichletPriorConfig):
    """Prior on the parameters of the confounding-effects."""


@dataclass
class ClusterEffectConfig(DirichletPriorConfig):
    """Prior on the parameters of the cluster-effect."""


def _confounding_effects(v, name=""):
    if not isinstance(v, dict):
        raise ValueError("`confounding_effects` must be a mapping")
    return {
        conf: {g: _sub(ConfoundingEffectPriorConfig)(cfg) for g, cfg in groups.items()}
        for conf, groups in v.items()
    }


@dataclass
class PriorConfig(BaseConfig):
    """Configuration of all priors of the model."""

    confounding_effects: Dict[str, Dict[str, ConfoundingEffectPriorConfig]] = field(
        default=None, metadata=_conv(_confounding_effects, required=True))
    """The priors for the confounding effects in each group of each confounder."""
    cluster_effect: ClusterEffectConfig = field(
        default=None, metadata=_conv(_sub(ClusterEffectConfig), required=True))
    geo: GeoPriorConfig = field(default=None, metadata=_conv(_sub(GeoPriorConfig), required=True))
    objects_per_cluster: ClusterSizePriorConfig = field(
        default=None, metadata=_conv(_sub(ClusterSizePriorConfig), required=True))
    weights: WeightsPriorConfig = field(
        default=None, metadata=_conv(_sub(WeightsPriorConfig), required=True))


def _clusters(v, name=""):
    if isinstance(v, list):
        return [int(x) for x in v]
    return _number(v, int, name=name)


def _str_list(v, name=""):
    if not isinstance(v, list) or not all(isinstance(x, str) for x in v):
        raise ValueError(f"`{name}` must be a list of strings")
    return list(v)


@dataclass
class ModelConfig(BaseConfig):
    """Configuration of the model."""

    clusters: Union[int, List[int]] = field(default=1, metadata=_conv(_clusters))
    """The number of clusters to be inferred."""
    confounders: List[str] = field(default_factory=list, metadata=_conv(_str_list))
    """The list of confounder names."""
    prior: PriorConfig = field(default=None, metadata=_conv(_sub(PriorConfig), required=True))
    """The priors of the model."""

    @classmethod
    def deprecated_attributes(cls) -> list:
        return ["sample_source"]

    @classmethod
    def _before(cls, values):
        for conf in values.get("confounders", []):
            if conf not in values["prior"]["confounding_effects"]:
                raise NameError(f"Prior for the confounder '{conf}' is not defined in the config file.")
        return values


@dataclass
class OperatorsConfig(BaseConfig):
    """Relative frequency of each MCMC operator family (normalized at runtime)."""

    clusters: float = field(default=70.0, metadata=_conv(_non_neg_float))
    """Frequency of cluster-membership updates."""
    weights: float = field(default=10.0, metadata=_conv(_non_neg_float))
    """Frequency of mixture-weight updates."""
    source: float = field(default=20.0, metadata=_conv(_non_neg_float))
    """Frequency of source (observation-component assignment) updates."""

    @classmethod
    def deprecated_attributes(cls) -> list:
        return ["cluster_effect", "confounding_effects"]


@dataclass
class WarmupConfig(BaseConfig):
    """Configuration of the warm-up phase."""

    warmup_steps: int = field(default=50000, metadata=_conv(_pos_int))
    """Number of steps in the warm-up phase."""
    warmup_chains: int = field(default=10, metadata=_conv(_pos_int))
    """Number of parallel chains in the warm-up phase (vmapped on TPU)."""


def _init_method(v, name=""):
    if v not in ("em", "seed_points", "random_growth"):
        raise ValueError(f"`method` must be one of em, seed_points, random_growth; got {v!r}")
    return v


@dataclass
class InitializationConfig(BaseConfig):
    """Configuration of the per-chain sample initializer."""

    attempts: int = field(default=10, metadata=_conv(_pos_int))
    """Number of initial samples per warm-up chain; the best (by likelihood) is kept."""
    em_steps: int = field(default=50, metadata=_conv(_pos_int))
    """Number of steps in the expectation-maximization initializer."""
    objects_per_cluster: int = field(default=10, metadata=_conv(_pos_int))
    """Average number of objects per cluster in the initialization phase."""
    initial_cluster_steps: bool = field(default=True, metadata=_conv(_bool))
    """If true, apply an initial deterministic cluster step to each cluster."""
    method: str = field(default="em", metadata=_conv(_init_method))
    """Initial-cluster construction: 'em' = annealed EM soft clustering
    (reference SbayesInitializer, initializers.py:93-169); 'seed_points' =
    one random seed object per cluster (reference initialize_clusters,
    initializers.py:336-351); 'random_growth' = adjacency-constrained
    random growth to the initial size (reference grow_random_clusters,
    initializers.py:353-442)."""


def _prior_temp_diff(v, name=""):
    return v if v == "temperature_diff" else _pos_float(v, name=name)


@dataclass
class MC3Config(BaseConfig):
    """Metropolis-coupled MCMC (MC3 / parallel tempering) parameters."""

    activate: bool = field(default=False, metadata=_conv(_bool))
    """If true, use MC3 sampling."""
    chains: int = field(default=4, metadata=_conv(_pos_int))
    """Number of MC3 chains."""
    swap_interval: int = field(default=1000, metadata=_conv(_pos_int))
    """Number of MCMC steps between chain-swap attempts."""
    swap_attempts: int = field(default=100, metadata=_conv(_pos_int))
    """Number of chain pairs proposed to swap after each interval."""
    only_swap_adjacent_chains: bool = field(default=False, metadata=_conv(_bool))
    """Only swap chains adjacent in the temperature schedule."""
    temperature_diff: float = field(default=0.05, metadata=_conv(_pos_float))
    """Difference between temperatures of MC3 chains."""
    prior_temperature_diff: Union[float, str] = field(
        default="temperature_diff", metadata=_conv(_prior_temp_diff))
    """Difference between prior-temperatures (defaults to `temperature_diff`)."""
    exponential_temperatures: bool = field(default=False, metadata=_conv(_bool))
    """If true, temperatures grow exponentially ((1+dt)**i) instead of linearly (1+dt*i)."""
    log_swap_matrix: bool = field(default=True, metadata=_conv(_bool))
    """If true, log the matrix of accepted swaps between chain pairs."""

    @classmethod
    def deprecated_attributes(cls) -> list:
        return ["only_heat_likelihood"]

    def _after(self):
        if self.activate and self.chains < 2:
            self.activate = False
            warnings.warn("Deactivated MC3, as it is pointless with less than 2 chains.")
        if self.only_swap_adjacent_chains:
            valid_chain_pairs = self.chains - 1
        else:
            valid_chain_pairs = int(self.chains * (self.chains - 1) / 2)
        if self.swap_attempts > valid_chain_pairs:
            self.swap_attempts = valid_chain_pairs
        if self.prior_temperature_diff == "temperature_diff":
            self.prior_temperature_diff = self.temperature_diff


def _unit_interval(v, name=""):
    v = _number(v, float, name=name)
    if not 0 <= v <= 1:
        raise ValueError(f"`{name}` must lie in [0, 1], got {v!r}")
    return v


@dataclass
class MCMCConfig(BaseConfig):
    """Configuration of MCMC parameters."""

    steps: int = field(default=1000000, metadata=_conv(_pos_int))
    """Total number of iterations in the MCMC chain."""
    samples: int = field(default=1000, metadata=_conv(_pos_int))
    """Number of samples to be generated."""
    runs: int = field(default=1, metadata=_conv(_pos_int))
    """Number of independent repetitions of the sampling."""
    sample_from_prior: bool = field(default=False, metadata=_conv(_bool))
    """If true, ignore the data and sample from the prior."""
    grow_to_adjacent: float = field(default=0.8, metadata=_conv(_unit_interval))
    """Fraction of grow-steps restricted to adjacent objects. Accepted for
    config compatibility but inert: the reference stores it as
    ClusterOperator.p_grow_connected (operators.py:721) and never reads it
    either — neighbourhood restriction is set per scheduled operator."""
    screen_log_interval: int = field(default=1000, metadata=_conv(_pos_int))
    """Step interval of screen-log lines."""
    operators: OperatorsConfig = field(default_factory=OperatorsConfig,
                                       metadata=_conv(_sub(OperatorsConfig)))
    initialization: InitializationConfig = field(default_factory=InitializationConfig,
                                                 metadata=_conv(_sub(InitializationConfig)))
    warmup: WarmupConfig = field(default_factory=WarmupConfig, metadata=_conv(_sub(WarmupConfig)))
    mc3: MC3Config = field(default_factory=MC3Config, metadata=_conv(_sub(MC3Config)))

    @classmethod
    def _before(cls, values):
        if "init_objects_per_cluster" in values:
            if "initialization" in values and "objects_per_cluster" in values["initialization"]:
                raise ValueError(
                    "The `init_objects_per_cluster` field was moved to `initialization > "
                    "objects_per_cluster`. Please remove the old `init_objects_per_cluster` entry."
                )
            values.setdefault("initialization", {})
            values["initialization"]["objects_per_cluster"] = values.pop("init_objects_per_cluster")
            warnings.warn(
                "The `init_objects_per_cluster` field was moved to `initialization > objects_per_cluster`."
            )
        return values

    def _after(self):
        if self.steps % self.samples != 0:
            raise ValueError("Inconsistent spacing between samples. Set `steps` to be a multiple of `samples`.")


def _str(v, name=""):
    if not isinstance(v, str):
        raise ValueError(f"`{name}` must be a string")
    return v


@dataclass
class DataConfig(BaseConfig):
    """Information on the data of an analysis."""

    features: Path = field(default=None,
                           metadata=_conv(lambda v, name="": _file_path(v), required=True))
    """Path to the CSV file with the features used for the analysis."""
    feature_states: Path = field(default=None,
                                 metadata=_conv(lambda v, name="": _file_path(v), required=True))
    """Path to the CSV file defining the possible states of each feature."""
    projection: str = field(default="epsg:4326", metadata=_conv(_str))
    """String identifier of the projection in which locations are given."""


@dataclass
class ResultsConfig(BaseConfig):
    """Information on where and how results are written."""

    path: Path = field(default_factory=lambda: RelativePath.fix_path("./results"))
    """Path to the results directory."""
    log_file: bool = field(default=True, metadata=_conv(_bool))
    """Whether to write log messages to a file."""
    log_likelihood: bool = field(default=True, metadata=_conv(_bool))
    """Whether to log the likelihood of each observation to an HDF5 file."""
    log_source: bool = field(default=False, metadata=_conv(_bool))
    """Whether to log per-feature component assignment fractions."""
    log_hot_chains: bool = field(default=True, metadata=_conv(_bool))
    """Whether to write results files for hot MC3 chains."""
    float_precision: int = field(default=8, metadata=_conv(_pos_int))
    """Number of decimal places of real-valued parameters in the stats file."""
    log_contribution_per_cluster: bool = field(default=False, metadata=_conv(_bool))
    """Whether to log per-cluster likelihood/prior contribution columns
    (post_a*, lh_a*, prior_a*) in the stats file."""
    log_operator_step_times: bool = field(default=True, metadata=_conv(_bool))
    """Whether to measure per-operator step times (one timing probe per
    run; adds a few small compilations) for the operator_stats file."""

    @classmethod
    def from_dict(cls, values) -> "ResultsConfig":
        # pydantic validates (and creates) only a GIVEN path, not the default
        values = dict(values)
        if "path" in values:
            values["path"] = _dir_path(values["path"])
        return super().from_dict(values)


@dataclass
class SBayesConfig(BaseConfig):
    data: DataConfig = field(default=None, metadata=_conv(_sub(DataConfig), required=True))
    model: ModelConfig = field(default=None, metadata=_conv(_sub(ModelConfig), required=True))
    mcmc: MCMCConfig = field(default=None, metadata=_conv(_sub(MCMCConfig), required=True))
    results: ResultsConfig = field(default_factory=ResultsConfig, metadata=_conv(_sub(ResultsConfig)))

    @classmethod
    def from_config_file(cls, path: PathLike, custom_settings: Optional[dict] = None) -> "SBayesConfig":
        """Create an SBayesConfig from a YAML or JSON config file."""
        base_directory, _config_file = decompose_config_path(path)
        RelativePath.BASE_DIR = base_directory

        path_str = str(path).lower()
        if path_str.endswith(".yaml") or path_str.endswith("yml"):
            config_dict = yaml_reader.load(path)
        else:
            with open(path, "r") as f:
                config_dict = json.load(f)

        if custom_settings:
            update_recursive(config_dict, custom_settings)

        return cls.from_dict(config_dict)

    def update(self, other: dict) -> "SBayesConfig":
        new_dict = update_recursive(self.model_dump(), other)
        return type(self).from_dict(new_dict)
