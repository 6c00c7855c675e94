"""Host-side utilities: encodings, combinatorics, config-dict helpers.

Copy of ``sbayes_tpu/utils.py`` for the PyTorch port. pandas is imported
only inside the CSV readers, so the package imports where pandas is absent
(configs and synthetic data need no CSV).
"""
from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Sequence, Union

import numpy as np
from numpy.typing import NDArray
from scipy.optimize import linear_sum_assignment
from scipy.special import betaln

FLOAT_TYPE = np.float32
INT_TYPE = np.int64
EPS = np.finfo(FLOAT_TYPE).eps
LOG_EPS = np.finfo(FLOAT_TYPE).min

PathLike = Union[str, Path]


class FamilyError(Exception):
    pass


# ---------------------------------------------------------------------------
# Cluster bit-string encoding (results-file format contract)
# Reference behavior: sbayes/util.py:61-81
# ---------------------------------------------------------------------------

def encode_cluster(cluster: NDArray[np.bool_]) -> str:
    """Format one cluster as a compact '0'/'1' bit-string."""
    return "".join("1" if x else "0" for x in cluster)


def decode_cluster(cluster_str: str) -> NDArray[np.bool_]:
    """Parse a bit-string back into a boolean membership array."""
    return np.fromiter(cluster_str, dtype="U1").astype(int).astype(bool)


def format_cluster_columns(clusters: NDArray[np.bool_]) -> str:
    """Tab-separate the bit-strings of all clusters in a sample."""
    return "\t".join(encode_cluster(c) for c in clusters)


def parse_cluster_columns(clusters_encoded: str) -> NDArray[np.bool_]:
    """Read tab-separated bit-strings into a (n_clusters, n_objects) array."""
    return np.array([decode_cluster(c) for c in clusters_encoded.split("\t")])


# ---------------------------------------------------------------------------
# Combinatorics (cluster-size prior; reference: sbayes/util.py:1104-1173)
# ---------------------------------------------------------------------------

def log_binom(n, k):
    """log(n choose k), vectorized over either argument."""
    return -betaln(1 + np.asarray(n) - np.asarray(k), 1 + np.asarray(k)) - np.log(np.asarray(n) + 1)


def log_multinom(n: int, ks: Sequence[int]) -> float:
    """log of the multinomial coefficient log(n choose k1,k2,...).

    The sum of the sample sizes may not exceed the population size ``n``.
    """
    ks = np.asarray(ks)
    if np.sum(ks) == 0:
        return 0.0
    ks = ks[ks > 0]

    log_i = np.log(1 + np.arange(n))
    log_i_cumsum = np.cumsum(log_i)

    m = np.sum(log_i)
    m -= np.sum(log_i_cumsum[ks - 1])
    rest = n - np.sum(ks)
    if rest > 0:
        m -= log_i_cumsum[rest - 1]
    return float(m)


def normalize(x, axis=-1):
    """Normalize so the given axis sums to 1 (float32, like the reference)."""
    x = np.asarray(x)
    assert np.all(np.sum(x, axis=axis) > 0), np.min(x)
    return (x / np.sum(x, axis=axis, keepdims=True)).astype(FLOAT_TYPE)


def heat_binary_probability(p, temperature: float):
    """p**(1/T) renormalized against (1-p)**(1/T)."""
    pow_ = 1 / temperature
    p_pow = np.asarray(p) ** pow_
    return p_pow / (p_pow + (1 - np.asarray(p)) ** pow_)


# ---------------------------------------------------------------------------
# Cluster alignment (Hungarian; reference: sbayes/util.py:1249-1255)
# ---------------------------------------------------------------------------

def get_best_permutation(
    clusters: NDArray[np.bool_],       # (n_clusters, n_objects)
    prev_cluster_sum: NDArray[np.int_],  # (n_clusters, n_objects)
) -> NDArray[np.int_]:
    """Permutation of cluster labels maximizing agreement with running sums."""
    agreement = np.matmul(prev_cluster_sum.astype(float), clusters.T.astype(float))
    return linear_sum_assignment(agreement, maximize=True)[1]


# ---------------------------------------------------------------------------
# Graph neighbourhoods (reference: sbayes/util.py:121-143)
# ---------------------------------------------------------------------------

def get_neighbours(cluster, already_in_cluster, adjacency_matrix, indirection: int = 0):
    """Neighbourhood of a cluster in the adjacency graph, excluding occupied objects."""
    reachable = adjacency_matrix.dot(cluster)
    for _ in range(indirection):
        reachable = adjacency_matrix.dot(reachable)
    return np.logical_and(reachable, ~already_in_cluster)


# ---------------------------------------------------------------------------
# CSV I/O with the reference's NA & unicode conventions
# (reference: sbayes/util.py:349-379)
# ---------------------------------------------------------------------------

def _ascii_fold(s: str) -> str:
    """Fold unicode to its closest ASCII representation (unidecode-lite)."""
    return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii")


def normalize_str(s):
    import pandas as pd

    if pd.isna(s):
        return s
    return _ascii_fold(str.strip(str(s)))


def read_data_csv(csv_path: PathLike) -> pd.DataFrame:
    """Read a data CSV treating blank-ish strings as NA; unicode-normalize."""
    import pandas as pd

    na_values = ["", " ", "\t", "  "]
    data = pd.read_csv(csv_path, na_values=na_values, keep_default_na=False, dtype=str)
    data.columns = [_ascii_fold(c) for c in data.columns]
    return data.map(normalize_str)


def read_costs_from_csv(file: PathLike, logger=None) -> pd.DataFrame:
    import pandas as pd

    data = pd.read_csv(file, dtype=str, index_col=0)
    if logger:
        logger.info(f"Geographical cost matrix read from {file}.")
    return data


def range_like(a):
    return list(range(len(a)))


# ---------------------------------------------------------------------------
# One-hot encoding of categorical data
# (reference behavior: sbayes/util.py:294-346)
# ---------------------------------------------------------------------------

def encode_states(features_raw: pd.DataFrame, feature_states: pd.DataFrame):
    """Encode raw categorical features as a one-hot boolean tensor.

    Each column of ``feature_states`` lists the legal state labels of one
    feature (shorter lists are NaN-padded); each column of ``features_raw``
    holds the observed label per object. Observations are mapped to integer
    state codes via ``pd.Categorical`` and scattered into a boolean
    (n_objects, n_features, n_states) tensor in one fancy-index write per
    feature; NA observations stay all-zero rows.

    Returns (dict with 'values' / 'states' applicable-state mask /
    'state_names', n_NA). Behavior matches reference util.py:294-346.
    """
    import pandas as pd

    n_states = feature_states.shape[0]
    n_objects = features_raw.shape[0]
    columns = list(feature_states.columns)
    if list(features_raw.columns) != columns:
        features_raw = features_raw.loc[:, columns]

    state_names = [feature_states[c].dropna().tolist() for c in columns]
    # applicable-state mask: state slot s is legal for feature f iff the
    # feature_states cell is non-NaN
    applicable_states = feature_states.notna().to_numpy().T  # (F, S)

    values = np.zeros((n_objects, len(columns), n_states), dtype=bool)
    na_number = 0
    for i_f, col in enumerate(columns):
        observed = features_raw[col]
        codes = pd.Categorical(observed, categories=state_names[i_f]).codes
        is_na = observed.isna().to_numpy()
        undefined = (codes < 0) & ~is_na
        if undefined.any():
            raise ValueError(
                f"Features of feature `{col}` contain states that are not defined "
                f"in the feature_states file: {sorted(set(observed[undefined]))}"
            )
        rows = np.flatnonzero(codes >= 0)
        values[rows, i_f, codes[rows]] = True
        na_number += int(is_na.sum())

    features = {
        "values": values,
        "states": applicable_states,
        "state_names": state_names,
    }
    return features, na_number


# ---------------------------------------------------------------------------
# Config-dict helpers (reference: sbayes/util.py:1265-1329)
# ---------------------------------------------------------------------------

def set_defaults(cfg: dict, default_cfg: dict) -> dict:
    """Recursively fill missing fields of ``cfg`` from ``default_cfg``."""
    for key in default_cfg:
        if key not in cfg:
            cfg[key] = default_cfg[key]
        elif isinstance(default_cfg[key], dict) and isinstance(cfg[key], dict):
            set_defaults(cfg[key], default_cfg[key])
    return cfg


def update_recursive(cfg: dict, new_cfg: dict) -> dict:
    """Recursively override fields of ``cfg`` with values from ``new_cfg``."""
    for key in new_cfg:
        if key in cfg and isinstance(new_cfg[key], dict) and isinstance(cfg[key], dict):
            update_recursive(cfg[key], new_cfg[key])
        else:
            cfg[key] = new_cfg[key]
    return cfg


def iter_items_recursive(cfg: dict, loc=tuple()):
    for key, value in cfg.items():
        if isinstance(value, dict):
            yield from iter_items_recursive(value, loc + (key,))
        else:
            yield key, value, loc


def decompose_config_path(config_path: PathLike) -> tuple[Path, Path]:
    """Return (base directory, absolute path) of a config file."""
    abs_config_path = Path(config_path).absolute()
    return abs_config_path.parent, abs_config_path


def fix_relative_path(path: PathLike, base_directory: PathLike) -> Path:
    """Resolve ``path`` relative to ``base_directory`` unless it is absolute."""
    path = Path(path)
    if path.is_absolute():
        return path
    return Path(base_directory) / path


def scale_counts(counts: NDArray, scale_to: float, prior_inflation: float = 1.0):
    """Scale feature-state counts so they sum to at most ``scale_to`` per feature.

    Used by the prior-count extraction tools (reference: sbayes/util.py:520-537).
    """
    counts = counts * prior_inflation
    counts_sum = np.sum(counts, axis=0)
    counts_sum = np.where(counts_sum == 0, 1.0, counts_sum)
    scale_factor = scale_to / counts_sum
    scale_factor = np.where(scale_factor < 1, scale_factor, 1)
    return counts * scale_factor


def timeit(fn):
    """Decorator printing the runtime of a function call (debug helper)."""
    import functools
    import time

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        print(f"{fn.__name__} took {time.time() - t0:.3f}s")
        return out

    return wrapped


def process_memory(pid: int | None = None, unit: str = "MB") -> int:
    """RSS memory of a process (psutil)."""
    import psutil

    mem = psutil.Process(pid).memory_info().rss
    shift = {"B": 0, "KB": 10, "MB": 20, "GB": 30, "TB": 40}[unit]
    return mem >> shift
