"""Host-side utilities: encodings, combinatorics, config-dict helpers.

Copy of ``sbayes_tpu/utils.py`` for the PyTorch port. The CSV readers use
the standard ``csv`` module and numpy in place of pandas, so data files
load where pandas is absent.
"""
from __future__ import annotations

import csv
import re
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
# (reference: sbayes/util.py:349-379). The standard ``csv`` module and numpy
# read what the JAX package reads with pandas (``read_csv(dtype=str)``).
# ---------------------------------------------------------------------------

DATA_NA_VALUES = frozenset(["", " ", "\t", "  "])
# pandas' default NA tokens (``keep_default_na=True``), for the cost matrix
DEFAULT_NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"])


class Table(dict):
    """A CSV file as ``{column name: numpy object array of str | None}``
    in the header's order; ``None`` is NA. The tools and ``Results`` hold
    typed columns in it too (``read_typed_table``, ``column``): the port's
    counterpart of the pandas data frames of the JAX package."""

    @property
    def n_rows(self) -> int:
        return len(next(iter(self.values()))) if self else 0

    def rows(self, index) -> "Table":
        """The rows ``index`` (a slice, or an index or mask array) of every column."""
        return Table((name, col[index]) for name, col in self.items())

    @classmethod
    def of(cls, columns) -> "Table":
        """A Table of numpy arrays from any mapping of column names to
        sequences (a dict, a Table, a pandas data frame)."""
        return cls((name, np.asarray(columns[name])) for name in columns)

    @classmethod
    def from_records(cls, records: list) -> "Table":
        """The columns of a list of dicts (all with the same keys), each typed
        by ``column``."""
        names = list(records[0]) if records else []
        return cls((name, column([r[name] for r in records])) for name in names)

    def to_string(self) -> str:
        """The table as fixed-width text, the column names above their
        values, each column right-aligned (the form of pandas'
        ``to_string(index=False)``)."""
        cols = [[name] + [format_cell(v, na="NaN") for v in col] for name, col in self.items()]
        widths = [max(map(len, c)) for c in cols]
        return "\n".join(" ".join(c[i].rjust(w) for c, w in zip(cols, widths))
                         for i in range(self.n_rows + 1))


def _column_names(header: list) -> list:
    """pandas' names for a header: an empty name is ``Unnamed: <i>``, a
    repeated one gets ``.1``, ``.2``, ..."""
    names: list = []
    for i, name in enumerate(header):
        name = name or f"Unnamed: {i}"
        unique, k = name, 0
        while unique in names:
            k += 1
            unique = f"{name}.{k}"
        names.append(unique)
    return names


def read_csv_table(path: PathLike, na_values=frozenset(), sep: str = ",") -> Table:
    """Every cell of a ``sep``-separated file as a string, or ``None`` where
    it is one of ``na_values``. A UTF-8 BOM is dropped, blank lines (empty
    or spaces and tabs only) are skipped, quoted fields keep their
    separators and line breaks, short rows are padded with NA; a row longer
    than the header raises."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [(i, r) for i, r in enumerate(csv.reader(f, delimiter=sep), start=1)
                if len(r) > 1 or (r and r[0].strip(" \t"))]
    if not rows:
        raise ValueError(f"No columns to parse from file {path}")
    names = _column_names(rows[0][1])
    cells = np.full((len(rows) - 1, len(names)), None, dtype=object)
    for i_row, (line, row) in enumerate(rows[1:]):
        if len(row) > len(names):
            raise ValueError(f"{path}, line {line}: {len(row)} fields, the header has "
                             f"{len(names)}")
        cells[i_row, :len(row)] = [None if v in na_values else v for v in row]
    return Table((name, cells[:, j]) for j, name in enumerate(names))


_INT_LITERAL = re.compile(r"\s*[+-]?\d+\s*")
_TRUE, _FALSE = frozenset(["True", "TRUE", "true"]), frozenset(["False", "FALSE", "false"])


def _float_or_none(v):
    if "_" in v:             # float() reads "1_0"; a CSV number has no underscore
        return None
    try:
        return float(v)
    except ValueError:
        return None


def infer_column(cells: NDArray) -> NDArray:
    """A column of strings (``None`` = NA) typed as pandas' ``read_csv``
    types it: int64 when every cell is an integer literal, bool when every
    cell is ``True`` or ``False``, float64 when every cell that is not NA is
    a number (NA as NaN), else the strings themselves (object)."""
    present = [v for v in cells if v is not None]
    if len(present) == len(cells) and present:
        if all(_INT_LITERAL.fullmatch(v) for v in present):
            ints = [int(v) for v in present]
            if all(-2 ** 63 <= i < 2 ** 63 for i in ints):
                return np.array(ints, dtype=np.int64)
        if all(v in _TRUE or v in _FALSE for v in present):
            return np.array([v in _TRUE for v in present], dtype=bool)
    floats = [_float_or_none(v) for v in present]
    if present and all(f is not None for f in floats):
        it = iter(floats)
        return np.array([np.nan if v is None else next(it) for v in cells], dtype=np.float64)
    return np.asarray(cells, dtype=object)


def read_typed_table(path: PathLike, sep: str = ",") -> Table:
    """A CSV (or with ``sep`` a TSV) file with each column typed by
    ``infer_column``, pandas' default NA tokens as NA: what the JAX package
    reads with ``pd.read_csv(path, delimiter=sep)``."""
    table = read_csv_table(path, DEFAULT_NA_VALUES, sep=sep)
    return Table((name, infer_column(col)) for name, col in table.items())


def column(values: Sequence) -> NDArray:
    """Python values typed as pandas types a column of records: int64 for
    ints, float64 for numbers (``None`` as NaN) unless all are ``None``,
    bool for bools, else object."""
    vals = list(values)
    present = [v for v in vals if v is not None]
    whole = bool(present) and len(present) == len(vals)
    if whole and all(isinstance(v, (bool, np.bool_)) for v in present):
        return np.array(vals, dtype=bool)
    if present and all(isinstance(v, (int, float, np.integer, np.floating))
                       and not isinstance(v, (bool, np.bool_)) for v in present):
        if whole and all(isinstance(v, (int, np.integer)) for v in present):
            return np.array(vals, dtype=np.int64)
        return np.array([np.nan if v is None else v for v in vals], dtype=np.float64)
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out


def format_cell(v, na: str = "") -> str:
    """A cell as pandas' ``to_csv`` writes it: NA (``None``, NaN) as ``na``,
    a float by its shortest round-trip form, anything else by ``str``."""
    if v is None:
        return na
    if isinstance(v, (float, np.floating)):
        return na if v != v else repr(float(v))
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_table(table: Table, path: PathLike, sep: str = ",", index=None,
                index_label: str = ""):
    """Write ``table`` as pandas' ``to_csv(path, sep=sep, index=False)``
    writes a data frame of its columns, or with ``index`` (one label per
    row) as ``to_csv`` with that index: a first column headed
    ``index_label``. Fields that hold the separator, a quote or a line
    break are quoted."""
    names = list(table)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(([index_label] if index is not None else []) + names)
        cols = [table[n] for n in names]
        for i in range(table.n_rows):
            row = [format_cell(c[i]) for c in cols]
            w.writerow(([format_cell(index[i])] if index is not None else []) + row)


def to_floats(cells: NDArray) -> NDArray[np.float64]:
    """Cells of a table as float64 (``float`` of each string), NA as NaN."""
    return np.where(np.equal(cells, None), np.nan, cells).astype(float)


def _ascii_fold(s: str) -> str:
    """Fold unicode to its closest ASCII representation (unidecode-lite)."""
    return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii")


def normalize_str(s):
    if s is None or s != s:      # NA: None in a Table, NaN in a pandas data frame
        return s
    return _ascii_fold(str.strip(str(s)))


def read_data_csv(csv_path: PathLike) -> Table:
    """Read a data CSV treating blank-ish strings as NA; unicode-normalize."""
    table = read_csv_table(csv_path, DATA_NA_VALUES)
    return Table((_ascii_fold(name), np.array([normalize_str(v) for v in col], dtype=object))
                 for name, col in table.items())


def read_costs_from_csv(file: PathLike, logger=None) -> tuple[NDArray, Table]:
    """The row labels (the first column) and the cost columns of a cost
    matrix CSV, in the file's order; pandas' default NA tokens are NA."""
    table = read_csv_table(file, DEFAULT_NA_VALUES)
    index = table.pop(next(iter(table)))
    if logger:
        logger.info(f"Geographical cost matrix read from {file}.")
    return index, table


def range_like(a):
    return list(range(len(a)))


# ---------------------------------------------------------------------------
# One-hot encoding of categorical data
# (reference behavior: sbayes/util.py:294-346)
# ---------------------------------------------------------------------------

def encode_states(features_raw: Table, feature_states: Table):
    """Encode raw categorical features as a one-hot boolean tensor.

    Each column of ``feature_states`` lists the legal state labels of one
    feature (shorter lists are NA-padded); each column of ``features_raw``
    holds the observed label per object. Observations are mapped to their
    index among the feature's states (NA and unknown labels to -1) and
    scattered into a boolean (n_objects, n_features, n_states) tensor in one
    fancy-index write per feature; NA observations stay all-zero rows.

    Returns (dict with 'values' / 'states' applicable-state mask /
    'state_names', n_NA). Behavior matches reference util.py:294-346.
    """
    n_states = feature_states.n_rows
    n_objects = features_raw.n_rows
    columns = list(feature_states)

    state_names = [[s for s in feature_states[c] if s is not None] for c in columns]
    # applicable-state mask: state slot s is legal for feature f iff the
    # feature_states cell is not NA
    applicable_states = np.array([[s is not None for s in feature_states[c]] for c in columns],
                                 dtype=bool).reshape(len(columns), n_states)  # (F, S)

    values = np.zeros((n_objects, len(columns), n_states), dtype=bool)
    na_number = 0
    for i_f, col in enumerate(columns):
        observed = features_raw[col]
        code_of = {s: i for i, s in enumerate(state_names[i_f])}
        if len(code_of) < len(state_names[i_f]):
            raise ValueError(f"The states of feature `{col}` in the feature_states file "
                             f"are not unique: {state_names[i_f]}")
        codes = np.fromiter((code_of.get(v, -1) for v in observed), dtype=np.int64,
                            count=n_objects)
        is_na = np.array([v is None for v in observed], dtype=bool)
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


def process_memory(pid: int | None = None, unit: str = "MB") -> int:
    """RSS memory of a process (psutil)."""
    import psutil

    mem = psutil.Process(pid).memory_info().rss
    shift = {"B": 0, "KB": 10, "MB": 20, "GB": 30, "TB": 40}[unit]
    return mem >> shift
