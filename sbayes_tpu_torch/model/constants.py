"""Static per-model constants as torch tensors on one device.

Port of ``sbayes_tpu/model/constants.py``: the same prior parsing and the
same padded confounder layout, built from ``Data`` with numpy and moved to
the requested device once. These tensors are added for the CUDA kernels
(``ops/loglh.py``, ``ops/marginal.py``):

* ``feat_idx`` (N, F) int8: the observed state of each (object, feature),
  with the sentinel ``S`` at NA cells, and ``feat_idx_t`` (F, N), the same
  feature-major (the kernels' lanes run over objects);
* ``group_idx`` (C-1, N) int32: each object's group per confounder, with
  ``-1`` for objects in no group of that confounder;
* ``conc_table`` (R, F, S + 1): what the collapsed likelihood needs of the
  model alone, in one table (``concentration_table``).

Two rules of the JAX package pick the layout at scale, each a function with
the JAX thresholds as defaults and an explicit argument of
``build_model_constants`` (tests set it): ``source_packed``, the chain
state's source as the packed int8 (N, F) index (``auto_source_packed``), and
``feature_chunk``, the width of the feature tiles over which the full-width
(B, N, F, ...) computations run (``auto_feature_chunk``). The TPU's
pre-tiled feature layouts and its bf16 one-hot features are not ported: on
the GPU both kernels read the state index directly, and the features stay
f32. A third rule has no JAX counterpart, where XLA fuses the reduction:
``auto_cost_row_tile``, the rows of the cost matrix per tile of the geo
prior's masked reductions, from the number of clusters and N.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from numpy.typing import NDArray

from sbayes_tpu_torch.config import yaml_reader
from sbayes_tpu_torch.config.schema import (
    ConfoundingEffectPriorConfig,
    DirichletPriorConfig,
    GeoPriorConfig,
    ModelConfig,
)
from sbayes_tpu_torch.data.loader import Data
from sbayes_tpu_torch.model.shapes import ModelShapes
from sbayes_tpu_torch.utils import FLOAT_TYPE

PriorTypes = DirichletPriorConfig.Types


def resolve_device(device) -> torch.device:
    """The torch device for an entry point. A CUDA device without a card
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "A CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU."
        )
    return dev


def _symmetric_concentration(applicable: NDArray, c: float) -> NDArray:
    """(F, S) array with value c on applicable states, 0 elsewhere."""
    return np.where(applicable, c, 0.0).astype(FLOAT_TYPE)


def _oneovern_concentration(applicable: NDArray) -> NDArray:
    n_states_f = applicable.sum(-1, keepdims=True)
    return np.where(applicable, 1.0 / n_states_f, 0.0).astype(FLOAT_TYPE)


def _load_concentration_dict(path: Path) -> dict:
    if Path(path).suffix.lower() in (".yaml", ".yml"):
        return yaml_reader.load(path)
    with open(path, "r") as f:
        return json.load(f)


def _concentration_from_dict(concentration_dict: dict, feature_names, state_names,
                             applicable: NDArray, initial_counts: float = 1.0) -> NDArray:
    """Parse {feature: {state: count}} into a padded (F, S) array, adding
    ``initial_counts`` to every given count."""
    n_features, n_states = applicable.shape
    conc = np.zeros((n_features, n_states), dtype=FLOAT_TYPE)
    for i_f, f in enumerate(feature_names):
        for i_s, s in enumerate(state_names[i_f]):
            conc[i_f, i_s] = initial_counts + concentration_dict[f][s]
    return conc


def parse_dirichlet_concentration(cfg: DirichletPriorConfig, feature_names, state_names,
                                  applicable: NDArray, initial_counts: float = 1.0) -> NDArray:
    """Concentration array (F, S) for one Dirichlet prior config section."""
    t = cfg.type
    if t is PriorTypes.UNIFORM:
        return _symmetric_concentration(applicable, 1.0)
    if t is PriorTypes.JEFFREYS:
        return _symmetric_concentration(applicable, 0.5)
    if t is PriorTypes.BBS:
        return _oneovern_concentration(applicable)
    if t is PriorTypes.SYMMETRIC_DIRICHLET:
        return _symmetric_concentration(applicable, cfg.prior_concentration)
    if t is PriorTypes.DIRICHLET:
        d = _load_concentration_dict(cfg.file) if cfg.file is not None else cfg.parameters
        return _concentration_from_dict(d, feature_names, state_names, applicable, initial_counts)
    raise ValueError(f"Unsupported Dirichlet prior type {t}")


def concentration_table(conc_cluster: NDArray, conc_conf: NDArray) -> NDArray:
    """The model-only inputs of the collapsed likelihood in one (R, F, S + 1)
    table: row 0 is the cluster prior (shared by all clusters), then the
    (C-1) * Gmax confounder-group rows, R = 1 + (C-1) * Gmax. Entries
    [..., :S] are the concentrations ``a`` (0 = the state is excluded),
    entry [..., S] is ``sum_s a``, summed in float64 and rounded once."""
    F, S = conc_cluster.shape
    a = np.concatenate([conc_cluster[None], conc_conf.reshape(-1, F, S)]).astype(FLOAT_TYPE)
    sum_a = a.sum(-1, dtype=np.float64, keepdims=True)
    return np.concatenate([a, sum_a], axis=-1).astype(FLOAT_TYPE)


@dataclass(frozen=True)
class GeoPriorConstants:
    prior_type: str                 # uniform | cost_based | simulated
    aggregation: str                # mean | sum | max
    probability_function: str       # exponential | sigmoid
    skeleton: str                   # mst | delaunay | diameter | complete_graph
    scale: Optional[float]
    inflection_point: Optional[float]
    mean_edge_length: float = 1.0   # simulated type: mean edge of the MST of all objects


@dataclass(frozen=True)
class ModelConstants:
    """All static inputs of the posterior, the operators and the kernels."""

    shapes: ModelShapes
    device: torch.device

    features: Any                   # f32 (N, F, S) one-hot observations
    na: Any                         # bool (N, F)
    applicable: Any                 # bool (F, S)
    n_states_per_feature: Any       # f32 (F,)
    feat_idx: Any                   # int8 (N, F), S = NA
    feat_idx_t: Any                 # int8 (F, N), the same feature-major

    conf_names: tuple
    group_names: dict
    groups: Any                     # f32 (C-1, Gmax, N) one-hot group rows
    group_valid: Any                # bool (C-1, Gmax)
    n_groups: Any                   # numpy int (C-1,)
    hc_conf: Any                    # bool (N, C-1)
    group_idx: Any                  # int32 (C-1, N), -1 = in no group

    conc_cluster: Any               # f32 (F, S)
    unif_conc: Any                  # f32 (F, S)
    conc_conf: Any                  # f32 (C-1, Gmax, F, S)
    conc_weights: Any               # f32 (F, C)
    weights_prior_uniform: bool
    conc_table: Any                 # f32 (R, F, S + 1): a, then sum_s a; R = 1 + (C-1) Gmax

    geo: GeoPriorConstants
    cost_matrix: Any                # f32 (N, N) geo costs ((1, 1) zeros: uniform geo, N > 2000)
    adjacency: Any                  # bool (N, N)
    locations: Any                  # f32 (N, 2)

    size_prior_type: str
    min_size: int
    max_size: int

    static_pat: Any                 # int64 (N,) static availability pattern id
    pat_bits: Any                   # f32 (P, C) availability bits per pattern

    source_packed: bool = False     # chain states hold the int8 (B, N, F) source
    feature_chunk: Optional[int] = None  # feature-tile width, None = no tiling

    @property
    def K(self):
        return self.shapes.n_clusters

    @property
    def N(self):
        return self.shapes.n_sites

    @property
    def F(self):
        return self.shapes.n_features

    @property
    def S(self):
        return self.shapes.n_states

    @property
    def C(self):
        return self.shapes.n_components

    @property
    def Gmax(self):
        return int(self.groups.shape[1])

    def to(self, device) -> "ModelConstants":
        """These constants with every tensor field on ``device`` and
        ``device`` set to it (a shard of a split chain batch samples on its
        own device; ``parallel/mesh.py::replicate``)."""
        device = torch.device(device)
        moved = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, device=device, **moved)


def auto_source_packed(n_objects: int, n_features: int, n_components: int,
                       byte_threshold: int = 16 * 1024 * 1024) -> bool:
    """Whether chain states store the packed int8 (N, F) source: only at
    scale, where one chain's bool (N, F, C) source passes ``byte_threshold``
    bytes, and while the sentinel C fits int8 (the JAX package's rule)."""
    return n_components < 127 and n_objects * n_features * n_components > byte_threshold


def auto_feature_chunk(n_objects: int, n_features: int, cell_threshold: int = 4_000_000,
                       target: int = 512) -> Optional[int]:
    """Feature-tile width for large models, once N * F passes
    ``cell_threshold`` (None: no tiling, and for small models): the divisor
    of F closest to ``target`` where it lies within a factor of two of it
    (the JAX package's rule, the same tiles), else ``target`` with a shorter
    last tile. The JAX package keeps the divisor wherever it lies: at F =
    3,183 = 3 x 1,061 that is 1,061 tiles of 3 features, where this rule
    gives 6 of 512 and one of 111."""
    if n_objects * n_features <= cell_threshold:
        return None
    divisors = [d for d in range(1, n_features + 1) if n_features % d == 0]
    best = min(divisors, key=lambda d: abs(d - target))
    if not target // 2 <= best <= 2 * target:
        best = target
    return best if best < n_features else None


def auto_cost_row_tile(n_masks: int, n_objects: int, budget: int = 1 << 26) -> int:
    """Rows of the (N, N) cost matrix per tile of a masked reduction over
    ``n_masks`` clusters (the geo prior's cheapest edge from each object to
    a cluster, the complete graph's longest edge): the (n_masks, rows, N)
    f32 temporary stays within ``budget`` elements (256 MB), so 16 chains
    at 10,000 objects take tiles of 419 rows where one (16, N, N) temporary
    would be 6.4 GB. All N rows in one tile while they fit. A min or a max
    over tiles is exact: the tile changes no bit of the result."""
    return max(1, min(n_objects, budget // max(1, n_masks * n_objects)))


def build_model_constants(data: Data, config: ModelConfig, n_clusters: Optional[int] = None,
                          device="cuda", source_packed: Optional[bool] = None,
                          feature_chunk: Optional[int] = None) -> ModelConstants:
    """Assemble ModelConstants from loaded data and a model config.
    ``source_packed`` / ``feature_chunk`` override ``auto_source_packed`` /
    ``auto_feature_chunk`` (None: the rule; a ``feature_chunk`` of 0, or of
    F or more, turns tiling off)."""
    device = resolve_device(device)
    features = data.features
    confounders = data.confounders
    K = n_clusters if n_clusters is not None else config.clusters
    if not isinstance(K, int):
        raise ValueError("build_model_constants needs a single integer cluster count")

    N, F, S = features.values.shape
    if S >= 127:
        raise ValueError(f"{S} states do not fit the int8 feature index")
    conf_names = tuple(confounders.keys())
    n_conf = len(conf_names)

    shapes = ModelShapes(
        n_clusters=K, n_sites=N, n_features=F, n_states=S,
        states_per_feature=features.states, n_confounders=n_conf,
        n_groups={name: conf.n_groups for name, conf in confounders.items()},
    )

    applicable = features.states.astype(bool)
    unif_conc = _symmetric_concentration(applicable, 1.0)
    feature_names = list(features.names)
    state_names = features.state_names

    ce_cfg = config.prior.cluster_effect
    if ce_cfg.type is PriorTypes.DIRICHLET:
        raise ValueError("Prior type `dirichlet` is not supported for the cluster effect.")
    conc_cluster = parse_dirichlet_concentration(ce_cfg, feature_names, state_names, applicable)

    Gmax = max(max((conf.n_groups for conf in confounders.values()), default=1), 1)
    groups = np.zeros((n_conf, Gmax, N), dtype=FLOAT_TYPE)
    group_valid = np.zeros((n_conf, Gmax), dtype=bool)
    conc_conf = np.tile(unif_conc[None, None], (max(n_conf, 1), Gmax, 1, 1)).astype(FLOAT_TYPE)
    n_groups_arr = np.zeros(n_conf, dtype=np.int32)
    group_names: dict = {}
    for i_c, conf_name in enumerate(conf_names):
        conf = confounders[conf_name]
        prior_cfg_by_group = config.prior.confounding_effects[conf_name]
        default_cfg = prior_cfg_by_group.get("<DEFAULT>", None)
        group_names[conf_name] = list(conf.group_names)
        n_groups_arr[i_c] = conf.n_groups
        for i_g, g_name in enumerate(conf.group_names):
            groups[i_c, i_g] = conf.group_assignment[i_g].astype(FLOAT_TYPE)
            group_valid[i_c, i_g] = True
            cfg_g = prior_cfg_by_group.get(g_name, default_cfg)
            if cfg_g is None:
                cfg_g = ConfoundingEffectPriorConfig.from_dict({"type": "uniform"})
            conc_conf[i_c, i_g] = parse_dirichlet_concentration(
                cfg_g, feature_names, state_names, applicable)

    hc_conf = groups.sum(axis=1).T > 0                     # (N, C-1)
    group_idx = np.where(hc_conf.T, groups.argmax(axis=1), -1).astype(np.int32)

    # Availability patterns: distinct rows of hc_conf, doubled by the
    # dynamic any-cluster bit (see ModelConstants.static_pat / pat_bits).
    static_rows, static_pat = np.unique(hc_conf, axis=0, return_inverse=True)
    static_pat = static_pat.reshape(-1)
    n_static = static_rows.shape[0]
    pat_bits = np.concatenate([
        np.concatenate([np.zeros((n_static, 1)), static_rows], axis=1),
        np.concatenate([np.ones((n_static, 1)), static_rows], axis=1),
    ]).astype(FLOAT_TYPE)

    C = n_conf + 1
    w_cfg = config.prior.weights
    if w_cfg.type is PriorTypes.UNIFORM:
        conc_weights, weights_prior_uniform = np.full((F, C), 1.0, FLOAT_TYPE), True
    elif w_cfg.type is PriorTypes.JEFFREYS:
        conc_weights, weights_prior_uniform = np.full((F, C), 0.5, FLOAT_TYPE), False
    elif w_cfg.type is PriorTypes.BBS:
        conc_weights, weights_prior_uniform = np.full((F, C), 1.0 / C, FLOAT_TYPE), False
    elif w_cfg.type is PriorTypes.SYMMETRIC_DIRICHLET:
        conc_weights = np.full((F, C), w_cfg.prior_concentration, FLOAT_TYPE)
        weights_prior_uniform = False
    else:
        raise ValueError(f"Unsupported weights prior type {w_cfg.type}")

    geo_cfg = config.prior.geo
    if geo_cfg.type is GeoPriorConfig.Types.UNIFORM and N > 2000:
        # Only the cost-based and simulated geo priors read the cost matrix:
        # under the uniform one a large model keeps no (N, N) tensor on the device.
        cost_matrix = np.zeros((1, 1), dtype=FLOAT_TYPE)
    else:
        cost_matrix = np.asarray(data.geo_cost_matrix, dtype=FLOAT_TYPE)
    mean_edge_length = 1.0
    if geo_cfg.type is GeoPriorConfig.Types.SIMULATED:
        from scipy.sparse.csgraph import minimum_spanning_tree

        mst = minimum_spanning_tree(np.asarray(data.network.dist_mat, dtype=float))
        edges = mst.tocsr()[mst.nonzero()]
        mean_edge_length = float(np.mean(edges)) if edges.size else 1.0
    geo = GeoPriorConstants(
        prior_type=geo_cfg.type.value, aggregation=geo_cfg.aggregation.value,
        probability_function=geo_cfg.probability_function.value,
        skeleton=geo_cfg.skeleton.value, scale=geo_cfg.rate,
        inflection_point=geo_cfg.inflection_point, mean_edge_length=mean_edge_length,
    )

    adjacency = np.asarray(data.network.adj_mat.todense()).astype(bool)
    np.fill_diagonal(adjacency, False)

    values = features.values
    feat_idx = np.where(values.any(-1), values.argmax(-1), S).astype(np.int8)

    sp_cfg = config.prior.objects_per_cluster
    if source_packed is None:
        source_packed = auto_source_packed(N, F, C)
    if source_packed and C >= 127:
        raise ValueError(f"{C} components do not fit the packed int8 source")
    if feature_chunk is None:
        feature_chunk = auto_feature_chunk(N, F)
    elif not 0 < feature_chunk < F:
        feature_chunk = None

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return ModelConstants(
        shapes=shapes,
        device=device,
        features=t(values, torch.float32),
        na=t(features.na_values.astype(bool), torch.bool),
        applicable=t(applicable, torch.bool),
        n_states_per_feature=t(applicable.sum(-1), torch.float32),
        feat_idx=t(feat_idx, torch.int8),
        feat_idx_t=t(np.ascontiguousarray(feat_idx.T), torch.int8),
        conf_names=conf_names,
        group_names=group_names,
        groups=t(groups, torch.float32),
        group_valid=t(group_valid, torch.bool),
        n_groups=n_groups_arr,
        hc_conf=t(hc_conf, torch.bool),
        group_idx=t(group_idx, torch.int32),
        conc_cluster=t(conc_cluster, torch.float32),
        unif_conc=t(unif_conc, torch.float32),
        conc_conf=t(conc_conf, torch.float32),
        conc_weights=t(conc_weights, torch.float32),
        weights_prior_uniform=weights_prior_uniform,
        conc_table=t(concentration_table(conc_cluster, conc_conf[:n_conf]), torch.float32),
        geo=geo,
        cost_matrix=t(cost_matrix, torch.float32),
        adjacency=t(adjacency, torch.bool),
        locations=t(np.asarray(data.objects.locations), torch.float32),
        size_prior_type=sp_cfg.type.value,
        min_size=int(sp_cfg.min),
        max_size=int(min(sp_cfg.max, N)),
        static_pat=t(static_pat, torch.int64),
        pat_bits=t(pat_bits, torch.float32),
        source_packed=bool(source_packed),
        feature_chunk=feature_chunk,
    )
