"""Data loading: CSV -> one-hot feature tensor, confounder groups, network.

Behavioral counterpart of the reference's ``sbayes/load_data.py``:
``Objects`` (id/name/x/y), ``Features`` (one-hot bool tensor + applicable
state mask + NA mask), ``Confounder`` (group-assignment bool matrices; a
missing column yields a single ``<ALL>`` group) and the ``Data`` facade
wiring in the geo network and cost matrix.

Copy of ``sbayes_tpu/data/loader.py`` for the PyTorch port; pandas is
imported only where a CSV is parsed.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from logging import Logger
from typing import Optional

import numpy as np
from numpy.typing import NDArray

from sbayes_tpu_torch.data.geo import ComputeNetwork, read_geo_cost_matrix
from sbayes_tpu_torch.utils import PathLike, encode_states, read_data_csv


@dataclass
class Objects:
    """A set of objects (languages, people, ...): IDs, names, locations."""

    id: list
    locations: NDArray[np.float64]  # (n_objects, 2)
    names: list
    indices: NDArray[np.int64] = field(init=False)

    def __post_init__(self):
        self.indices = np.arange(self.n_objects)

    def __getitem__(self, key):
        return getattr(self, key)

    @property
    def n_objects(self) -> int:
        return len(self.id)

    def __len__(self):
        return len(self.id)

    @classmethod
    def from_dataframe(cls, data: pd.DataFrame) -> "Objects":
        try:
            x = data["x"].astype(float)
            y = data["y"].astype(float)
            id_ext = data["id"].tolist()
        except KeyError:
            raise KeyError("The csv must contain columns `x`, `y` and `id`")
        locations = np.column_stack([x.to_numpy(), y.to_numpy()])
        return cls(locations=locations, id=id_ext, names=list(data.get("name", id_ext)))


@dataclass
class Features:
    """One-hot encoded feature observations."""

    values: NDArray[np.bool_]          # (n_objects, n_features, n_states)
    names: NDArray                     # (n_features,)
    states: NDArray[np.bool_]          # (n_features, n_states) applicable-state mask
    state_names: list                  # per feature: list of state names
    na_number: int

    feature_and_state_names: OrderedDict = field(init=False)
    na_values: NDArray[np.bool_] = field(init=False)  # (n_objects, n_features)

    def __post_init__(self):
        self.feature_and_state_names = OrderedDict(zip(self.names, self.state_names))
        self.na_values = np.sum(self.values, axis=-1) == 0

    def __getitem__(self, key):
        return getattr(self, key)

    @property
    def n_objects(self) -> int:
        return self.values.shape[0]

    @property
    def n_features(self) -> int:
        return self.values.shape[1]

    @property
    def n_states(self) -> int:
        return self.values.shape[2]

    @property
    def n_states_per_feature(self) -> list:
        return [int(sum(applicable)) for applicable in self.states]

    @classmethod
    def from_dataframes(cls, data: pd.DataFrame, feature_states: pd.DataFrame) -> "Features":
        feature_data = data.loc[:, feature_states.columns]
        features_dict, na_number = encode_states(feature_data, feature_states)
        features_dict["names"] = feature_states.columns.to_numpy()
        return cls(**features_dict, na_number=na_number)


@dataclass
class Confounder:
    """Partition of objects into groups of one confounder."""

    name: str
    group_assignment: NDArray[np.bool_]  # (n_groups, n_objects)
    group_names: list
    has_universal_prior: bool = False

    @property
    def n_groups(self) -> int:
        return len(self.group_names)

    @property
    def in_any_group(self) -> NDArray[np.bool_]:
        """(n_objects,) mask of objects assigned to some group (objects with
        a missing confounder label belong to none)."""
        return self.group_assignment.any(axis=0)

    @classmethod
    def from_dataframe(cls, data: pd.DataFrame, confounder_name: str) -> "Confounder":
        """Build the group partition from the confounder's CSV column.

        Behavioral contract (reference load_data.py:139-184): group names are
        the sorted distinct non-NA labels; a missing column means a single
        ``<ALL>`` group over every object. Implemented as one factorize +
        scatter instead of a per-group equality scan.
        """
        if confounder_name not in data:
            return cls(
                name=confounder_name,
                group_assignment=np.ones((1, len(data)), dtype=bool),
                group_names=["<ALL>"],
            )
        import pandas as pd

        codes, labels = pd.factorize(data[confounder_name], sort=True)  # NaN -> -1
        assignment = np.zeros((len(labels), len(data)), dtype=bool)
        labeled = codes >= 0
        assignment[codes[labeled], np.flatnonzero(labeled)] = True
        return cls(name=confounder_name, group_assignment=assignment,
                   group_names=list(labels))


class Data:
    """Facade wiring objects, features, confounders, network and cost matrix."""

    def __init__(
        self,
        objects: Objects,
        features: Features,
        confounders: OrderedDict,
        projection: Optional[str] = "epsg:4326",
        geo_costs: PathLike | str = "from_data",
        logger: Logger = None,
    ):
        self.objects = objects
        self.features = features
        self.confounders = confounders
        self.logger = logger

        self.crs = projection
        self.network = ComputeNetwork(self.objects, crs=projection)

        self._geo_costs = geo_costs
        self._geo_cost_matrix = None

    @property
    def geo_cost_matrix(self):
        """Lazy: the O(N²) matrix is only materialized when a config
        actually consumes it (non-uniform geo priors)."""
        if self._geo_cost_matrix is None:
            if self._geo_costs == "from_data":
                self._geo_cost_matrix = self.network.dist_mat
            else:
                self._geo_cost_matrix = read_geo_cost_matrix(
                    object_names=self.objects.id, file=self._geo_costs,
                    logger=self.logger,
                )
        return self._geo_cost_matrix

    @classmethod
    def from_config(cls, config, logger=None) -> "Data":
        if logger:
            cls.log_loading(logger)
        objects, features, confounders = read_features_from_csv(
            data_path=config.data.features,
            feature_states_path=config.data.feature_states,
            confounder_names=config.model.confounders,
            logger=logger,
        )
        return cls(
            objects=objects,
            features=features,
            confounders=confounders,
            projection=config.data.projection,
            geo_costs=config.model.prior.geo.costs,
            logger=logger,
        )

    @classmethod
    def from_experiment(cls, experiment) -> "Data":
        return cls.from_config(experiment.config, logger=experiment.logger)

    @staticmethod
    def log_loading(logger):
        logger.info("\n")
        logger.info("DATA IMPORT")
        logger.info("##########################################")


def read_features_from_csv(
    data_path: PathLike,
    feature_states_path: PathLike,
    confounder_names: list,
    logger: Optional[Logger] = None,
):
    """Import objects, features and confounders from CSV files."""
    data = read_data_csv(data_path)
    feature_states = read_data_csv(feature_states_path)

    features = Features.from_dataframes(data, feature_states)
    objects = Objects.from_dataframe(data)
    confounders = OrderedDict()
    for c in confounder_names:
        confounders[c] = Confounder.from_dataframe(data=data, confounder_name=c)

    if logger:
        logger.info(
            f"{features.n_objects} objects with {features.n_features} features read from {data_path}."
        )
        logger.info(f"{features.na_number} NA value(s) found.")
        logger.info(f"The maximum number of states in a single feature was {feature_states.shape[0]}.")

    return objects, features, confounders
