"""Results reader: parse clusters bit-strings + stats TSV back to arrays.

Copy of ``sbayes_tpu/results/results.py`` for the PyTorch port (resume reads
the last logged sample with it). Behavioral counterpart of the reference's
``Results`` (sbayes/results.py): same column-name conventions
(``w_areal_<f>``, ``areal_a<i>_<f>_<s>``, ``<conf>_<grp>_<f>_<s>``,
``size_a<i>``), burn-in dropping, and bit-string cluster decoding. The
stats file is read without pandas (absent on the card's machine): the
parameters are a ``utils.Table`` of numpy columns, typed as pandas'
``read_csv`` types them (``utils.read_typed_table``); a pandas data frame
or a dict of columns passed in is turned into one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from numpy.typing import NDArray

from sbayes_tpu_torch.utils import PathLike, Table, parse_cluster_columns, read_typed_table


class Results:
    def __init__(self, clusters: NDArray, parameters, burn_in: float = 0.1):
        clusters, parameters = self.drop_burnin(clusters, Table.of(parameters), burn_in)
        self.clusters = clusters
        self.parameters = parameters

        self.groups_by_confounders = self.get_groups_by_confounder(list(parameters))
        self.cluster_names = self.get_cluster_names(list(parameters))
        self.feature_names = extract_feature_names(parameters)
        self.feature_states = [
            extract_state_names(parameters, prefix=f"areal_{self.cluster_names[0]}_{f}_")
            for f in self.feature_names
        ] if self.cluster_names else []

        self.sample_id = self.parameters["Sample"].astype(int)
        self.weights = self.parse_weights(self.parameters)
        self.areal_effect = self.parse_areal_effect(self.parameters)
        self.confounding_effects = self.parse_confounding_effects(self.parameters)

        self.posterior = self.parameters["posterior"].astype(float)
        self.likelihood = self.parameters["likelihood"].astype(float)
        self.prior = self.parameters["prior"].astype(float)

        self.posterior_single_clusters = self.read_dictionary(self.parameters, "post_")
        self.likelihood_single_clusters = self.read_dictionary(self.parameters, "lh_")
        self.prior_single_clusters = self.read_dictionary(self.parameters, "prior_")

    # ------------------------ properties ------------------------

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    @property
    def n_clusters(self) -> int:
        return self.clusters.shape[0]

    @property
    def n_samples(self) -> int:
        return self.clusters.shape[1]

    @property
    def n_objects(self) -> int:
        return self.clusters.shape[2]

    @property
    def confounders(self) -> List[str]:
        return list(self.groups_by_confounders.keys())

    @property
    def n_confounders(self) -> int:
        return len(self.groups_by_confounders)

    # ------------------------ construction ------------------------

    @classmethod
    def from_csv_files(cls, clusters_path: PathLike, parameters_path: PathLike,
                       burn_in: float = 0.1) -> "Results":
        return cls(cls.read_clusters(clusters_path), cls.read_stats(parameters_path), burn_in=burn_in)

    @staticmethod
    def drop_burnin(clusters, parameters, burn_in):
        n_total = clusters.shape[1]
        burn_in_index = int(burn_in * n_total)
        return clusters[:, burn_in_index:, :], parameters.rows(slice(burn_in_index, None))

    @staticmethod
    def read_clusters_from_str(clusters_samples: str) -> NDArray:
        """(n_clusters, n_samples, n_objects) boolean array from bit-string rows."""
        rows = [r for r in clusters_samples.split("\n") if r]
        per_sample = [parse_cluster_columns(r) for r in rows]  # each (n_clusters, n_objects)
        return np.stack(per_sample, axis=1).astype(bool) if per_sample else np.zeros((0, 0, 0), bool)

    @staticmethod
    def read_clusters(txt_path: PathLike) -> NDArray:
        with open(txt_path, "r") as f:
            return Results.read_clusters_from_str(f.read())

    @staticmethod
    def read_stats(txt_path: PathLike) -> Table:
        return read_typed_table(txt_path, sep="\t")

    @staticmethod
    def read_dictionary(table: Table, search_key: str) -> Dict[str, NDArray]:
        return {col: table[col].astype(float) for col in table if col.startswith(search_key)}

    # ------------------------ parsing ------------------------

    def parse_weights(self, parameters: Table) -> Dict[str, NDArray]:
        components = ["areal"] + list(self.groups_by_confounders.keys())
        return {
            f: np.column_stack(
                [parameters[f"w_{c}_{f}"].astype(float) for c in components]
            )
            for f in self.feature_names
        }

    def parse_probs(self, parameters: Table, prefix: str) -> Dict[str, NDArray]:
        return {
            f: np.column_stack(
                [parameters[f"{prefix}_{f}_{s}"] for s in self.feature_states[i_f]]
            )
            for i_f, f in enumerate(self.feature_names)
        }

    def parse_areal_effect(self, parameters: Table) -> Dict[str, dict]:
        return {
            cluster: self.parse_probs(parameters, f"areal_{cluster}")
            for cluster in self.cluster_names
        }

    def parse_confounding_effects(self, parameters: Table) -> Dict[str, dict]:
        return {
            conf: {g: self.parse_probs(parameters, f"{conf}_{g}") for g in groups}
            for conf, groups in self.groups_by_confounders.items()
        }

    def get_states_for_feature_name(self, f: str) -> List[str]:
        return self.feature_states[self.feature_names.index(f)]

    # ------------------------ column-name introspection ------------------------

    @staticmethod
    def get_groups_by_confounder(column_names: Sequence[str]) -> Dict[str, List[str]]:
        groups_by_confounder: Dict[str, List[str]] = {}
        for key in column_names:
            if not key.startswith("w_"):
                continue
            _, conf, _ = key.split("_", maxsplit=2)
            if conf != "areal" and conf not in groups_by_confounder:
                groups_by_confounder[conf] = []
        for conf in groups_by_confounder:
            for key in column_names:
                if not key.startswith(f"{conf}_"):
                    continue
                _, group, _ = key.split("_", maxsplit=2)
                if group not in groups_by_confounder[conf]:
                    groups_by_confounder[conf].append(group)
        return groups_by_confounder

    @staticmethod
    def get_cluster_names(column_names: Sequence[str]) -> List[str]:
        names: List[str] = []
        for key in column_names:
            if key.startswith("areal_"):
                _, area, _ = key.split("_", maxsplit=2)
                if area not in names:
                    names.append(area)
        return names


def extract_feature_names(parameters: Table) -> List[str]:
    prefix = "w_areal_"
    return [c[len(prefix):] for c in parameters if c.startswith(prefix)]


def extract_state_names(parameters: Table, prefix: str) -> List[str]:
    return [c[len(prefix):] for c in parameters if c.startswith(prefix)]
