"""Synthetic in-memory datasets + configs for benchmarks and harness entry.

Copy of ``sbayes_tpu/testing.py`` for the PyTorch port. Generates data in
the generative model's own terms (mixture of cluster and confounder
effects) without touching the filesystem; the config's results path lies
under the temporary directory.
"""
from __future__ import annotations

import os
import tempfile
from collections import OrderedDict

import numpy as np

from sbayes_tpu_torch.config.schema import SBayesConfig
from sbayes_tpu_torch.data.loader import Confounder, Data, Features, Objects


def synthetic_data(
    n_objects: int = 100,
    n_features: int = 36,
    n_states: int = 6,
    n_families: int = 6,
    seed: int = 0,
) -> Data:
    """A synthetic dataset shaped like the south_america case study."""
    rng = np.random.default_rng(seed)

    locations = rng.uniform(-75, -35, size=(n_objects, 2))
    ids = [f"o{i}" for i in range(n_objects)]
    objects = Objects(id=ids, locations=locations, names=list(ids))

    # applicable states: between 2 and n_states per feature
    n_states_f = rng.integers(2, n_states + 1, size=n_features)
    applicable = np.zeros((n_features, n_states), dtype=bool)
    for f in range(n_features):
        applicable[f, : n_states_f[f]] = True

    # draw features from random per-family categorical distributions
    family_of = rng.integers(0, n_families, size=n_objects)
    probs = rng.dirichlet(np.ones(n_states), size=(n_families, n_features))
    probs = np.where(applicable[None], probs, 0.0)
    probs /= probs.sum(-1, keepdims=True)

    values = np.zeros((n_objects, n_features, n_states), dtype=bool)
    for o in range(n_objects):
        for f in range(n_features):
            s = rng.choice(n_states, p=probs[family_of[o], f])
            values[o, f, s] = True
    # sprinkle some NA
    na_mask = rng.random((n_objects, n_features)) < 0.02
    values[na_mask] = False

    state_names = [[f"s{j}" for j in range(n_states_f[f])] for f in range(n_features)]
    features = Features(
        values=values,
        names=np.asarray([f"f{j}" for j in range(n_features)]),
        states=applicable,
        state_names=state_names,
        na_number=int(na_mask.sum()),
    )

    fam_names = [f"fam{i}" for i in range(n_families)]
    fam_assign = np.zeros((n_families, n_objects), dtype=bool)
    for i in range(n_families):
        fam_assign[i, family_of == i] = True
    confounders = OrderedDict(
        universal=Confounder("universal", np.ones((1, n_objects), bool), ["<ALL>"]),
        family=Confounder("family", fam_assign, fam_names),
    )

    return Data(objects=objects, features=features, confounders=confounders,
                projection="epsg:4326", geo_costs="from_data")


def synthetic_config(
    n_clusters: int = 3,
    steps: int = 100_000,
    samples: int = 100,
    geo_prior: str = "uniform",
    rate: float = 1e6,
) -> SBayesConfig:
    """A config dict matching the synthetic data (no files involved)."""
    geo = {"type": geo_prior}
    if geo_prior == "cost_based":
        geo.update({"rate": rate, "aggregation": "mean"})
    cfg = {
        "data": {"features": __file__, "feature_states": __file__},  # placeholders, not read
        "model": {
            "clusters": n_clusters,
            "confounders": ["universal", "family"],
            "prior": {
                "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 50},
                "geo": geo,
                "weights": {"type": "uniform"},
                "cluster_effect": {"type": "uniform"},
                "confounding_effects": {
                    "universal": {"<ALL>": {"type": "uniform"}},
                    "family": {"<DEFAULT>": {"type": "uniform"}},
                },
            },
        },
        "mcmc": {
            "steps": steps,
            "samples": samples,
            "initialization": {"attempts": 2, "em_steps": 20, "objects_per_cluster": 10},
            "warmup": {"warmup_steps": 100, "warmup_chains": 2},
        },
        "results": {"path": os.path.join(tempfile.gettempdir(), "sbayes_tpu_torch_results"),
                    "log_file": False},
    }
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return SBayesConfig.from_dict(cfg)
