"""Data of the benchmark's configurations, drawn from a seed (numpy only).

Frozen copies of the port's generators: ``small`` is
``sbayes_tpu_torch/testing.py: synthetic_data`` (a per-observation loop,
the south_america shape) and ``large`` is ``sbayes_tpu_torch/
testing_scale.py: synthetic_data_large`` (vectorised, the 10k x 5k
scale). Both return the same arrays as the originals from the same
arguments, as plain arrays: ``values`` (N, F, S) bool one-hot
observations (all False at NA), ``applicable`` (F, S) bool, ``families``
(n_families, N) bool, ``locations`` (N, 2) (longitude, latitude in
degrees, or planar) and ``geodesic`` (whether distances are geodesic).
"""
from __future__ import annotations

import numpy as np


def small(n_objects: int, n_features: int, n_states: int, n_families: int,
          seed: int) -> dict:
    rng = np.random.default_rng(seed)
    locations = rng.uniform(-75, -35, size=(n_objects, 2))
    n_states_f = rng.integers(2, n_states + 1, size=n_features)
    applicable = np.zeros((n_features, n_states), dtype=bool)
    for f in range(n_features):
        applicable[f, : n_states_f[f]] = True
    family_of = rng.integers(0, n_families, size=n_objects)
    probs = rng.dirichlet(np.ones(n_states), size=(n_families, n_features))
    probs = np.where(applicable[None], probs, 0.0)
    probs /= probs.sum(-1, keepdims=True)
    values = np.zeros((n_objects, n_features, n_states), dtype=bool)
    for o in range(n_objects):
        for f in range(n_features):
            s = rng.choice(n_states, p=probs[family_of[o], f])
            values[o, f, s] = True
    na_mask = rng.random((n_objects, n_features)) < 0.02
    values[na_mask] = False
    families = family_of[None, :] == np.arange(n_families)[:, None]
    return {"values": values, "applicable": applicable, "families": families,
            "locations": locations, "geodesic": True}


def large(n_objects: int, n_features: int, n_states: int, n_families: int, seed: int,
          na_fraction: float = 0.01) -> dict:
    rng = np.random.default_rng(seed)
    locations = rng.uniform(-75, -35, size=(n_objects, 2))
    family_of = rng.integers(0, n_families, size=n_objects)
    probs = rng.dirichlet(np.ones(n_states), size=(n_families, n_features))
    cdf_fam = np.cumsum(probs.astype(np.float32), axis=-1)
    values = np.empty((n_objects, n_features, n_states), dtype=bool)
    chunk = max(1, 25_000_000 // (n_features * n_states))
    states_row = np.arange(n_states)[None, None, :]
    for lo in range(0, n_objects, chunk):
        hi = min(lo + chunk, n_objects)
        cdf = cdf_fam[family_of[lo:hi]]
        u = rng.random((hi - lo, n_features, 1), dtype=np.float32)
        idx = (u > cdf).sum(-1)
        np.equal(idx[:, :, None], states_row, out=values[lo:hi])
        na = rng.random((hi - lo, n_features)) < na_fraction
        values[lo:hi][na] = False
    families = family_of[None, :] == np.arange(n_families)[:, None]
    return {"values": values, "applicable": np.ones((n_features, n_states), dtype=bool),
            "families": families, "locations": locations, "geodesic": False}


GENERATORS = {"small": small, "large": large}


def draw(spec: dict, seed: int) -> dict:
    """The arrays of a configuration's ``data`` section from ``seed``."""
    kw = {k: v for k, v in spec.items() if k != "generator"}
    return GENERATORS[spec["generator"]](**kw, seed=seed)
