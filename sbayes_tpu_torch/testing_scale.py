"""Vectorized synthetic data generator for large-scale workloads.

Copy of ``sbayes_tpu/testing_scale.py`` for the PyTorch port (numpy, drawn
from a seed): the same arrays from the same arguments. ``synthetic_data``
draws each observation in a Python loop (fine at 100x36); this generator is
fully vectorized for the 10k x 5k scale-up workload (BASELINE.json
configs[4]).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from sbayes_tpu_torch.data.loader import Confounder, Data, Features, Objects


def synthetic_data_large(
    n_objects: int = 10_000,
    n_features: int = 5_000,
    n_states: int = 5,
    n_families: int = 10,
    na_fraction: float = 0.01,
    seed: int = 0,
    cache_dir: str = None,
) -> Data:
    """``cache_dir`` (optional): persist the drawn arrays to an .npz there so
    that repeat runs skip the generation."""
    import os

    cache = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        key = f"scale_{n_objects}x{n_features}x{n_states}_fam{n_families}_s{seed}.npz"
        cache = os.path.join(cache_dir, key)
        if os.path.exists(cache):
            z = np.load(cache)
            return _assemble_data(z["values"], z["family_of"], z["locations"],
                                  int(z["na_number"]), n_states, n_families)
    import sys
    import time as _t

    def _stage(msg):
        print(f"  [datagen +{_t.perf_counter() - _t0:.0f}s] {msg}", file=sys.stderr, flush=True)

    _t0 = _t.perf_counter()
    rng = np.random.default_rng(seed)

    locations = rng.uniform(-75, -35, size=(n_objects, 2))
    family_of = rng.integers(0, n_families, size=n_objects)
    probs = rng.dirichlet(np.ones(n_states), size=(n_families, n_features))

    # Vectorized categorical draw: inverse-CDF over the state axis,
    # chunked over objects. This environment first-touches fresh pages at
    # only a few MB/s, so GB-sized temporaries dominate wall time — the
    # chunking keeps temps ~25 MB (warm pages) and touches only the
    # (N, F, S) bool output once.
    _stage("drawing features")
    cdf_fam = np.cumsum(probs.astype(np.float32), axis=-1)  # (fam, F, S) tiny
    values = np.empty((n_objects, n_features, n_states), dtype=bool)
    na_number = 0
    chunk = max(1, 25_000_000 // (n_features * n_states))
    states_row = np.arange(n_states)[None, None, :]
    for lo in range(0, n_objects, chunk):
        hi = min(lo + chunk, n_objects)
        cdf = cdf_fam[family_of[lo:hi]]                       # (m, F, S)
        u = rng.random((hi - lo, n_features, 1), dtype=np.float32)
        idx = (u > cdf).sum(-1)                               # (m, F)
        np.equal(idx[:, :, None], states_row, out=values[lo:hi])
        na = rng.random((hi - lo, n_features)) < na_fraction
        values[lo:hi][na] = False
        na_number += int(na.sum())

    _stage("features drawn")
    if cache is not None:
        np.savez(cache, values=values, family_of=family_of, locations=locations,
                 na_number=na_number)
        _stage(f"cached to {cache}")

    return _assemble_data(values, family_of, locations, na_number,
                          n_states, n_families)


def _assemble_data(values, family_of, locations, na_number,
                   n_states, n_families) -> Data:
    n_objects, n_features = values.shape[:2]
    ids = [f"o{i}" for i in range(n_objects)]
    objects = Objects(id=ids, locations=locations, names=list(ids))
    applicable = np.ones((n_features, n_states), dtype=bool)

    state_names = [[f"s{j}" for j in range(n_states)] for _ in range(n_features)]
    features = Features(
        values=values,
        names=np.asarray([f"f{j}" for j in range(n_features)]),
        states=applicable,
        state_names=state_names,
        na_number=na_number,
    )

    fam_names = [f"fam{i}" for i in range(n_families)]
    fam_assign = family_of[None, :] == np.arange(n_families)[:, None]
    confounders = OrderedDict(
        universal=Confounder("universal", np.ones((1, n_objects), bool), ["<ALL>"]),
        family=Confounder("family", fam_assign, fam_names),
    )

    # projection=None: planar distances (skips the 10k x 10k geodesic solve)
    return Data(objects=objects, features=features, confounders=confounders,
                projection=None, geo_costs="from_data")
