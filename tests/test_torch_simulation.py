"""The port's simulation (``sbayes_tpu_torch/simulation.py``: the ``csv``
module in place of pandas) against the JAX package's: one config and seed
give the same features, feature states and ground truth, and the port's
files load to equal arrays through both packages' readers."""
import csv
import json
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)


def _canvas(path: Path, case: str) -> dict:
    """A canvas CSV and the simulation config of one case."""
    rng = np.random.default_rng(0)
    if case == "one_confounder":
        # tests/test_tools.py::test_simulation_roundtrip's canvas and config
        rows = ["id,x,y,cluster,age"]
        for i in range(12):
            cl = 1 if i < 4 else (2 if i < 8 else 0)
            age = "old" if i % 2 == 0 else "young"
            rows.append(f"s{i},{rng.uniform(0, 10):.2f},{rng.uniform(0, 10):.2f},{cl},{age}")
        effects = {"age": {"intensity": 1.0, "concentration": 0.5}}
        n_features, n_states, seed = 10, {"2": 0.5, "3": 0.5}, 42
    else:
        # three clusters, a universal column, families with sites in none,
        # unrounded coordinates and a quoted family name
        rows = ["id,x,y,cluster,universal,family"]
        for i in range(40):
            cl = i // 8 + 1 if i < 24 else 0
            fam = "" if i % 9 == 0 else ("fam, 0" if i % 4 == 0 else f"fam{i % 4}")
            rows.append(f"s{i},{rng.uniform(-5, 5)},{rng.uniform(40, 50)},{cl},all,\"{fam}\"")
        effects = {"universal": {"intensity": 1.0, "concentration": 1.0},
                   "family": {"intensity": 1.5, "concentration": 0.5}}
        n_features, n_states, seed = 13, {"2": 0.2, "3": 0.2, "4": 0.2, "6": 0.3}, 5
    path.write_text("\n".join(rows) + "\n")
    return {"canvas": path.name, "results": {"path": "sim"}, "n_features": n_features,
            "n_states": n_states,
            "cluster_effect": {"intensity": 3.0, "concentration": 0.5},
            "confounding_effects": effects, "seed": seed}


def _rows(path: Path) -> list:
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.reader(f))


@pytest.fixture(params=["one_confounder", "universal_family"])
def simulated(request, tmp_path):
    from sbayes_tpu.simulation import main as jax_main
    from sbayes_tpu_torch.simulation import main

    out = {}
    for name, run in (("jax", jax_main), ("torch", main)):
        d = tmp_path / name
        d.mkdir()
        cfg = _canvas(d / "canvas.csv", request.param)
        (d / "sim_config.json").write_text(json.dumps(cfg))
        with np.errstate(invalid="ignore"):   # sites in no group and no cluster
            run(d / "sim_config.json")
        out[name] = d / "sim"
    return out, list(cfg["confounding_effects"])


def test_simulation_equals_jax(simulated):
    dirs, _ = simulated
    for name in ("simulated_features.csv", "simulated_feature_states.csv"):
        assert _rows(dirs["torch"] / name) == _rows(dirs["jax"] / name), name
    for name in ("ground_truth_clusters.txt", "ground_truth_weights.txt"):
        np.testing.assert_array_equal(np.loadtxt(dirs["torch"] / name),
                                      np.loadtxt(dirs["jax"] / name))


def test_simulated_files_load_through_both_readers(simulated):
    from sbayes_tpu.data.loader import read_features_from_csv as jax_read
    from sbayes_tpu_torch.data.loader import read_features_from_csv

    dirs, confounders = simulated
    d = dirs["torch"]
    args = (d / "simulated_features.csv", d / "simulated_feature_states.csv", confounders)
    objects, features, conf = read_features_from_csv(*args)
    jobjects, jfeatures, jconf = jax_read(*args)
    np.testing.assert_array_equal(features.values, jfeatures.values)
    np.testing.assert_array_equal(features.states, jfeatures.states)
    assert features.state_names == jfeatures.state_names
    np.testing.assert_array_equal(objects.locations, jobjects.locations)
    for name in confounders:
        assert conf[name].group_names == list(jconf[name].group_names)
        np.testing.assert_array_equal(conf[name].group_assignment,
                                      jconf[name].group_assignment)
    assert features.na_number == 0
    # the simulated states are the observed ones, one per object and feature
    assert np.all(features.values.sum(-1) == 1)
