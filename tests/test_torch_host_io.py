"""The port's CSV readers (the standard ``csv`` module and numpy) against the
JAX package's (pandas) on the same files, and the user's host workflow in a
process where pandas, h5py, PyYAML, JAX and matplotlib cannot be imported,
as on the card's machine."""
import json
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)

ROOT = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "fixtures"

# Quoted commas and line breaks, non-ASCII header and cell names, every NA
# token ("", " ", "\t", "  "), three spaces (not NA: "" after the strip), a
# confounder with NA cells, a BOM, CRLF line ends, blank and whitespace-only
# lines, a repeated and an unnamed header, a short row.
AWKWARD_FEATURES = (
    "﻿id,name,family,x,y,\"Fé, 1\",F2,Fß,notes,notes,\r\n"
    "o1,\"Zürich, CH\",famA,8.54,47.37,\"a,b\",X,Ä,\"line\r\nbreak\",n,u\r\n"
    "\r\n"
    "o2,obj2, famA ,8.9,47.1, B ,,Ä,   ,,\r\n"
    "   \r\n"
    "o3,obj3,,7.4,46.9,\t,Y,  ,\"q \"\"x\"\"\",,\r\n"
    "o4,Ørsted,famB,9.1,46.2, ,Y,b,,,\r\n"
    "\t\r\n"
    "o5,obj5, ,8.2,47.5,\"a,b\",X,b\r\n"
    "o6,obj6,\t,8.0,46.0,B,  ,b,,,\r\n"
    "o7,obj7,famé,7.6,47.6,a,b,Ä,,,\r\n"
)
AWKWARD_STATES = (
    "﻿\"Fé, 1\",F2,Fß\r\n"
    "\"a,b\",X,Ä\r\n"
    "B,Y,b\r\n"
    "a,b,\r\n"
)


def _write(tmp: Path, name: str, features: str, states: str, confounders: list) -> Path:
    """Both CSVs and a JSON config naming them (K = 1, uniform priors)."""
    d = tmp / name
    d.mkdir()
    (d / "features.csv").write_bytes(features.encode("utf-8"))
    (d / "feature_states.csv").write_bytes(states.encode("utf-8"))
    cfg = {
        "data": {"features": "features.csv", "feature_states": "feature_states.csv"},
        "model": {"clusters": 1, "confounders": confounders, "prior": {
            "objects_per_cluster": {"type": "uniform_area", "min": 1, "max": 5},
            "geo": {"type": "uniform"}, "weights": {"type": "uniform"},
            "cluster_effect": {"type": "uniform"},
            "confounding_effects": {c: {"<DEFAULT>": {"type": "uniform"}}
                                    for c in confounders}}},
        "mcmc": {"steps": 10, "samples": 10},
        "results": {"path": str(d / "results")},
    }
    (d / "config.json").write_text(json.dumps(cfg))
    return d


@pytest.fixture(params=["fixtures", "awkward"])
def data_dir(request, tmp_path):
    if request.param == "fixtures":
        return _write(tmp_path, "fixtures", (FIXTURES / "features.csv").read_text(),
                      (FIXTURES / "feature_states.csv").read_text(), ["universal", "family"])
    return _write(tmp_path, "awkward", AWKWARD_FEATURES, AWKWARD_STATES,
                  ["universal", "family", "notes"])


def _assert_same_data(data, jdata):
    f, jf = data.features, jdata.features
    np.testing.assert_array_equal(f.values, jf.values)
    np.testing.assert_array_equal(f.states, jf.states)
    np.testing.assert_array_equal(f.na_values, jf.na_values)
    assert f.state_names == jf.state_names
    assert f.names.tolist() == jf.names.tolist()
    assert f.na_number == jf.na_number
    o, jo = data.objects, jdata.objects
    assert (o.id, o.names) == (jo.id, jo.names)
    np.testing.assert_array_equal(o.locations, jo.locations)
    assert list(data.confounders) == list(jdata.confounders)
    for name, conf in data.confounders.items():
        np.testing.assert_array_equal(conf.group_assignment,
                                      jdata.confounders[name].group_assignment)
        assert conf.group_names == list(jdata.confounders[name].group_names)


def test_read_features_from_csv_equals_jax(data_dir):
    from sbayes_tpu.data import loader as jax_loader
    from sbayes_tpu_torch.data import loader

    confounders = ["universal", "family", "notes"]
    args = (data_dir / "features.csv", data_dir / "feature_states.csv", confounders)
    got = loader.read_features_from_csv(*args)
    want = jax_loader.read_features_from_csv(*args)
    _assert_same_data(loader.Data(*got), jax_loader.Data(*want))


def test_data_from_config_equals_jax(data_dir):
    """``Data.from_config`` of both packages on one JSON config, the
    distance matrix of the locations included."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdata = JaxData.from_config(JaxConfig.from_config_file(data_dir / "config.json"))
        data = Data.from_config(SBayesConfig.from_config_file(data_dir / "config.json"))
    _assert_same_data(data, jdata)
    np.testing.assert_array_equal(data.geo_cost_matrix, jdata.geo_cost_matrix)


def test_read_data_csv_equals_pandas(data_dir):
    """Every column and cell of the port's table against the JAX package's
    data frame (NA: ``None`` against NaN)."""
    from sbayes_tpu.utils import read_data_csv as jax_read
    from sbayes_tpu_torch.utils import read_data_csv

    for name in ("features.csv", "feature_states.csv"):
        got, want = read_data_csv(data_dir / name), jax_read(data_dir / name)
        assert list(got) == list(want.columns)
        assert got.n_rows == len(want)
        for col in got:
            expected = [None if isinstance(v, float) and np.isnan(v) else v for v in want[col]]
            assert got[col].tolist() == expected, col


def test_undefined_state_raises_like_jax(tmp_path):
    from sbayes_tpu.data.loader import read_features_from_csv as jax_read
    from sbayes_tpu_torch.data.loader import read_features_from_csv

    d = _write(tmp_path, "undefined", AWKWARD_FEATURES.replace("Ørsted,famB,9.1,46.2, ,Y,b",
                                                               "Ørsted,famB,9.1,46.2, ,Z,b"),
               AWKWARD_STATES, ["family"])
    args = (d / "features.csv", d / "feature_states.csv", ["family"])
    message = r"Features of feature `F2` contain states that are not defined .* \['Z'\]"
    with pytest.raises(ValueError, match=message):
        jax_read(*args)
    with pytest.raises(ValueError, match=message):
        read_features_from_csv(*args)


def test_repeated_states_raise_like_jax(tmp_path):
    """A feature_states column that names one state twice (once with
    spaces, stripped) is refused by both packages."""
    from sbayes_tpu.data.loader import read_features_from_csv as jax_read
    from sbayes_tpu_torch.data.loader import read_features_from_csv

    d = _write(tmp_path, "repeated", AWKWARD_FEATURES, AWKWARD_STATES + " B ,,\r\n", ["family"])
    args = (d / "features.csv", d / "feature_states.csv", ["family"])
    with pytest.raises(ValueError):
        jax_read(*args)
    with pytest.raises(ValueError, match=r"The states of feature `Fe, 1` .* not unique"):
        read_features_from_csv(*args)


def test_a_row_longer_than_the_header_raises(tmp_path):
    """A departure (ROADMAP C.9): pandas takes the extra field of such rows
    as the row's index and shifts every column; the port refuses the file."""
    import pandas as pd

    from sbayes_tpu_torch.utils import read_data_csv

    path = tmp_path / "long.csv"
    path.write_text("id,x\no1,1.0,extra\no2,2.0\n")
    assert pd.read_csv(path, dtype=str).loc["o1", "id"] == "1.0"
    with pytest.raises(ValueError, match="line 2: 3 fields, the header has 2"):
        read_data_csv(path)


@pytest.mark.parametrize("case", ["asymmetric", "na_cell"])
def test_costs_csv_reads_to_the_same_matrix(tmp_path, case):
    """Rows and columns in another order than the objects, a quoted label,
    an asymmetric matrix (averaged); an NA cell fails the same check."""
    from sbayes_tpu.data.geo import read_geo_cost_matrix as jax_read
    from sbayes_tpu_torch.data.geo import read_geo_cost_matrix

    ids = ["o1", "o,2", "o3", "o4"]
    rng = np.random.default_rng(3)
    costs = rng.uniform(0, 10, (4, 4)).round(3)
    np.fill_diagonal(costs, 0)
    order = [2, 0, 3, 1]
    lines = ["label," + ",".join(f'"{ids[j]}"' for j in order[::-1])]
    for i in order:
        lines.append(f'"{ids[i]}",' + ",".join(str(float(costs[i, j])) for j in order[::-1]))
    if case == "na_cell":
        lines[2] = lines[2].rsplit(",", 1)[0] + ",NA"
    path = tmp_path / "costs.csv"
    path.write_text("\n".join(lines) + "\n")
    if case == "na_cell":
        with pytest.raises(AssertionError, match="non-negative"):
            jax_read(ids, path)
        with pytest.raises(AssertionError, match="non-negative"):
            read_geo_cost_matrix(ids, path)
        return
    got, want = read_geo_cost_matrix(ids, path), jax_read(ids, path)
    assert got.dtype == want.dtype and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (costs + costs.T) / 2)


# The workflow without pandas, h5py, PyYAML, JAX or matplotlib: each of these
# is None in sys.modules, so importing it raises ImportError.
BLOCKED_SCRIPT = r"""
import json, sys
from pathlib import Path
for name in ("pandas", "h5py", "yaml", "jax", "jaxlib", "matplotlib", "pydantic"):
    sys.modules[name] = None
d = Path(sys.argv[1])
out = {}
from sbayes_tpu_torch.data.loader import read_features_from_csv
objects, features, confounders = read_features_from_csv(
    d / "features.csv", d / "feature_states.csv", ["universal", "family"])
out["features"] = [features.n_objects, features.n_features, features.na_number]
from sbayes_tpu_torch import simulation
simulation.main(d / "sim_config.json")
from sbayes_tpu_torch.tools.extract_prior_counts import extract_universal
extract_universal(d / "sim" / "simulated_features.csv",
                  d / "sim" / "simulated_feature_states.csv", d / "universal.json")
out["universal"] = json.loads((d / "universal.json").read_text())
from sbayes_tpu_torch.config.template import generate_template
out["template_lines"] = len(generate_template().splitlines())
from sbayes_tpu_torch import cli
cli.cli([str(d / "config.json"), "-n", "blocked", "--device", "cpu"])
from sbayes_tpu_torch.tools.subsample import subsample_file
stats = d / "results" / "blocked" / "K1" / "stats_K1_0.txt"
out["subsampled_rows"] = len(subsample_file(stats, 2).read_text().splitlines())
out["results"] = sorted(p.name for p in (d / "results" / "blocked" / "K1").iterdir())
cli.cli([str(d / "config_lh.json"), "-n", "with_lh", "--device", "cpu"])
out["with_lh_results"] = sorted(p.name for p in (d / "results" / "with_lh" / "K1").iterdir())
out["modules"] = sorted(m for m in ("pandas", "h5py", "yaml", "jax", "matplotlib")
                        if sys.modules.get(m) is not None)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def blocked_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("blocked")
    for f in ("features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, d / f)
    # a cost-based geo prior on a costs CSV: the cost reader runs too
    ids = ["o1", "o2", "o3", "o4", "o5"]
    rng = np.random.default_rng(0)
    costs = rng.uniform(1, 5, (5, 5)).round(2)
    costs = costs + costs.T
    np.fill_diagonal(costs, 0)
    (d / "costs.csv").write_text("\n".join(
        ["id," + ",".join(ids)] + [f"{ids[i]}," + ",".join(map(str, costs[i])) for i in range(5)]
    ) + "\n")
    cfg = yaml.safe_load((FIXTURES / "config.yaml").read_text())
    cfg["model"]["prior"]["geo"]["costs"] = "costs.csv"
    cfg["mcmc"].update(steps=100, samples=10, warmup={"warmup_steps": 10, "warmup_chains": 2})
    cfg["results"] = {"path": "results", "log_likelihood": False}
    (d / "config.json").write_text(json.dumps(cfg))
    cfg["results"]["log_likelihood"] = True
    (d / "config_lh.json").write_text(json.dumps(cfg))
    rows = ["id,x,y,cluster,family"]
    for i in range(20):
        rows.append(f"s{i},{rng.uniform(0, 10):.2f},{rng.uniform(0, 10):.2f},"
                    f"{1 if i < 5 else 0},{'' if i % 7 == 0 else f'fam{i % 3}'}")
    (d / "canvas.csv").write_text("\n".join(rows) + "\n")
    (d / "sim_config.json").write_text(json.dumps({
        "canvas": "canvas.csv", "results": {"path": "sim"}, "n_features": 6,
        "n_states": {"2": 0.5, "3": 0.5},
        "cluster_effect": {"intensity": 2.0, "concentration": 0.5},
        "confounding_effects": {"family": {"intensity": 1.0, "concentration": 0.5}},
        "seed": 7}))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_SCRIPT, str(d)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return d, json.loads(proc.stdout.strip().splitlines()[-1])


def test_workflow_runs_without_pandas_h5py_yaml_jax_matplotlib(blocked_run):
    """Reading CSV data, the simulation, prior-count extraction, the config
    template, ``cli`` on a JSON config over CSV files (cost-based geo prior
    on a costs CSV) and thinning the stats file, with those packages
    unimportable."""
    d, out = blocked_run
    assert out["features"] == [5, 2, 1]
    assert set(out["universal"]) == {f"f{i}" for i in range(1, 7)}
    assert out["template_lines"] == 130
    assert out["results"] == ["clusters_K1_0.txt", "operator_stats_K1_0.txt",
                              "state_K1_0.pickle", "stats_K1_0.txt",
                              "stats_K1_0_subsampled.txt"]
    assert out["subsampled_rows"] == 1 + 5
    assert out["modules"] == []


def test_log_likelihood_without_h5py_writes_the_file(blocked_run):
    """``results.log_likelihood: true`` without h5py: the run writes the
    likelihood file beside the others, and h5py reads it here: float32
    (samples, objects x features) and the data's NA mask as bool."""
    import h5py

    d, out = blocked_run
    assert out["with_lh_results"] == ["clusters_K1_0.txt", "likelihood_K1_0.h5",
                                      "operator_stats_K1_0.txt", "state_K1_0.pickle",
                                      "stats_K1_0.txt"]
    with h5py.File(d / "results" / "with_lh" / "K1" / "likelihood_K1_0.h5", "r") as f:
        assert f["likelihood"].dtype == np.dtype("<f4") and f["likelihood"].shape == (10, 10)
        assert f["na_values"].dtype == np.dtype(bool) and f["na_values"][()].sum() == 1
        assert np.all(np.isfinite(f["likelihood"][()]))
