"""The port's tools (``sbayes_tpu_torch/tools``) against the JAX package's on
the same inputs (mirrors ``tests/test_tools.py`` and
``tests/test_elpd_integration.py``): output files equal byte for byte,
tables exactly, PSIS-LOO and the ELPD within 1e-12 relative. The results
that the ELPD, diagnostics, alignment and thinning read are written by the
port's CLI on the CPU (K = 1 and 2, two runs each, likelihood files on)."""
import json
import shutil
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)

FIXTURES = Path(__file__).parent / "fixtures"
REL = 1e-12


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """``results/elpd_exp/K{1,2}/``, written by ``sbayes_tpu_torch.cli.main``."""
    from sbayes_tpu_torch import cli

    d = tmp_path_factory.mktemp("port_results")
    for f in ("features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, d / f)
    cfg = yaml.safe_load((FIXTURES / "config.yaml").read_text())
    cfg["mcmc"].update(steps=400, samples=100, runs=2,
                       warmup={"warmup_steps": 20, "warmup_chains": 2})
    cfg["results"] = {"path": "results"}
    (d / "config.json").write_text(json.dumps(cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(d / "config.json", experiment_name="elpd_exp", n_clusters=[1, 2],
                 device="cpu")
    return d / "results"


def _assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               rtol=REL, atol=0)


def test_psis_loo_over_the_port_likelihood_files_equals_jax(port_results):
    from sbayes_tpu.tools import elpd as jax_elpd, psis as jax_psis
    from sbayes_tpu_torch.tools import elpd, psis

    files = sorted(port_results.rglob("likelihood_K*_*.h5"))
    assert [f.name for f in files] == ["likelihood_K1_0.h5", "likelihood_K1_1.h5",
                                       "likelihood_K2_0.h5", "likelihood_K2_1.h5"]
    for f in files:
        log_lik = elpd.read_log_likelihood(f, 0.1)
        np.testing.assert_array_equal(log_lik, jax_elpd.read_log_likelihood(f, 0.1))
        assert log_lik.shape == (90, 9)       # 100 samples less 10%, 5 x 2 less one NA
        got, want = psis.psis_loo(log_lik), jax_psis.psis_loo(log_lik)
        assert np.all(np.isfinite(got[2]))
        for g, w in zip(got, want):
            _assert_close(g, w)


def test_psis_loo_on_normal_samples_equals_jax():
    """``tests/test_tools.py::test_psis_loo_sane``'s input."""
    from sbayes_tpu.tools.psis import psis_loo as jax_psis_loo
    from sbayes_tpu_torch.tools.psis import psis_loo

    rng = np.random.default_rng(0)
    mu = rng.normal(0, 0.1, size=(2000, 1))
    x = rng.normal(0, 1.0, size=(1, 20))
    log_lik = -0.5 * np.log(2 * np.pi) - 0.5 * (x - mu) ** 2
    elpd, elpd_i, khats = psis_loo(log_lik)
    for g, w in zip((elpd, elpd_i, khats), jax_psis_loo(log_lik)):
        _assert_close(g, w)
    assert np.all(khats < 0.7)
    assert abs(elpd - np.sum(-0.5 * np.log(2 * np.pi) - 0.5 * x ** 2)) < 5.0


def test_elpd_over_the_port_results_equals_jax(port_results, tmp_path):
    from sbayes_tpu.tools.elpd import main as jax_main
    from sbayes_tpu_torch.tools.elpd import main

    df = pd.DataFrame(main(port_results, burnin=0.1, plot_path=tmp_path / "elpd.png"))
    want = jax_main(port_results, burnin=0.1, plot_path=tmp_path / "elpd_jax.png")
    assert (tmp_path / "elpd.png").exists()
    assert df[["experiment", "k", "run"]].values.tolist() == [
        ["elpd_exp", 1, 0], ["elpd_exp", 1, 1], ["elpd_exp", 2, 0], ["elpd_exp", 2, 1]]
    pd.testing.assert_frame_equal(df.drop(columns="elpd_loo"), want.drop(columns="elpd_loo"))
    # NaN where the JAX package's is NaN too (ROADMAP C.11)
    _assert_close(df.elpd_loo, want.elpd_loo)
    assert np.isfinite(df.elpd_loo).sum() >= 3


def test_diagnostics_over_the_port_results_equals_jax(port_results):
    from sbayes_tpu.tools.diagnostics import analyze as jax_analyze
    from sbayes_tpu_torch.tools.diagnostics import analyze, main

    df = pd.DataFrame(analyze(port_results, 0.1))
    pd.testing.assert_frame_equal(df, jax_analyze(port_results, 0.1), check_exact=True)
    assert df[["K", "parameter", "runs", "samples_per_run"]].values.tolist() == [
        [1, "posterior", 2, 90], [1, "likelihood", 2, 90],
        [2, "posterior", 2, 90], [2, "likelihood", 2, 90]]
    pd.testing.assert_frame_equal(pd.DataFrame(main([str(port_results)])), df)


@pytest.mark.parametrize("tool", ["align", "realign"])
def test_align_clusters_over_the_port_results_equals_jax(port_results, tmp_path, tool):
    """The command lines of both packages, each on its own copy of the
    port's results: the aligned clusters and stats files are equal."""
    from sbayes_tpu.tools import align_clusters as jax_align
    from sbayes_tpu_torch.tools import align_clusters

    outputs = {}
    for name, module in (("jax", jax_align), ("torch", align_clusters)):
        exp = tmp_path / name
        shutil.copytree(port_results / "elpd_exp", exp)
        if tool == "align":
            module.cli_align(["-k", "2", str(exp), "0", str(exp), "1"])
            run = 1
        else:
            module.cli_realign([str(exp), "2", "0"])
            run = 0
        outputs[name] = [(exp / "K2" / f"{p}_K2_{run}.aligned.txt").read_bytes()
                         for p in ("clusters", "stats")]
    assert outputs["torch"] == outputs["jax"]
    assert len(outputs["torch"][0].decode().splitlines()) == 100


def test_align_clusters_roundtrip():
    """``tests/test_tools.py::test_align_clusters_roundtrip`` on the port:
    run 2 is run 1 with permuted labels; alignment undoes the permutation."""
    from sbayes_tpu_torch.results.results import Results
    from sbayes_tpu_torch.tools.align_clusters import align_two_runs

    rng = np.random.default_rng(1)
    n_samples, K, N = 30, 3, 8
    clusters1 = rng.random((K, n_samples, N)) < 0.3
    cols = ["Sample", "posterior", "likelihood", "prior"] + [f"size_a{i}" for i in range(K)]
    cols += [f"areal_a{i}_f1_s{j}" for i in range(K) for j in range(2)]
    params1 = pd.DataFrame(rng.random((n_samples, len(cols))), columns=cols)
    for i in range(K):
        params1[f"size_a{i}"] = clusters1[i].sum(-1)
    perm = np.array([2, 0, 1])
    params2 = params1.copy()
    for i, j in enumerate(perm):
        params2[f"size_a{i}"] = params1[f"size_a{j}"]
        for jj in range(2):
            params2[f"areal_a{i}_f1_s{jj}"] = params1[f"areal_a{j}_f1_s{jj}"]
    aligned_clusters, aligned_params = align_two_runs(
        Results(clusters1, params1, burn_in=0), Results(clusters1[perm], params2, burn_in=0))
    np.testing.assert_array_equal(aligned_clusters.transpose((1, 0, 2)), clusters1)
    pd.testing.assert_frame_equal(pd.DataFrame(aligned_params), params1)


def test_subsample_over_the_port_results_equals_jax(port_results, tmp_path):
    from sbayes_tpu.tools.subsample import subsample_file as jax_subsample
    from sbayes_tpu_torch.tools.subsample import cli

    for prefix in ("stats", "clusters"):
        src = port_results / "elpd_exp" / "K2" / f"{prefix}_K2_0.txt"
        for name in ("jax", "torch"):
            (tmp_path / name).mkdir(exist_ok=True)
            shutil.copy(src, tmp_path / name / src.name)
        jax_subsample(tmp_path / "jax" / src.name, 3)
        cli(["3", "-f", str(tmp_path / "torch" / src.name)])
        out = f"{prefix}_K2_0_subsampled.txt"
        got = (tmp_path / "torch" / out).read_bytes()
        assert got == (tmp_path / "jax" / out).read_bytes()
        assert len(got.decode().splitlines()) == 34 + (prefix == "stats")


def _same_files(tmp_path, run, names):
    """``run(package, out_dir)`` for both packages; the files ``names`` of
    both output directories are equal. Returns the port's directory."""
    import sbayes_tpu
    import sbayes_tpu_torch

    for package in (sbayes_tpu, sbayes_tpu_torch):
        (tmp_path / package.__name__).mkdir()
        run(package.__name__, tmp_path / package.__name__)
    for name in names:
        got = (tmp_path / "sbayes_tpu_torch" / name).read_bytes()
        assert got == (tmp_path / "sbayes_tpu" / name).read_bytes(), name
    return tmp_path / "sbayes_tpu_torch"


def _import(package: str, module: str):
    return __import__(f"{package}.{module}", fromlist=["_"])


def _awkward_data(tmp_path) -> Path:
    from test_torch_host_io import AWKWARD_FEATURES

    path = tmp_path / "awkward.csv"
    path.write_bytes(AWKWARD_FEATURES.encode("utf-8"))
    return path


def test_extract_feature_states_equals_jax(tmp_path):
    """From the fixture's features and from the awkward file of
    ``test_torch_host_io`` (quoted commas and line breaks, NA tokens)."""
    awkward = _awkward_data(tmp_path)

    def run(package, out):
        extract = _import(package, "tools.extract_feature_states").extract
        extract([FIXTURES / "features.csv"], out / "one.csv")
        extract([awkward], out / "awkward.csv")

    d = _same_files(tmp_path, run, ["one.csv", "awkward.csv"])
    df = pd.read_csv(d / "one.csv")
    assert df["F1"].dropna().tolist() == ["A", "B", "C"]
    assert df["F2"].dropna().tolist() == ["X", "Y"]


def test_extract_prior_counts_equals_jax(tmp_path):
    def run(package, out):
        tools = _import(package, "tools.extract_prior_counts")
        args = (FIXTURES / "features.csv", FIXTURES / "feature_states.csv")
        tools.extract_universal(*args, out / "universal.json")
        tools.extract_universal(*args, out / "universal_scaled.json", add=0.5, max_counts=2)
        tools.extract_inheritance(*args, out)
        _import(package, "tools.extract_universal_prior_counts").main(
            ["--data", str(args[0]), "--featureStates", str(args[1]),
             "--output", str(out / "universal_cli.json")])
        _import(package, "tools.extract_inheritance_prior_counts").main(
            ["--data", str(args[0]), "--featureStates", str(args[1]),
             "--output", str(out / "cli"), "--scaleCounts", "1"])

    d = _same_files(tmp_path, run, ["universal.json", "universal_scaled.json", "famA.json",
                                    "famB.json", "universal_cli.json", "cli/famA.json",
                                    "cli/famB.json"])
    assert json.loads((d / "universal.json").read_text())["F1"] == {"A": 3.0, "B": 3.0, "C": 2.0}
    assert json.loads((d / "famA.json").read_text())["F1"] == {"A": 2.0, "B": 2.0, "C": 1.0}


def test_convert_prior_csv_to_json_equals_jax(tmp_path):
    csv_path = tmp_path / "prior.csv"
    csv_path.write_text("feature,A,B,C\nF1,1.5,2.5,\nF2,3.0,4.0,5.0\n")

    def run(package, out):
        _import(package, "tools.convert_prior_csv_to_json").main(
            ["--csv", str(csv_path), "--output", str(out / "prior.json")])

    d = _same_files(tmp_path, run, ["prior.json"])
    assert json.loads((d / "prior.json").read_text())["F1"] == {"A": 1.5, "B": 2.5}


def test_guess_feature_types_equals_jax(tmp_path):
    awkward = _awkward_data(tmp_path)

    def run(package, out):
        main = _import(package, "tools.guess_feature_types").main
        main(["--input", str(FIXTURES / "features.csv"), "--output", str(out / "types.csv")])
        main(["--input", str(awkward), "--output", str(out / "awkward.csv")])

    d = _same_files(tmp_path, run, ["types.csv", "awkward.csv"])
    df = pd.read_csv(d / "types.csv").set_index("feature")
    assert df.loc["F1", "guessed_type"] == "categorical"
    assert (df.loc["F2", "guessed_type"], df.loc["F2", "n_na"]) == ("binary", 1)


def test_find_correlated_features_equals_jax(tmp_path):
    """Four features of 60 objects, two of them correlated: the port's
    p-value CSV equals the JAX package's ``pairwise_chi2`` written as its
    ``main`` writes it, and the port writes its plot. (The JAX tool's plot
    step writes into ``DataFrame.values``, which pandas' copy-on-write makes
    read-only from pandas 3 on: ROADMAP C.10.)"""
    from sbayes_tpu.tools import find_correlated_features as jax_tool
    from sbayes_tpu.utils import normalize_str, read_data_csv
    from sbayes_tpu_torch.tools.find_correlated_features import main

    rng = np.random.default_rng(4)
    a = rng.integers(0, 3, 60)
    cols = {"id": [f"o{i}" for i in range(60)], "name": [f"n{i}" for i in range(60)],
            "family": rng.choice(["f1", "f2"], 60).tolist(), "x": rng.random(60).tolist(),
            "y": rng.random(60).tolist(), "A": a.tolist(),
            "B": ((a + (rng.random(60) < 0.1)) % 3).tolist(),
            "C": rng.integers(0, 2, 60).tolist(), "D": rng.choice(["p", "q", ""], 60).tolist()}
    data = tmp_path / "data.csv"
    pd.DataFrame(cols).to_csv(data, index=False)

    main(["--input", str(data), "--output", str(tmp_path / "corr.png")])
    features = read_data_csv(data).drop(jax_tool.METADATA_COLUMNS, axis=1).map(normalize_str)
    jax_tool.pairwise_chi2(features).to_csv(tmp_path / "corr_jax.csv")
    assert (tmp_path / "corr.csv").read_bytes() == (tmp_path / "corr_jax.csv").read_bytes()
    assert (tmp_path / "corr.png").exists()
    p = pd.read_csv(tmp_path / "corr.csv", index_col=0)
    assert p.loc["A", "B"] < 1e-4 < p.loc["A", "C"]


TOOLS_WITHOUT_PANDAS = r"""
import json, sys, warnings
from pathlib import Path
sys.modules["pandas"] = None
results, work, data, prior = (Path(a) for a in sys.argv[1:5])
out = {}
from sbayes_tpu_torch.results.results import Results
k2 = results / "elpd_exp" / "K2"
res = Results.from_csv_files(k2 / "clusters_K2_0.txt", k2 / "stats_K2_0.txt")
out["results"] = {
    "sample_id": res.sample_id.tolist(), "posterior": res.posterior.tolist(),
    "likelihood": res.likelihood.tolist(), "prior": res.prior.tolist(),
    "weights": {f: w.tolist() for f, w in res.weights.items()},
    "areal_effect": {c: {f: p.tolist() for f, p in e.items()}
                     for c, e in res.areal_effect.items()},
    "confounding_effects": {c: {g: {f: p.tolist() for f, p in e.items()} for g, e in gs.items()}
                            for c, gs in res.confounding_effects.items()},
    "clusters": res.clusters.tolist(), "cluster_names": res.cluster_names}
from sbayes_tpu_torch.tools import elpd, diagnostics, align_clusters, realign_clusters_within_run
from sbayes_tpu_torch.tools import convert_prior_csv_to_json, guess_feature_types
from sbayes_tpu_torch.tools import find_correlated_features
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    out["elpd"] = {k: v.tolist() for k, v in elpd.main(results, 0.1, work / "elpd.png").items()}
out["diagnostics"] = {k: v.tolist() for k, v in diagnostics.main([str(results)]).items()}
align_clusters.cli_align(["-k", "2", str(work / "align"), "0", str(work / "align"), "1"])
realign_clusters_within_run.main([str(work / "realign"), "2", "0"])
convert_prior_csv_to_json.main(["--csv", str(prior), "--output", str(work / "prior.json")])
guess_feature_types.main(["--input", str(data), "--output", str(work / "types.csv")])
find_correlated_features.main(["--input", str(data), "--output", str(work / "corr.png")])
out["modules"] = sorted(m for m in ("pandas",) if sys.modules.get(m) is not None)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tools_without_pandas(port_results, tmp_path_factory):
    """``Results`` and the seven tools that read or wrote tables with pandas
    in the JAX package, run in a subprocess with pandas unimportable (as on
    the card's machine) over the port's results, a prior CSV and a data
    CSV; the JAX tools then write their files from the same inputs."""
    import subprocess
    import sys

    work = tmp_path_factory.mktemp("no_pandas")
    jax_dir = tmp_path_factory.mktemp("jax_tools")
    for d in (work, jax_dir):
        for name in ("align", "realign"):
            shutil.copytree(port_results / "elpd_exp", d / name)
    prior = work / "prior.csv"
    prior.write_text("feature,A,B,C\nF1,1.5,2.5,\nF2,3.0,4.0,5.0\n")
    data = work / "data.csv"
    rng = np.random.default_rng(7)
    a = rng.integers(0, 3, 40)
    rows = ["id,name,family,x,y,A,B,C"] + [
        f"o{i},n{i},{'f1' if i % 2 else 'f2'},{i},{-i},{a[i]},{(a[i] + (i % 7 == 0)) % 3},"
        f"{'' if i % 9 == 0 else rng.integers(0, 2)}" for i in range(40)]
    data.write_text("\n".join(rows) + "\n")
    proc = subprocess.run([sys.executable, "-c", TOOLS_WITHOUT_PANDAS, str(port_results),
                           str(work), str(data), str(prior)],
                          cwd=Path(__file__).parent.parent, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])

    from sbayes_tpu.tools import align_clusters as jax_align
    from sbayes_tpu.tools import convert_prior_csv_to_json, find_correlated_features
    from sbayes_tpu.tools import guess_feature_types
    from sbayes_tpu.utils import normalize_str, read_data_csv

    jax_align.cli_align(["-k", "2", str(jax_dir / "align"), "0", str(jax_dir / "align"), "1"])
    jax_align.cli_realign([str(jax_dir / "realign"), "2", "0"])
    convert_prior_csv_to_json.main(["--csv", str(prior), "--output", str(jax_dir / "prior.json")])
    guess_feature_types.main(["--input", str(data), "--output", str(jax_dir / "types.csv")])
    features = read_data_csv(data).drop(find_correlated_features.METADATA_COLUMNS,
                                        axis=1).map(normalize_str)
    find_correlated_features.pairwise_chi2(features).to_csv(jax_dir / "corr.csv")
    return out, work, jax_dir


def test_results_without_pandas_equals_jax(port_results, tools_without_pandas):
    """``Results.from_csv_files`` with pandas blocked gives the JAX
    ``Results``' arrays (burn-in dropped, weights, effects, traces)."""
    from sbayes_tpu.results.results import Results as JaxResults

    out = tools_without_pandas[0]["results"]
    k2 = port_results / "elpd_exp" / "K2"
    want = JaxResults.from_csv_files(k2 / "clusters_K2_0.txt", k2 / "stats_K2_0.txt")
    assert out["sample_id"] == want.sample_id.tolist() and len(out["sample_id"]) == 90
    for key in ("posterior", "likelihood", "prior"):
        assert out[key] == getattr(want, key).tolist(), key
    assert out["weights"] == {f: w.tolist() for f, w in want.weights.items()}
    assert out["areal_effect"] == {c: {f: np.asarray(p).tolist() for f, p in e.items()}
                                   for c, e in want.areal_effect.items()}
    assert out["confounding_effects"] == {
        c: {g: {f: np.asarray(p).tolist() for f, p in e.items()} for g, e in gs.items()}
        for c, gs in want.confounding_effects.items()}
    assert out["clusters"] == want.clusters.tolist()
    assert out["cluster_names"] == want.cluster_names == ["a0", "a1"]


@pytest.mark.parametrize("tool", ["elpd", "diagnostics"])
def test_table_tools_without_pandas_equal_jax(port_results, tools_without_pandas, tool):
    """The tables of ``elpd`` (h5py still reads the likelihood files) and
    ``diagnostics``, computed with pandas blocked, equal the JAX tools'."""
    from sbayes_tpu.tools import diagnostics as jax_diagnostics, elpd as jax_elpd

    out = tools_without_pandas[0]
    assert out["modules"] == []
    if tool == "elpd":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_elpd.main(port_results, 0.1)
        got = pd.DataFrame(out["elpd"])
        assert got[["experiment", "k", "run"]].values.tolist() == \
            want[["experiment", "k", "run"]].values.tolist()
        _assert_close(got.elpd_loo, want.elpd_loo)
        assert (tools_without_pandas[1] / "elpd.png").exists()
    else:
        want = jax_diagnostics.analyze(port_results, 0.1)
        assert out["diagnostics"] == {c: want[c].tolist() for c in want.columns}


@pytest.mark.parametrize("name", ["align/K2/clusters_K2_1.aligned.txt",
                                  "align/K2/stats_K2_1.aligned.txt",
                                  "realign/K2/clusters_K2_0.aligned.txt",
                                  "realign/K2/stats_K2_0.aligned.txt",
                                  "prior.json", "types.csv", "corr.csv"])
def test_file_tools_without_pandas_equal_jax(tools_without_pandas, name):
    """Each file that ``align_clusters``, ``realign_clusters_within_run``,
    ``convert_prior_csv_to_json``, ``guess_feature_types`` and
    ``find_correlated_features`` write with pandas blocked equals the JAX
    tool's, byte for byte."""
    _out, work, jax_dir = tools_without_pandas
    got = (work / name).read_bytes()
    assert got == (jax_dir / name).read_bytes()
    assert len(got.splitlines()) >= 3
