"""Resume and the MC3 command line of the PyTorch port, on the CPU, against
the JAX package: the MC3 run writes the JAX CLI's file set and stats header
(tests/test_e2e.py:199-261), a partial run resumes to the full row count
with continuous sample ids (tests/test_e2e.py:39), a finished run's resume
writes nothing (:120), the resume from the clusters and stats files alone
imputes a valid source, a state pickle written by the JAX CLI resumes in the
port, and the STEP-TIME column of the operator statistics holds the
per-operator timing probe.

Tolerance: a pickle's log-likelihood and log-prior against the port's
recompute 1e-4 relative (float32 sums in another order)."""
import pickle
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)
import torch

FIXTURES = Path(__file__).parent / "fixtures"
MC3 = {"steps": 200, "samples": 10, "warmup": {"warmup_steps": 20, "warmup_chains": 2},
       "mc3": {"activate": True, "chains": 3, "swap_interval": 20, "temperature_diff": 0.2}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fixture_dir(tmp_path):
    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    return tmp_path


def _settings(root: Path, mcmc=None, results=None) -> dict:
    from sbayes_tpu_torch.utils import update_recursive

    s = {"results": {"path": str(root / "results")}, "mcmc": {}}
    update_recursive(s, {"mcmc": mcmc or {}, "results": results or {}})
    return s


def _port(root: Path, name: str, settings: dict, resume: bool = False) -> Path:
    from sbayes_tpu_torch.cli import main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(root / "config.yaml", experiment_name=name, custom_settings=settings,
             resume=resume, device="cpu")
    return root / "results" / name / "K1"


def _rows(path: Path) -> list:
    lines = path.read_text().splitlines()
    return [dict(zip(lines[0].split("\t"), line.split("\t"))) for line in lines[1:]]


def _jax_mc3_expected(root: Path, settings: dict, with_swaps: bool):
    """The files the JAX CLI writes for this MC3 config (relative to K1/) and
    its stats header, from the JAX package's own MCMCSetup and loggers."""
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu.experiment import Experiment as JaxExperiment
    from sbayes_tpu.results.loggers import ParametersCSVLogger as JaxStats
    from sbayes_tpu.sampling.runner import MCMCSetup as JaxSetup
    from sbayes_tpu.utils import update_recursive

    jax_settings = update_recursive(
        {k: dict(v) for k, v in settings.items()},
        {"results": {"path": str(root / "jax_results")}})
    exp = JaxExperiment(root / "config.yaml", "jax_mc3", custom_settings=jax_settings, log=False)
    setup = JaxSetup(JaxData.from_experiment(exp), exp)
    files, header = [], None
    for chain in range(exp.config.mcmc.mc3.chains):
        for lg in setup.get_sample_loggers(0, resume=False, chain=chain):
            files.append(str(lg.path.relative_to(setup.path_results)))
            if chain == 0 and isinstance(lg, JaxStats):
                lg.open()
                lg.write_header(None)
                lg.close()
                header = lg.path.read_text().splitlines()[0]
    if with_swaps:
        files.append("mc3_swaps_K1_0.txt")
    return sorted(files), header


def _files(out: Path) -> list:
    return sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())


def test_mc3_cli_writes_the_jax_files(fixture_dir):
    """``mcmc.mc3.activate`` through the port's CLI: the JAX CLI's file set
    (the cold rung's files, ``hot_chains/`` with ``.chain{c}`` files, the
    swap matrix), the same stats header for every rung, one row per sample
    with the rung index as ``sample_id``, and a 3 x 3 swap matrix of
    accepted swaps within the attempts."""
    settings = _settings(fixture_dir, MC3)
    want_files, want_header = _jax_mc3_expected(fixture_dir, settings, with_swaps=True)
    out = _port(fixture_dir, "mc3", settings)
    assert _files(out) == want_files
    for chain, stats in enumerate([out / "stats_K1_0.txt",
                                   out / "hot_chains" / "stats_K1_0.chain1.txt",
                                   out / "hot_chains" / "stats_K1_0.chain2.txt"]):
        assert stats.read_text().splitlines()[0] == want_header
        rows = _rows(stats)
        assert [int(r["Sample"]) for r in rows] == list(range(20, 201, 20))
        assert {r["sample_id"] for r in rows} == {str(chain)}
        assert all(np.isfinite(float(r["posterior"])) for r in rows)
    m = np.loadtxt(out / "mc3_swaps_K1_0.txt")
    assert m.shape == (3, 3) and m.sum() > 0 and np.all(np.tril(m) == 0)
    assert m.sum() <= 10 * 3                        # 10 phases of 3 attempts


def test_mc3_cli_without_hot_chain_logs_or_swaps(fixture_dir):
    """With ``log_hot_chains: false`` the hot rungs write only their state
    pickle, and with a swap interval beyond the run no swap was attempted,
    so no swap matrix is written: the JAX CLI's file set in both respects."""
    settings = _settings(fixture_dir, {
        "steps": 100, "samples": 5, "warmup": {"warmup_steps": 10, "warmup_chains": 2},
        "mc3": {"activate": True, "chains": 3, "swap_interval": 1000, "temperature_diff": 0.2}},
        {"log_hot_chains": False})
    want_files, _ = _jax_mc3_expected(fixture_dir, settings, with_swaps=False)
    out = _port(fixture_dir, "mc3_quiet", settings)
    assert _files(out) == want_files
    assert sorted(p.name for p in (out / "hot_chains").iterdir()) == [
        "state_K1_0.chain1.pickle", "state_K1_0.chain2.pickle"]


def _carried_matches_recompute(root: Path, out: Path, chain_files):
    """Each pickle's log-likelihood and log-prior equal the recompute of its
    state."""
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.state import ChainState

    cfg = SBayesConfig.from_config_file(root / "config.yaml")
    model = Model(Data.from_config(cfg), cfg.model, device="cpu")
    for name in chain_files:
        with open(out / name, "rb") as f:
            d = pickle.load(f)
        ref = model.posterior.fill_state(ChainState.from_numpy(d))
        np.testing.assert_allclose(d["log_lh"], float(ref.log_lh[0]), rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(d["log_prior"], float(ref.log_prior[0]), rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("mc3", [False, True], ids=["single", "mc3"])
def test_partial_run_resumes_to_the_full_row_count(fixture_dir, mc3):
    """Half the steps at the same sample spacing, then ``-r`` with all of
    them: 20 rows with continuous sample ids, every rung of an MC3 ladder
    resumed from its own pickle, each pickle equal to its recompute."""
    half = {"steps": 200, "samples": 10, "warmup": {"warmup_steps": 20, "warmup_chains": 2}}
    full = {"steps": 400, "samples": 20}
    if mc3:
        half["mc3"] = MC3["mc3"]
    out = _port(fixture_dir, "resume", _settings(fixture_dir, half))
    assert len((out / "clusters_K1_0.txt").read_text().splitlines()) == 10
    _port(fixture_dir, "resume", _settings(fixture_dir, {**half, **full}), resume=True)
    stats = [out / "stats_K1_0.txt"] + ([out / "hot_chains" / f"stats_K1_0.chain{c}.txt"
                                         for c in (1, 2)] if mc3 else [])
    for path in stats:
        assert [int(r["Sample"]) for r in _rows(path)] == list(range(20, 401, 20)), path.name
        assert len(path.read_text().splitlines()) == 21                # one header
    assert len((out / "clusters_K1_0.txt").read_text().splitlines()) == 20
    pickles = ["state_K1_0.pickle"] + ([f"hot_chains/state_K1_0.chain{c}.pickle"
                                        for c in (1, 2)] if mc3 else [])
    for name in pickles:
        with open(out / name, "rb") as f:
            assert pickle.load(f)["i_step"] == 400
    _carried_matches_recompute(fixture_dir, out, pickles)


def test_resume_of_finished_run_is_noop(fixture_dir):
    """``-r`` on a run that reached its last step writes no row."""
    settings = _settings(fixture_dir, {"steps": 100, "samples": 5})
    out = _port(fixture_dir, "done", settings)
    before = {p: p.read_bytes() for p in (out / "stats_K1_0.txt", out / "clusters_K1_0.txt",
                                          out / "state_K1_0.pickle")}
    _port(fixture_dir, "done", settings, resume=True)
    for p, data in before.items():
        assert p.read_bytes() == data, p.name


def test_resume_from_the_results_files_imputes_a_valid_source(fixture_dir):
    """Without the pickle the run resumes from its clusters and stats files:
    the last sample's clusters and weights, a source drawn from the weights
    and one Gibbs pass (one component per observed cell, an available one,
    none at NA), the step after the last sample, every carried term filled;
    the CLI then appends the remaining rows from there."""
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.experiment import Experiment
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    half = _settings(fixture_dir, {"steps": 200, "samples": 10})
    out = _port(fixture_dir, "csv", half)
    (out / "state_K1_0.pickle").unlink()
    exp = Experiment(fixture_dir / "config.yaml", "csv", custom_settings=half, log=False)
    mcmc = MCMCSetup(Data.from_experiment(exp), exp, device="cpu")
    state, i_step = mcmc._resume_from_results(run=0)
    last = (out / "clusters_K1_0.txt").read_text().splitlines()[-1]
    assert i_step == 201
    assert "".join("1" if v else "0" for v in state.clusters[0, 0].tolist()) == last
    c = mcmc.model.consts
    src = state.source[0]
    hc = mcmc.runtime.post.has_components(state.clusters)[0]             # (N, C)
    assert torch.equal(src.sum(-1), (~c.na).long())
    assert not bool((src & ~hc[:, None, :]).any())
    ref = mcmc.runtime.refresh(state)
    assert torch.equal(state.cl_counts, ref.cl_counts) and bool(torch.isfinite(state.log_lh))
    _port(fixture_dir, "csv", _settings(fixture_dir, {"steps": 400, "samples": 20}), resume=True)
    ids = [int(r["Sample"]) for r in _rows(out / "stats_K1_0.txt")]
    # the JAX package resumes a pickle-less run at the last sample + 1
    assert ids == list(range(20, 201, 20)) + list(range(221, 402, 20))


def test_jax_cli_pickle_resumes_in_the_port(fixture_dir):
    """A run of the JAX CLI, resumed by the port's: the JAX pickle loads
    with its log-likelihood and log-prior within 1e-4 relative of the
    port's recompute, and the port appends the remaining samples to the
    JAX run's files."""
    from sbayes_tpu.cli import run_experiment
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.experiment import Experiment
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    # one warm-up chain of as many steps as a sample interval: one JAX program
    half = _settings(fixture_dir, {"steps": 40, "samples": 2,
                                   "warmup": {"warmup_steps": 20, "warmup_chains": 1}},
                     {"log_operator_step_times": False, "log_likelihood": False})
    run_experiment(config=fixture_dir / "config.yaml", experiment_name="from_jax",
                   custom_settings=half, resume=False, i_run=0)
    out = fixture_dir / "results" / "from_jax" / "K1"
    with open(out / "state_K1_0.pickle", "rb") as f:
        d = pickle.load(f)
    exp = Experiment(fixture_dir / "config.yaml", "from_jax", custom_settings=half, log=False)
    mcmc = MCMCSetup(Data.from_experiment(exp), exp, device="cpu")
    state, i_step = mcmc._load_state_pickle(out / "state_K1_0.pickle")
    assert i_step == d["i_step"] == 40
    np.testing.assert_allclose(float(state.log_lh[0]), d["log_lh"], rtol=1e-4)
    np.testing.assert_allclose(float(state.log_prior[0]), d["log_prior"], rtol=1e-4)
    np.testing.assert_array_equal(state.clusters[0].numpy(), d["clusters"])
    full = _settings(fixture_dir, {"steps": 80, "samples": 4},
                     {"log_operator_step_times": False, "log_likelihood": False})
    _port(fixture_dir, "from_jax", full, resume=True)
    assert [int(r["Sample"]) for r in _rows(out / "stats_K1_0.txt")] == [20, 40, 60, 80]


@pytest.mark.parametrize("probe", [True, False], ids=["probe", "no_probe"])
def test_step_time_column_holds_the_probe(fixture_dir, probe):
    """With ``log_operator_step_times`` (the default) every operator's
    STEP-TIME is its own probe time, in ms; without it every row holds the
    run's mean wall time per step."""
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.experiment import Experiment
    from sbayes_tpu_torch.sampling.runner import MCMCSetup

    settings = _settings(fixture_dir, {"steps": 100, "samples": 5},
                         {"log_operator_step_times": probe})
    exp = Experiment(fixture_dir / "config.yaml", "optimes", custom_settings=settings, log=False)
    mcmc = MCMCSetup(Data.from_experiment(exp), exp, device="cpu")
    mcmc.sample(run=0)
    lines = mcmc.get_results_file_path("operator_stats", 0).read_text().splitlines()
    assert lines[0].startswith("#") and ("probe estimate" in lines[0]) == probe
    i_col = lines[1].index("STEP-TIME")
    cells = {line.split()[0]: line[i_col:].split()[0] for line in lines[2:]}
    times = [c for c in cells.values() if c != "-"]
    assert times and all(float(t) > 0 for t in times)
    if probe:
        assert mcmc._op_step_times is not None and len(mcmc._op_step_times) == len(cells)
        for name, t in zip(mcmc.runtime.op_names, mcmc._op_step_times):
            assert cells[name] in ("-", f"{1000 * t:.2f}"), name
        assert len(set(times)) > 1
    else:
        assert mcmc._op_step_times is None and len(set(times)) == 1


RESUME_WITHOUT_PANDAS = r"""
import json, sys, warnings
from pathlib import Path
sys.modules["pandas"] = None
root = Path(sys.argv[1])
from sbayes_tpu_torch.cli import main
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    main(root / "config.yaml", experiment_name="csv", custom_settings=json.loads(sys.argv[2]),
         resume=True, device="cpu")
print(json.dumps(sorted(m for m in ("pandas",) if sys.modules.get(m) is not None)))
"""


def test_resume_from_the_results_files_without_pandas(fixture_dir):
    """The card's machine has no pandas: with the pickle deleted, ``-r``
    reads the clusters and stats files with pandas unimportable (a
    subprocess) and appends the remaining rows after the last sample, as
    ``test_resume_from_the_results_files_imputes_a_valid_source`` does with
    pandas."""
    import json
    import subprocess
    import sys

    out = _port(fixture_dir, "csv", _settings(fixture_dir, {"steps": 200, "samples": 10}))
    (out / "state_K1_0.pickle").unlink()
    full = _settings(fixture_dir, {"steps": 400, "samples": 20})
    proc = subprocess.run([sys.executable, "-c", RESUME_WITHOUT_PANDAS, str(fixture_dir),
                           json.dumps(full)], cwd=Path(__file__).parent.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    ids = [int(r["Sample"]) for r in _rows(out / "stats_K1_0.txt")]
    assert ids == list(range(20, 201, 20)) + list(range(221, 402, 20))
    assert (out / "state_K1_0.pickle").exists()
