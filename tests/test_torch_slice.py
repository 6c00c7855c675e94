"""The PyTorch port's default sampling path as a whole, on the CPU: a
prior-stationarity check of the cluster operators, and the CLI end to end
on the fixture config against the files the JAX CLI writes for it."""
import shutil
import warnings
from math import comb
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import binomtest

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)
import torch

FIXTURES = Path(__file__).parent / "fixtures"
UNIFORM_GEO = {"model": {"prior": {"geo": {"type": "uniform"}}}}


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


def test_cluster_operators_preserve_the_prior(fixture_dir):
    """Sample from the prior with ONLY the cluster operators (naive,
    Gibbsish, wide): 1024 independent chains x 300 steps. Under the uniform
    size and geo priors every allowed cluster is equally likely, so each
    size k has probability C(N, k) / sum_k C(N, k) and each object is a member with probability sum_k C(N-1, k-1) / sum_k C(N, k)
    over sizes k in [min, max]; a wrong proposal ratio (log_q / log_q_back)
    would move the chains away from it. Binomial test per object at
    p > 0.005, as tests/test_operator_stationarity.py does."""
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators

    settings = {**UNIFORM_GEO, "mcmc": {
        "sample_from_prior": True, "operators": {"clusters": 1.0, "weights": 0.0, "source": 0.0}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(fixture_dir / "config.yaml", settings)
    model = Model(Data.from_config(cfg), cfg.model, device="cpu")
    rt = SamplerRuntime(model, cfg.mcmc, sample_from_prior=True)
    assert all(n.startswith(("cluster", "gibbsish")) for n in rt.op_names)
    gen, op_gen = make_generators(11, "cpu")
    n_chains = 1024
    states = rt.init_chains(gen, n_chains)
    states, stats = rt.run_chunk(gen, op_gen, states, rt.new_stats(n_chains), 300)
    assert int(stats.non_finite.sum()) == 0

    c = model.consts
    sizes = range(c.min_size, c.max_size + 1)
    p_ref = sum(comb(c.N - 1, k - 1) for k in sizes) / sum(comb(c.N, k) for k in sizes)
    member = states.clusters.any(dim=1).numpy()                       # (chains, N)
    failures = []
    for o in range(c.N):
        pv = binomtest(int(member[:, o].sum()), n_chains, p_ref).pvalue
        if pv <= 0.005:
            failures.append(f"object {o}: mcmc={member[:, o].mean():.3f} prior={p_ref:.3f}")
    # ... and each cluster size k with probability C(N, k) / sum_k C(N, k)
    # (the grow/shrink boundary corrections act on the sizes at min and max)
    size = states.clusters.sum(-1)[:, 0].numpy()
    norm = sum(comb(c.N, k) for k in sizes)
    for k in sizes:
        pv = binomtest(int((size == k).sum()), n_chains, comb(c.N, k) / norm).pvalue
        if pv <= 0.005:
            failures.append(f"size {k}: mcmc={(size == k).mean():.3f} "
                            f"prior={comb(c.N, k) / norm:.3f}")
    assert not failures, "cluster-operator stationarity violations:\n" + "\n".join(failures)


def _jax_expected(cfg_path, results):
    """File names the JAX CLI writes for this config and its stats header
    (built from the JAX package's own MCMCSetup and logger, no sampling)."""
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu.experiment import Experiment as JaxExperiment
    from sbayes_tpu.results.loggers import ParametersCSVLogger as JaxStats
    from sbayes_tpu.sampling.runner import MCMCSetup as JaxSetup

    settings = {**UNIFORM_GEO, "results": {"path": str(results)}}
    exp = JaxExperiment(cfg_path, "jax_e2e", custom_settings=settings, log=False)
    setup = JaxSetup(JaxData.from_experiment(exp), exp)
    loggers = setup.get_sample_loggers(0, resume=False)
    stats = next(lg for lg in loggers if isinstance(lg, JaxStats))
    stats.open()
    stats.write_header(None)
    stats.close()
    header = stats.path.read_text().splitlines()[0]
    return sorted(lg.path.name for lg in loggers), header


def test_cli_end_to_end_writes_the_jax_files(fixture_dir):
    """``python -m sbayes_tpu_torch config.yaml --device cpu`` on the fixture
    config (geo set to uniform through custom settings): the same results
    files, and the same stats header and columns, as the JAX CLI writes."""
    import pickle

    from sbayes_tpu_torch.cli import main
    from sbayes_tpu_torch.sampling.state import ChainState

    results = fixture_dir / "results"
    want_files, want_header = _jax_expected(fixture_dir / "config.yaml", results)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(fixture_dir / "config.yaml", experiment_name="e2e",
             custom_settings={**UNIFORM_GEO, "results": {"path": str(results)}}, device="cpu")
    out = results / "e2e" / "K1"
    assert sorted(p.name for p in out.iterdir()) == want_files
    lines = (out / "stats_K1_0.txt").read_text().splitlines()
    assert lines[0] == want_header
    assert len(lines) == 1 + 20                                     # one row per sample
    cols = lines[0].split("\t")
    for line in lines[1:]:
        row = dict(zip(cols, line.split("\t")))
        assert len(row) == len(cols) == len(line.split("\t"))
        assert np.isfinite(float(row["posterior"])) and np.isfinite(float(row["likelihood"]))
    assert int(lines[-1].split("\t")[0]) == 400                     # the Sample column
    clusters = (out / "clusters_K1_0.txt").read_text().splitlines()
    assert len(clusters) == 20 and all(set(r) <= {"0", "1"} for r in clusters)
    with open(out / "state_K1_0.pickle", "rb") as f:
        st = ChainState.from_numpy(pickle.load(f))
    assert st.clusters.shape == (1, 1, 5) and st.source.dtype == torch.bool
    ops = (out / "operator_stats_K1_0.txt").read_text()
    assert "gibbs_sample_weights" in ops and "cluster_gibbsish_geo" in ops
