"""The PyTorch port's default sampling path as a whole, on the CPU:
prior-stationarity checks of the cluster operators (K = 1, and K = 2 with
the jump in the schedule), and the CLI end to end on the unchanged fixture
config (cost-based geo prior) against the files the JAX CLI writes for it,
at K = 1 and at K = 2."""
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


def test_cluster_operators_with_the_jump_preserve_the_prior(fixture_dir):
    """K = 2 under the prior with ONLY the cluster operators, the jump among
    them (a quarter of the steps): 1024 independent chains x 400 steps on the
    fixture's 5 objects. Every pair of disjoint clusters with sizes in
    [min, max] is equally likely, so the sizes (k1, k2) have probability
    N! / (k1! k2! (N - k1 - k2)!) over the number of allowed pairs; a wrong
    jump ratio (log_q / log_q_back, the reject mask) would move the chains
    away from it. Binomial test per size pair at p > 0.005."""
    from math import factorial

    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators

    settings = {"model": {"clusters": 2, "prior": {
        "geo": {"type": "uniform"},
        "objects_per_cluster": {"type": "uniform_area", "min": 1, "max": 3}}},
        "mcmc": {"sample_from_prior": True,
                 "operators": {"clusters": 1.0, "weights": 0.0, "source": 0.0}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(fixture_dir / "config.yaml", settings)
    model = Model(Data.from_config(cfg), cfg.model, device="cpu")
    rt = SamplerRuntime(model, cfg.mcmc, sample_from_prior=True)
    jump = rt.op_names.index("cluster_jump_gibbsish")
    assert float(rt.op_weights[jump]) == pytest.approx(0.25)
    gen, op_gen = make_generators(5, "cpu")
    n_chains = 1024
    states = rt.init_chains(gen, n_chains)
    states, stats = rt.run_chunk(gen, op_gen, states, rt.new_stats(n_chains), 400)
    assert int(stats.non_finite.sum()) == 0
    accepted = int(stats.accepts[:, jump].sum())
    assert 0 < accepted < int((stats.accepts + stats.rejects)[:, jump].sum())

    c = model.consts
    assert int((states.clusters.sum(1) > 1).sum()) == 0            # no object in two clusters
    sizes = states.clusters.sum(-1).numpy()                          # (chains, 2)
    allowed = [(a, b) for a in range(c.min_size, c.max_size + 1)
               for b in range(c.min_size, c.max_size + 1) if a + b <= c.N]
    assert {tuple(r) for r in sizes.tolist()} <= set(allowed)
    ways = {ab: factorial(c.N) // (factorial(ab[0]) * factorial(ab[1])
                                   * factorial(c.N - sum(ab))) for ab in allowed}
    norm = sum(ways.values())
    failures = []
    for ab in allowed:
        n_ab = int(((sizes[:, 0] == ab[0]) & (sizes[:, 1] == ab[1])).sum())
        if binomtest(n_ab, n_chains, ways[ab] / norm).pvalue <= 0.005:
            failures.append(f"sizes {ab}: mcmc={n_ab / n_chains:.3f} prior={ways[ab] / norm:.3f}")
    assert not failures, "stationarity violations with the jump:\n" + "\n".join(failures)


def _jax_expected(cfg_path, results, n_clusters=1):
    """File names the JAX CLI writes for this config and its stats header
    (built from the JAX package's own MCMCSetup and logger, no sampling)."""
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu.experiment import Experiment as JaxExperiment
    from sbayes_tpu.results.loggers import ParametersCSVLogger as JaxStats
    from sbayes_tpu.sampling.runner import MCMCSetup as JaxSetup

    settings = {"model": {"clusters": n_clusters}, "results": {"path": str(results)}}
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
    config as it is (cost-based geo prior, aggregation sum): the same
    results files, and the same stats header and columns, as the JAX CLI
    writes; the geo prior column holds the real prior."""
    import pickle

    from sbayes_tpu_torch.cli import main
    from sbayes_tpu_torch.sampling.state import ChainState

    results = fixture_dir / "results"
    want_files, want_header = _jax_expected(fixture_dir / "config.yaml", results)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(fixture_dir / "config.yaml", experiment_name="e2e",
             custom_settings={"results": {"path": str(results)}}, device="cpu")
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
        assert float(row["geo_prior"]) <= 0.0
    geo = [float(dict(zip(cols, line.split("\t")))["geo_prior"]) for line in lines[1:]]
    assert min(geo) < 0.0                                           # not the uniform prior's 0
    assert int(lines[-1].split("\t")[0]) == 400                     # the Sample column
    clusters = (out / "clusters_K1_0.txt").read_text().splitlines()
    assert len(clusters) == 20 and all(set(r) <= {"0", "1"} for r in clusters)
    with open(out / "state_K1_0.pickle", "rb") as f:
        st = ChainState.from_numpy(pickle.load(f))
    assert st.clusters.shape == (1, 1, 5) and st.source.dtype == torch.bool
    ops = (out / "operator_stats_K1_0.txt").read_text()
    assert "gibbs_sample_weights" in ops and "cluster_gibbsish_geo" in ops


def test_cli_k2_writes_the_jax_files(fixture_dir):
    """The fixture config at K = 2 (``-K 2``): results under ``K2/``, the
    JAX CLI's file names and stats header (two cluster sizes), two cluster
    columns per sample, a geo prior that is not all zero, and the jump in
    the operator statistics."""
    from sbayes_tpu_torch.cli import main

    results = fixture_dir / "results"
    want_files, want_header = _jax_expected(fixture_dir / "config.yaml", results, n_clusters=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(fixture_dir / "config.yaml", experiment_name="k2", n_clusters=[2],
             custom_settings={"results": {"path": str(results)}}, device="cpu")
    out = results / "k2" / "K2"
    assert sorted(p.name for p in out.iterdir()) == want_files
    lines = (out / "stats_K2_0.txt").read_text().splitlines()
    assert lines[0] == want_header and len(lines) == 1 + 20
    cols = lines[0].split("\t")
    assert "size_a0" in cols and "size_a1" in cols
    rows = [dict(zip(cols, line.split("\t"))) for line in lines[1:]]
    assert all(np.isfinite(float(r["posterior"])) for r in rows)
    assert min(float(r["geo_prior"]) for r in rows) < 0.0
    clusters = (out / "clusters_K2_0.txt").read_text().splitlines()
    assert len(clusters) == 20
    for line in clusters:
        a, b = line.split("\t")
        assert set(a + b) <= {"0", "1"} and len(a) == len(b) == 5
        assert not any(x == y == "1" for x, y in zip(a, b))          # disjoint clusters
    assert "cluster_jump_gibbsish" in (out / "operator_stats_K2_0.txt").read_text()
