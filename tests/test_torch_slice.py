"""The PyTorch port's default sampling path as a whole, on the CPU:
prior-stationarity checks of the cluster operators (K = 1, and K = 2 with
the jump in the schedule, both against the JAX sampler's sizes; the jump
alone against the prior), and the CLI end to end on the unchanged fixture
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


def _op_sequence(rt, n_steps: int, seed: int) -> np.ndarray:
    """One operator draw per step, shared by every chain, as both packages'
    ensemble runners share it: each operator keeps its own size distribution
    (ROADMAP C.1, C.8), so the sizes after a run depend on its last draws,
    and the two packages are compared on the same draws."""
    w = rt.op_weights.numpy()
    return np.random.default_rng(seed).choice(len(w), size=n_steps, p=w / w.sum())


def _port_run(rt, seq, n_chains: int, seed: int):
    """The port's MH step on ``n_chains`` chains from its own initial states,
    the operator of each step from ``seq``: (states, stats)."""
    from sbayes_tpu_torch.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu_torch.sampling.runner import make_generators

    gen, _ = make_generators(seed, "cpu")
    states = rt.init_chains(gen, n_chains)
    stats = rt.new_stats(n_chains)
    apply = make_mh_apply_fn(rt.cond, rt._op_specs)
    for i in seq.tolist():
        states, accept, step_size, nf = apply(i, gen, states)
        stats = stats.record(i, accept, step_size, nf)
    return states, stats


def _jax_clusters(fixture_dir, settings, n_chains: int, seq, seed: int):
    """(n_chains, K, N) cluster memberships after the JAX package's MH step on the
    same config, from its own initial states, the operator of each step
    from ``seq`` (the port's names and weights, asserted equal)."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.model.posterior import Posterior as JaxPosterior
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxConditionals
    from sbayes_tpu.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu.sampling.operators import get_operator_schedule
    from sbayes_tpu.sampling.runner import SamplerRuntime as JaxRuntime

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = JaxConfig.from_config_file(fixture_dir / "config.yaml", custom_settings=settings)
    rt = JaxRuntime(JaxModel(JaxData.from_config(cfg), cfg.model), cfg.mcmc,
                    sample_from_prior=True)
    cond = JaxConditionals(JaxPosterior(rt.consts, True), 1.0, 1.0)
    specs = get_operator_schedule(cond, cfg.mcmc.operators)
    apply = jax.jit(jax.vmap(make_mh_apply_fn(cond, specs), in_axes=(None, 0, 0)))
    states = rt.init_chains(jax.random.PRNGKey(seed), n_chains, shard=False)
    key = jax.random.PRNGKey(seed + 1)
    for i in seq.tolist():
        key, k = jax.random.split(key)
        states = apply(i, jax.random.split(k, n_chains), states)[0]
    return [s.name for s in specs], [s.weight for s in specs], np.asarray(states.clusters)


def _same_schedule(rt, names, weights):
    assert names == rt.op_names
    np.testing.assert_allclose(weights, rt.op_weights.numpy(), rtol=1e-6)


def test_cluster_operators_preserve_the_prior(fixture_dir):
    """Sample from the prior with ONLY the cluster operators (naive,
    Gibbsish, wide): 1024 independent chains x 300 steps. Under the uniform
    size and geo priors every allowed cluster is equally likely, so each
    object would be a member with probability sum_k C(N-1, k-1) / sum_k
    C(N, k) over sizes k in [min, max] (16/31 here). The grow/shrink rule of
    the JAX package samples the bound sizes at half the prior's probability
    (ROADMAP C.1), which raises it to about 0.536, so each object's
    membership and the size histogram are held against the JAX sampler's on
    the same setup (1024 chains x 300 steps, the same operator draws) by
    chi-square two-sample tests at p > 0.005; a wrong proposal ratio
    (log_q / log_q_back) would move the port's chains away from them."""
    from scipy.stats import chi2_contingency

    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime

    settings = {**UNIFORM_GEO, "mcmc": {
        "sample_from_prior": True, "operators": {"clusters": 1.0, "weights": 0.0, "source": 0.0}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(fixture_dir / "config.yaml", settings)
    model = Model(Data.from_config(cfg), cfg.model, device="cpu")
    rt = SamplerRuntime(model, cfg.mcmc, sample_from_prior=True)
    assert all(n.startswith(("cluster", "gibbsish")) for n in rt.op_names)
    n_chains = 1024
    seq = _op_sequence(rt, 300, seed=11)
    states, stats = _port_run(rt, seq, n_chains, seed=11)
    assert int(stats.non_finite.sum()) == 0

    c = model.consts
    names, weights, cl_jax = _jax_clusters(fixture_dir, settings, n_chains, seq, seed=11)
    _same_schedule(rt, names, weights)
    member = states.clusters.any(dim=1).numpy()                       # (chains, N)
    member_jax = cl_jax.any(1)
    failures = []
    for o in range(c.N):
        table = np.array([[member[:, o].sum(), n_chains - member[:, o].sum()],
                          [member_jax[:, o].sum(), n_chains - member_jax[:, o].sum()]])
        pv = chi2_contingency(table).pvalue
        if pv <= 0.005:
            failures.append(f"object {o}: port={member[:, o].mean():.3f} "
                            f"JAX={member_jax[:, o].mean():.3f}, p={pv:.4f}")
    # ... and the cluster sizes
    sizes = range(c.min_size, c.max_size + 1)
    size = states.clusters.sum(-1)[:, 0].numpy()
    size_jax = cl_jax.sum(-1)[:, 0]
    table = np.array([[(size == k).sum() for k in sizes], [(size_jax == k).sum() for k in sizes]])
    table = table[:, table.sum(0) > 0]
    pv = chi2_contingency(table).pvalue
    if pv <= 0.005:
        failures.append(f"sizes {list(sizes)}: port {table[0].tolist()}, "
                        f"JAX {table[1].tolist()}, p={pv:.4f}")
    assert not failures, "cluster-operator stationarity violations:\n" + "\n".join(failures)


K2_SETTINGS = {"model": {"clusters": 2, "prior": {
    "geo": {"type": "uniform"},
    "objects_per_cluster": {"type": "uniform_area", "min": 1, "max": 3}}},
    "mcmc": {"sample_from_prior": True,
             "operators": {"clusters": 1.0, "weights": 0.0, "source": 0.0}}}


def _k2_runtime(fixture_dir):
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(fixture_dir / "config.yaml", K2_SETTINGS)
    model = Model(Data.from_config(cfg), cfg.model, device="cpu")
    return SamplerRuntime(model, cfg.mcmc, sample_from_prior=True)


def _allowed_pairs(c):
    return [(a, b) for a in range(c.min_size, c.max_size + 1)
            for b in range(c.min_size, c.max_size + 1) if a + b <= c.N]


def test_cluster_operators_with_the_jump_preserve_the_prior(fixture_dir):
    """K = 2 under the prior with ONLY the cluster operators (naive,
    Gibbsish, wide), the jump among them (a quarter of the steps): 1024
    independent chains x 400 steps on the fixture's 5 objects. The clusters
    stay disjoint with sizes in [min, max], and the sizes (k1, k2) follow
    the JAX sampler's on the same setup (1024 chains x 400 steps): the
    grow/shrink rule of the JAX package samples the bound sizes at half the
    prior's probability (ROADMAP C.1) and the wide resample over-weights
    full unions (ROADMAP C.8), so the prior's N! / (k1! k2! (N - k1 - k2)!)
    is not the reference. Both packages run the same operator draws. A wrong
    proposal ratio of any operator, the jump's included, would move the
    port's histogram away from JAX's. Chi-square two-sample test of the
    (k1, k2) histograms at p > 0.005."""
    from scipy.stats import chi2_contingency

    rt = _k2_runtime(fixture_dir)
    jump = rt.op_names.index("cluster_jump_gibbsish")
    assert float(rt.op_weights[jump]) == pytest.approx(0.25)
    assert all(n.startswith(("cluster", "gibbsish")) for n in rt.op_names)
    n_chains = 1024
    seq = _op_sequence(rt, 400, seed=5)
    states, stats = _port_run(rt, seq, n_chains, seed=5)
    assert int(stats.non_finite.sum()) == 0
    accepted = int(stats.accepts[:, jump].sum())
    assert 0 < accepted < int((stats.accepts + stats.rejects)[:, jump].sum())

    c = rt.model.consts
    assert int((states.clusters.sum(1) > 1).sum()) == 0            # no object in two clusters
    sizes = states.clusters.sum(-1).numpy()                          # (chains, 2)
    allowed = _allowed_pairs(c)
    assert {tuple(r) for r in sizes.tolist()} <= set(allowed)
    names, weights, cl_jax = _jax_clusters(fixture_dir, K2_SETTINGS, n_chains, seq, seed=5)
    _same_schedule(rt, names, weights)
    sizes_jax = cl_jax.sum(-1)
    assert {tuple(r) for r in sizes_jax.tolist()} <= set(allowed)
    table = np.array([[int(((x[:, 0] == a) & (x[:, 1] == b)).sum()) for a, b in allowed]
                      for x in (sizes, sizes_jax)])
    table = table[:, table.sum(0) > 0]
    assert table.shape[1] >= 4
    pv = chi2_contingency(table).pvalue
    assert pv > 0.005, (f"size pairs {allowed}: port {table[0].tolist()}, "
                        f"JAX {table[1].tolist()}, p={pv:.4f}")


def test_the_jump_alone_preserves_the_prior(fixture_dir):
    """K = 2 under the prior, the jump alone: 1024 independent chains x 400
    steps on the fixture's 5 objects. The jump moves one object from one
    cluster to the other, so each chain keeps the union of its clusters;
    under the prior every split of that union into two clusters with sizes
    in [min, max] is equally likely, so given the union's size T the sizes
    (k, T - k) have probability C(T, k) over the allowed splits. A wrong
    jump ratio (log_q / log_q_back, the reject mask) would move the chains
    away from it. Binomial test per size pair at p > 0.005. (This holds the
    jump against the prior itself, which the run of all cluster operators
    above cannot: the operators that change the union do not keep the prior
    in either package, ROADMAP C.1 and C.8.)"""
    from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = _k2_runtime(fixture_dir)
    spec = OperatorSpec("cluster_jump_gibbsish", 1.0,
                        OperatorFactory(rt.cond).make_cluster_jump(), "clusters")
    apply = make_mh_apply_fn(rt.cond, [spec])
    gen, _ = make_generators(5, "cpu")
    n_chains = 1024
    states = rt.init_chains(gen, n_chains)
    union = states.clusters.any(1)
    stats = OperatorStats.zeros(n_chains, 1, "cpu")
    for _ in range(400):
        states, accept, step_size, nf = apply(0, gen, states)
        stats = stats.record(0, accept, step_size, nf)
    assert int(stats.non_finite.sum()) == 0
    accepted = int(stats.accepts.sum())
    assert 0 < accepted < int((stats.accepts + stats.rejects).sum())

    c = rt.model.consts
    assert int((states.clusters.sum(1) > 1).sum()) == 0            # no object in two clusters
    assert torch.equal(states.clusters.any(1), union)               # the jump keeps the union
    sizes = states.clusters.sum(-1).numpy()                          # (chains, 2)
    total = sizes.sum(-1)
    allowed = _allowed_pairs(c)
    assert {tuple(r) for r in sizes.tolist()} <= set(allowed)
    failures, tested = [], 0
    for t in np.unique(total):
        splits = [ab for ab in allowed if sum(ab) == t]
        n_t = int((total == t).sum())
        if len(splits) < 2 or n_t < 50:
            continue
        norm = sum(comb(int(t), a) for a, _ in splits)
        for a, b in splits:
            n_ab = int(((sizes[:, 0] == a) & (sizes[:, 1] == b)).sum())
            tested += 1
            if binomtest(n_ab, n_t, comb(int(t), a) / norm).pvalue <= 0.005:
                failures.append(f"sizes {(a, b)} of {n_t} chains with union {t}: "
                                f"mcmc={n_ab / n_t:.3f} prior={comb(int(t), a) / norm:.3f}")
    assert tested >= 4, f"only {tested} size pairs had enough chains to test"
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
