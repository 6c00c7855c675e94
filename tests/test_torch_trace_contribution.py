"""The trace runner and the per-cluster contributions of the port.

* ``run_chunk(..., trace=True)``: each row of the trace is the carried
  ``log_lh + log_prior`` after that step (exactly: the same float32 add),
  and the states, statistics and generators end bit-equal to a chunk
  without the trace under the same seeds, at unit and at per-chain
  temperatures.
* ``SamplerRuntime.cluster_contribution`` against the JAX package's
  ``SamplerRuntime._cluster_contribution`` on the same numpy states, for
  K = 2 and 3, the uniform and the cost-based geo prior and every size-prior
  type (rtol 1e-4, atol 1e-3: float32 sums over N x F logs in another order).
* ``log_contribution_per_cluster: true`` through ``cli.main``: the JAX CLI's
  stats header, and ``post_a* = lh_a* + prior_a*`` in every row (rtol 1e-5,
  as tests/test_e2e.py checks the JAX package)."""
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU, see conftest)
import torch

from test_torch_posterior_ops import _np, numpy_state

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_k2():
    """The port's runtime of the fixture config at K = 2 (cost-based geo)
    and 12 initial chains."""
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(FIXTURES / "config.yaml", {"model": {"clusters": 2}})
    rt = SamplerRuntime(Model(Data.from_config(cfg), cfg.model, device="cpu"), cfg.mcmc)
    return rt, rt.init_chains(make_generators(1, "cpu")[0], 12)


@pytest.mark.parametrize("ladder", [False, True], ids=["unit", "per_chain"])
def test_trace_rows_are_the_log_posterior_of_each_step(fixture_k2, ladder):
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt, states = fixture_k2
    temps = torch.linspace(1.0, 2.0, states.n_chains) if ladder else None
    n_steps = 60
    gen, op_gen = make_generators(9, "cpu")
    got, stats, trace = rt.run_chunk(gen, op_gen, states, rt.new_stats(states.n_chains),
                                     n_steps, temps, temps, trace=True)
    assert trace.shape == (n_steps, states.n_chains) and trace.dtype == np.float32

    # The same chunk without the trace: bit-equal states, stats and streams.
    gen2, op_gen2 = make_generators(9, "cpu")
    want, stats2 = rt.run_chunk(gen2, op_gen2, states, rt.new_stats(states.n_chains), n_steps,
                                temps, temps)
    for name, a in got._asdict().items():
        b = getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    for a, b in zip(stats, stats2):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), gen2.get_state())
    assert torch.equal(op_gen.get_state(), op_gen2.get_state())

    # Step by step with the same draws: row i is the carried posterior after step i.
    gen3, op_gen3 = make_generators(9, "cpu")
    apply = rt.apply_fn(temps, temps)
    ops = torch.multinomial(rt.op_weights, n_steps, replacement=True, generator=op_gen3)
    st, rows = states, []
    for op_idx in ops.tolist():
        st = apply(op_idx, gen3, st)[0]
        rows.append(_np(st.log_lh + st.log_prior))
    np.testing.assert_array_equal(trace, np.stack(rows))
    np.testing.assert_array_equal(trace[-1], _np(got.log_lh + got.log_prior))
    assert len(np.unique(trace[:, 0])) > 1                       # the chains moved


def test_trace_feeds_the_ess_of_the_log_posterior(fixture_k2):
    """Two chunks of a trace window, concatenated: the multichain ESS of the
    log-posterior lies in (0, chains x steps] and split-R-hat is finite."""
    from sbayes_tpu_torch.results.ess import multichain_ess, split_rhat
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt, states = fixture_k2
    gen, op_gen = make_generators(5, "cpu")
    stats = rt.new_stats(states.n_chains)
    parts = []
    for _ in range(2):
        states, stats, tr = rt.run_chunk(gen, op_gen, states, stats, 50, trace=True)
        parts.append(tr)
    x = np.concatenate(parts).T                                   # (chains, steps)
    assert x.shape == (12, 100) and np.isfinite(x).all()
    assert 0 < multichain_ess(x) <= x.size
    assert np.isfinite(split_rhat(x))


def contribution_pair(n_clusters, geo, size_prior):
    """Both packages' models (24 objects x 8 features) for ``n_clusters``,
    the geo prior ``geo`` and the size prior ``size_prior``, and two numpy
    states: the JAX runtime and states, the port's runtime and batch."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.runner import SamplerRuntime as JaxRuntime
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.sampling.state import ChainState
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    kw = dict(n_objects=24, n_features=8, n_states=3, n_families=2, seed=6)
    geo_cfg = {"type": geo}
    if geo == "cost_based":
        geo_cfg.update({"rate": 2e5, "aggregation": "mean"})
    override = {"model": {"clusters": n_clusters, "prior": {
        "geo": geo_cfg, "weights": {"type": "jeffreys"},
        "objects_per_cluster": {"type": size_prior, "min": 2, "max": 8}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=n_clusters).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=n_clusters).update(override)
    jm = JaxModel(jax_data(**kw), jcfg.model)
    m = Model(synthetic_data(**kw), cfg.model, device="cpu")
    c = m.consts
    dicts = []
    for seed in (3, 8):
        d = numpy_state(c.K, c.N, c.F, c.C, _np(c.na), seed=seed, min_size=3)
        d["clusters"][:, 8:] &= np.cumsum(d["clusters"][:, 8:], axis=1) <= 2
        dicts.append(d)
    jrt = JaxRuntime(jm, jcfg.mcmc)
    rt = SamplerRuntime(m, cfg.mcmc)
    batch = rt.post.fill_state(ChainState.from_numpy({k: np.stack([d[k] for d in dicts])
                                                      for k in dicts[0]}))
    jstates = [jrt.model.posterior.fill_state(JaxState.from_numpy(d)) for d in dicts]
    return jrt, jstates, rt, batch


@pytest.mark.parametrize("n_clusters,geo,size_prior", [
    (2, "uniform", "uniform_area"), (2, "cost_based", "uniform_size"),
    (2, "uniform", "quadratic"), (3, "cost_based", "uniform_area"),
    (3, "uniform", "uniform_size"), (3, "cost_based", "quadratic")])
def test_cluster_contribution_matches_jax(n_clusters, geo, size_prior):
    jrt, jstates, rt, batch = contribution_pair(n_clusters, geo, size_prior)
    lh, prior = (_np(x) for x in rt.cluster_contribution(batch))
    assert lh.shape == prior.shape == (2, n_clusters)
    for b, js in enumerate(jstates):
        want_lh, want_prior = (np.asarray(x) for x in jrt._cluster_contribution(js))
        np.testing.assert_allclose(lh[b], want_lh, rtol=1e-4, atol=1e-3, err_msg=f"lh {b}")
        np.testing.assert_allclose(prior[b], want_prior, rtol=1e-4, atol=1e-3,
                                   err_msg=f"prior {b}")
    assert (lh < 0).all() and np.isfinite(prior).all()
    if geo == "uniform" and size_prior == "uniform_area":
        # only the weights prior remains, the same for every cluster
        np.testing.assert_allclose(prior, np.repeat(prior[:, :1], n_clusters, 1), rtol=1e-6)


def test_make_record_fills_the_contribution(fixture_k2):
    rt, states = fixture_k2
    one = states.select(slice(0, 1))
    record = rt.make_record(one, i_step=3, with_cluster_contribution=True)
    lh, prior = rt.cluster_contribution(one)
    np.testing.assert_array_equal(record.cluster_contribution_lh, _np(lh)[0])
    np.testing.assert_array_equal(record.cluster_contribution_prior, _np(prior)[0])
    plain = rt.make_record(one, i_step=3)
    assert plain.cluster_contribution_lh is None and plain.cluster_contribution_prior is None


def test_cli_logs_the_contribution_per_cluster(tmp_path):
    """``log_contribution_per_cluster: true`` at K = 2 through ``cli.main``:
    the stats header of the JAX CLI for the same config, and in every row
    ``post_a* = lh_a* + prior_a*`` with a finite, negative ``lh_a*``."""
    import shutil

    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu.experiment import Experiment as JaxExperiment
    from sbayes_tpu.results.loggers import ParametersCSVLogger as JaxStats
    from sbayes_tpu.sampling.runner import MCMCSetup as JaxSetup
    from sbayes_tpu_torch.cli import main

    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    results = tmp_path / "results"
    settings = {"model": {"clusters": 2}, "results": {"path": str(results),
                                                      "log_contribution_per_cluster": True},
                "mcmc": {"steps": 100, "samples": 5}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exp = JaxExperiment(tmp_path / "config.yaml", "jax_contrib", custom_settings=settings,
                            log=False)
        stats = next(lg for lg in JaxSetup(JaxData.from_experiment(exp), exp)
                     .get_sample_loggers(0, resume=False) if isinstance(lg, JaxStats))
        stats.open()
        stats.write_header(None)
        stats.close()
        main(tmp_path / "config.yaml", experiment_name="contrib", custom_settings=settings,
             device="cpu")
    lines = (results / "contrib" / "K2" / "stats_K2_0.txt").read_text().splitlines()
    header = lines[0].split("\t")
    assert lines[0] == stats.path.read_text().splitlines()[0]
    for col in ("post_a0", "lh_a0", "prior_a0", "post_a1", "lh_a1", "prior_a1"):
        assert col in header, f"missing column {col}"
    assert header.index("prior_a1") < header.index("cluster_size_prior")
    assert len(lines) == 1 + 5
    for line in lines[1:]:
        row = dict(zip(header, line.split("\t")))
        for i in (0, 1):
            lh_i, pr_i, po_i = (float(row[f"{k}_a{i}"]) for k in ("lh", "prior", "post"))
            assert np.isfinite(lh_i) and np.isfinite(pr_i) and lh_i < 0
            np.testing.assert_allclose(po_i, lh_i + pr_i, rtol=1e-5, atol=1e-4)
