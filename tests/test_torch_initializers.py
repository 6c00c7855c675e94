"""The initializer methods ``seed_points`` and ``random_growth`` of the port,
against the JAX initializer where the streams allow it.

* ``seed_points``: K distinct singletons per chain, every object a seed
  about equally often (chi-square p > 1e-3).
* ``random_growth``: disjoint clusters, each connected in the adjacency
  graph, of at most ``initial_size`` objects; the mean size of each cluster
  over 2000 draws equal to the JAX initializer's over 2000 draws (Welch z
  test, p > 1e-3), on data where growth often stops early.
* Both methods through the whole initializer (source draw, ML steps, best
  of attempts) and through ``cli.main`` on the fixture config."""
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import chisquare, norm

import jax
import torch

from test_torch_posterior_ops import _np

FIXTURES = Path(__file__).parent / "fixtures"
P_MIN = 1e-3
N_DRAWS = 2000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def init_pair(method, n_clusters=3, initial_size=10, n_objects=24):
    """Both packages' initializers for ``method`` on the same synthetic data
    (uniform geo prior, sizes in [2, 8])."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.sampling.initializer import Initializer as JaxInitializer
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.initializer import Initializer
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    kw = dict(n_objects=n_objects, n_features=8, n_states=3, n_families=2, seed=6)
    override = {"model": {"clusters": n_clusters, "prior": {
        "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 8}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=n_clusters).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=n_clusters).update(override)
    jm = JaxModel(jax_data(**kw), jcfg.model)
    m = Model(synthetic_data(**kw), cfg.model, device="cpu")
    args = dict(initial_size=initial_size, attempts=2, n_em_steps=5, method=method)
    return (JaxInitializer(JaxCond(jm.posterior), **args),
            Initializer(Conditionals(m.posterior), **args), m.consts)


def test_seed_points_are_distinct_singletons():
    _, init, c = init_pair("seed_points")
    clusters = _np(init.generate_initial_clusters(torch.Generator().manual_seed(0), N_DRAWS))
    assert clusters.shape == (N_DRAWS, c.K, c.N)
    assert (clusters.sum(-1) == 1).all()                       # one object per cluster
    assert (clusters.sum(1) <= 1).all()                        # ... each a different one
    seeds = clusters.any(1).sum(0)
    assert chisquare(seeds).pvalue > P_MIN


def _connected(members, adjacency):
    """Whether the objects ``members`` form one component of ``adjacency``."""
    idx = list(np.flatnonzero(members))
    seen, todo = {idx[0]}, [idx[0]]
    while todo:
        o = todo.pop()
        for nb in np.flatnonzero(adjacency[o] & members):
            if nb not in seen:
                seen.add(nb)
                todo.append(nb)
    return len(seen) == len(idx)


def test_random_growth_matches_the_jax_initializer():
    """K = 3 clusters of up to 10 objects on 24 objects: the last clusters
    run out of free neighbours. Each port draw is disjoint and connected;
    the mean size of each cluster agrees with the JAX initializer's."""
    jinit, init, c = init_pair("random_growth")
    clusters = _np(init.generate_initial_clusters(torch.Generator().manual_seed(1), N_DRAWS))
    adjacency = _np(c.adjacency)
    sizes = clusters.sum(-1)
    assert (clusters.sum(1) <= 1).all()
    assert sizes.min() >= 1 and sizes.max() <= 10
    for draw in clusters[:200]:
        for members in draw:
            assert _connected(members, adjacency)
    jclusters = np.asarray(jax.jit(jax.vmap(jinit.generate_clusters_random_growth))(
        jax.random.split(jax.random.PRNGKey(1), N_DRAWS)))
    jsizes = jclusters.sum(-1)
    assert (jsizes < 10).any(), "growth never stopped early: the check has no power"
    mean, jmean = sizes.mean(0), jsizes.mean(0)
    se = np.sqrt(sizes.var(0, ddof=1) / N_DRAWS + jsizes.var(0, ddof=1) / N_DRAWS)
    fixed = se == 0                                             # the first cluster: always full
    np.testing.assert_array_equal(mean[fixed], jmean[fixed])
    z = (mean - jmean)[~fixed] / se[~fixed]
    assert (2 * norm.sf(np.abs(z)) > P_MIN).all(), (mean, jmean)


@pytest.mark.parametrize("method", ["seed_points", "random_growth"])
def test_initializer_methods_give_valid_states(method):
    """The whole initializer: disjoint clusters within the size bounds after
    the ML steps, a source on available components only, and the best of
    the attempts by likelihood."""
    _, init, c = init_pair(method)
    states = init.generate_sample(torch.Generator().manual_seed(2), 16)
    cl = _np(states.clusters)
    sizes = cl.sum(-1)
    assert (cl.sum(1) <= 1).all()
    assert (sizes >= c.min_size).all() and (sizes <= c.max_size).all()
    src = _np(states.source)
    na = _np(c.na)
    assert (src[:, na].sum(-1) == 0).all() and (src[:, ~na].sum(-1) == 1).all()
    in_cluster = cl.any(1)
    assert not src[..., 0][~in_cluster].any()                  # component 0 needs a cluster
    lh = _np(init.cond.post.log_likelihood(states))
    assert np.isfinite(lh).all()


@pytest.mark.parametrize("method", ["seed_points", "random_growth"])
def test_cli_runs_with_the_initializer_method(tmp_path, method):
    """``initialization.method`` through ``cli.main`` on the fixture config
    at K = 2: the stats file has a row per sample and disjoint clusters."""
    from sbayes_tpu_torch.cli import main

    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    results = tmp_path / "results"
    settings = {"model": {"clusters": 2}, "results": {"path": str(results)},
                "mcmc": {"steps": 100, "samples": 5, "initialization": {"method": method}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(tmp_path / "config.yaml", experiment_name=method, custom_settings=settings,
             device="cpu")
    out = results / method / "K2"
    assert len((out / "stats_K2_0.txt").read_text().splitlines()) == 1 + 5
    for line in (out / "clusters_K2_0.txt").read_text().splitlines():
        a, b = line.split("\t")
        assert not any(x == y == "1" for x, y in zip(a, b))
