"""The port's geo prior against the JAX package on one numpy state carried
into both (K = 3): the skeleton aggregates, the prior per cluster (from the
clusters and from carried aggregates), the per-object proposal costs, for
every aggregation and both probability functions; the carried aggregates
after a chunk of sampling steps; the geo term of the initializer's EM.

Tolerance: 1e-5 relative (float32 sums of edge costs in another order,
through an exponential or a log-sigmoid)."""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_posterior_ops import _np, numpy_state

KW = dict(n_objects=30, n_features=8, n_states=3, n_families=2, seed=3)
K = 3
RTOL = 1e-5
AGGREGATIONS = ["mean", "sum", "max"]
FUNCTIONS = ["exponential", "sigmoid"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geo_settings(aggregation="mean", function="exponential", skeleton="mst",
                  prior_type="cost_based"):
    geo = {"type": prior_type}
    if prior_type == "cost_based":
        geo.update({"aggregation": aggregation, "probability_function": function,
                    "skeleton": skeleton, "rate": 3e5, "inflection_point": 4e5})
    return {"model": {"clusters": K, "prior": {"geo": geo}}}


_PAIRS = {}


def geo_pair(**kw):
    """Both packages' posterior, conditionals and filled state of one numpy
    state for a geo-prior setting (cached per setting)."""
    key = tuple(sorted(kw.items()))
    if key in _PAIRS:
        return _PAIRS[key]
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.state import ChainState
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    override = _geo_settings(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=K).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=K).update(override)
    jm = JaxModel(jax_data(**KW), jcfg.model)
    m = Model(synthetic_data(**KW), cfg.model, device="cpu")
    c = m.consts
    d = numpy_state(c.K, c.N, c.F, c.C, c.na.numpy(), seed=4)
    jcond, cond = JaxCond(jm.posterior), Conditionals(m.posterior)
    jstate = jcond.post.fill_state(JaxState.from_numpy(d))
    state = cond.post.fill_state(ChainState.from_numpy(d))
    _PAIRS[key] = dict(jm=jm, m=m, jcfg=jcfg, cfg=cfg, jcond=jcond, cond=cond, jstate=jstate,
                       state=state, d=d)
    return _PAIRS[key]


def test_constants_carry_the_cost_matrix():
    p = geo_pair()
    np.testing.assert_array_equal(_np(p["m"].consts.cost_matrix),
                                  np.asarray(p["jm"].consts.cost_matrix))
    assert p["m"].consts.geo == p["m"].consts.geo.__class__(
        **{f: getattr(p["jm"].consts.geo, f) for f in p["m"].consts.geo.__dataclass_fields__})


@pytest.mark.parametrize("skeleton", ["mst", "complete_graph", "delaunay"])
def test_geo_agg_of_matches_jax(skeleton):
    p = geo_pair(skeleton=skeleton)
    got = p["cond"].post.geo_agg_of(p["state"].clusters)
    assert got.shape == (1, K, 3)
    want = p["jcond"].post.geo_agg_of(p["jstate"].clusters)
    np.testing.assert_allclose(_np(got)[0], _np(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(p["state"].geo_agg)[0], _np(p["jstate"].geo_agg), rtol=RTOL,
                               atol=1e-6)


def test_diameter_skeleton_refuses():
    """Both packages refuse the diameter skeleton when a state is filled."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    with pytest.raises(NotImplementedError):
        geo_pair(skeleton="diameter")                       # the JAX package, first
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = synthetic_config(n_clusters=K, geo_prior="cost_based", skeleton="diameter")
    post = Model(synthetic_data(**KW), cfg.model, device="cpu").posterior
    with pytest.raises(NotImplementedError):
        post.geo_prior_per_cluster(torch.zeros((1, K, KW["n_objects"]), dtype=torch.bool))


@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_geo_prior_per_cluster_matches_jax(aggregation, function):
    p = geo_pair(aggregation=aggregation, function=function)
    got = p["cond"].post.geo_prior_per_cluster(p["state"].clusters)
    want = p["jcond"].post.geo_prior_per_cluster(p["jstate"].clusters)
    assert got.shape == (1, K) and np.all(_np(got) < 0)
    np.testing.assert_allclose(_np(got)[0], _np(want), rtol=RTOL, atol=1e-6)
    # ... and the filled state's geo part is their sum
    from sbayes_tpu_torch.sampling.state import PRIOR_GEO

    np.testing.assert_allclose(float(p["state"].prior_parts[0, PRIOR_GEO]),
                               float(p["jstate"].prior_parts[PRIOR_GEO]), rtol=RTOL)


@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_geo_prior_from_agg_matches_jax(aggregation, function):
    """From the aggregates the OTHER package carried (the converted state)."""
    p = geo_pair(aggregation=aggregation, function=function)
    agg = torch.tensor(_np(p["jstate"].geo_agg))[None]
    got = p["cond"].post.geo_prior_from_agg(p["state"].clusters, agg)
    want = p["jcond"].post.geo_prior_from_agg(p["jstate"].clusters, p["jstate"].geo_agg)
    np.testing.assert_allclose(_np(got)[0], _np(want), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_geo_prior_costs_per_object_match_jax(aggregation, function, carried):
    p = geo_pair(aggregation=aggregation, function=function)
    js, s = p["jstate"], p["state"]
    for i_cluster in range(K):
        want = p["jcond"].post.geo_prior_costs_per_object(
            js.clusters, i_cluster, geo_agg=js.geo_agg if carried else None)
        got = p["cond"].post.geo_prior_costs_per_object(
            s.clusters, torch.tensor([i_cluster]), geo_agg=s.geo_agg if carried else None)
        assert got.shape == (1, p["m"].consts.N)
        np.testing.assert_allclose(_np(got)[0], _np(want), rtol=RTOL, atol=1e-6)


def test_simulated_geo_prior_matches_jax():
    p = geo_pair(prior_type="simulated")
    assert p["m"].consts.geo.mean_edge_length == pytest.approx(
        p["jm"].consts.geo.mean_edge_length, rel=1e-6)
    got = p["cond"].post.geo_prior_per_cluster(p["state"].clusters)
    want = p["jcond"].post.geo_prior_per_cluster(p["jstate"].clusters)
    np.testing.assert_allclose(_np(got)[0], _np(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(p["state"].geo_agg)[0], _np(p["jstate"].geo_agg), rtol=RTOL,
                               atol=1e-7)


def test_uniform_geo_carries_nothing():
    p = geo_pair(prior_type="uniform")
    assert p["state"].geo_agg is None and p["jstate"].geo_agg is None
    assert not p["cond"].post.carry_geo
    assert float(p["cond"].post.geo_prior_per_cluster(p["state"].clusters).abs().sum()) == 0.0


def test_geo_agg_round_trips_between_the_packages():
    """A state converted from the JAX package keeps its aggregates, and the
    port's checkpoint dict gives them back to it."""
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu_torch.sampling.state import ChainState

    p = geo_pair()
    from_jax = ChainState.from_numpy(p["jstate"].to_numpy())
    assert from_jax.geo_agg.shape == (1, K, 3)
    np.testing.assert_array_equal(_np(from_jax.geo_agg)[0], _np(p["jstate"].geo_agg))
    back = JaxState.from_numpy(p["state"].to_numpy(chain=0))
    np.testing.assert_array_equal(_np(back.geo_agg), _np(p["state"].geo_agg)[0])
    # select and where keep the field
    two = ChainState.from_numpy({k: np.stack([v, v]) if isinstance(v, np.ndarray)
                                 else np.asarray([v, v])
                                 for k, v in p["state"].to_numpy(chain=0).items()})
    bumped = two._replace(geo_agg=two.geo_agg + 1)
    merged = bumped.where(torch.tensor([True, False]), two)
    np.testing.assert_array_equal(_np(merged.geo_agg[0]), _np(two.geo_agg[0]) + 1)
    np.testing.assert_array_equal(_np(merged.geo_agg[1]), _np(two.geo_agg[1]))
    assert merged.select(slice(1, 2)).geo_agg.shape == (1, K, 3)


@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_geo_agg_invariant_after_chunk(aggregation):
    """After 150 steps of the ten-operator schedule on 8 chains the carried
    aggregates equal a recompute from the clusters, the carried geo part of
    the prior equals the full recompute, and no object is in two clusters."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators
    from sbayes_tpu_torch.sampling.state import PRIOR_GEO
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = synthetic_config(n_clusters=K, geo_prior="cost_based", rate=1e5,
                               aggregation=aggregation)
    rt = SamplerRuntime(Model(synthetic_data(**KW), cfg.model, device="cpu"), cfg.mcmc)
    assert "cluster_jump_gibbsish" in rt.op_names and rt.n_ops == 10
    gen, op_gen = make_generators(1, "cpu")
    n_chains = 8
    states = rt.init_chains(gen, n_chains)
    assert states.geo_agg.shape == (n_chains, K, 3)
    states, stats = rt.run_chunk(gen, op_gen, states, rt.new_stats(n_chains), 150)
    assert int(stats.non_finite.sum()) == 0
    post = rt.post
    np.testing.assert_allclose(_np(states.geo_agg), _np(post.geo_agg_of(states.clusters)),
                               rtol=1e-6, atol=1e-6)
    oracle = post.geo_prior_per_cluster(states.clusters).sum(-1)
    np.testing.assert_allclose(_np(post.geo_prior_from_agg(states.clusters,
                                                           states.geo_agg).sum(-1)),
                               _np(oracle), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(states.prior_parts[:, PRIOR_GEO]), _np(oracle), rtol=1e-4,
                               atol=1e-4)
    assert int((states.clusters.sum(1) > 1).sum()) == 0
    jump = rt.op_names.index("cluster_jump_gibbsish")
    assert int(stats.accepts[:, jump].sum()) > 0


def test_geo_weighted_proposal_matches_jax():
    """The Gibbsish membership probabilities with the geo term
    (``consider_geo``), from the carried aggregates."""
    from sbayes_tpu.sampling.operators import OperatorFactory as JaxFactory
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    p = geo_pair(aggregation="sum")
    js, s = p["jstate"], p["state"]
    avail = ~jnp.asarray(js.clusters).any(0)
    for geo_scaler in (1.0, 2.0):
        want = JaxFactory(p["jcond"])._cluster_posterior(js, 1, avail, consider_geo=True,
                                                        geo_scaler=geo_scaler)
        got = OperatorFactory(p["cond"])._cluster_posterior(
            s, torch.tensor([1]), consider_geo=True, geo_scaler=geo_scaler)
        without = OperatorFactory(p["cond"])._cluster_posterior(s, torch.tensor([1]))
        np.testing.assert_allclose(_np(got)[0], _np(want), rtol=1e-4, atol=1e-7)
        assert float((got - without).abs().max()) > 1e-3        # the geo term is not idle


def test_initializer_em_geo_term_matches_jax(monkeypatch):
    """The annealed EM with the geo term, from the same start and the same
    total size in both packages: the same initial clusters."""
    import sbayes_tpu.sampling.initializer as jax_init_mod
    import sbayes_tpu_torch.sampling.initializer as init_mod

    p = geo_pair(aggregation="sum")
    c = p["m"].consts
    G = K + 1 + 2
    z0 = np.random.default_rng(0).random((G, c.N)).astype(np.float32)
    monkeypatch.setattr(jax_init_mod, "_truncnorm_sample",
                        lambda key, mid, lower, upper, scale: jnp.float32(mid))
    monkeypatch.setattr(init_mod, "_truncnorm_sample",
                        lambda gen, n, mid, lower, upper, scale, device: torch.full((n,), mid))
    jax_uniform, torch_rand = jax.random.uniform, torch.rand
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **kw: (
        jnp.asarray(z0) if tuple(shape) == z0.shape else jax_uniform(key, shape, *a, **kw)))
    monkeypatch.setattr(torch, "rand", lambda *size, **kw: (
        torch.as_tensor(z0)[None] if tuple(size[0]) == (1,) + z0.shape
        else torch_rand(*size, **kw)))
    kw = dict(initial_size=4, attempts=1, n_em_steps=8)
    want = jax_init_mod.Initializer(p["jcond"], **kw).generate_clusters_em(jax.random.PRNGKey(0))
    got = init_mod.Initializer(p["cond"], **kw).generate_clusters_em(
        torch.Generator().manual_seed(0), 1)
    assert got.shape == (1, K, c.N)
    np.testing.assert_array_equal(_np(got)[0], np.asarray(want))
    # the geo term moves the result: without it other clusters come out
    p0 = geo_pair(prior_type="uniform")
    plain = init_mod.Initializer(p0["cond"], **kw).generate_clusters_em(
        torch.Generator().manual_seed(0), 1)
    assert not np.array_equal(_np(plain), _np(got))


def test_initializer_discretization_can_exceed_max_size():
    """Pins a departure shared with the JAX package: the EM's discretization
    bounds the total size by ``K * max_size`` but no single cluster, so soft
    assignments that favour one cluster give it more than ``max_size``
    objects (here 26 of 30 against a maximum of 10), in both packages alike."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.sampling.initializer import Initializer as JaxInitializer
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.initializer import Initializer
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    override = {"model": {"clusters": K, "prior": {"objects_per_cluster": {
        "type": "uniform_area", "min": 2, "max": 10}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=K).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=K).update(override)
    jcond = JaxCond(JaxModel(jax_data(**KW), jcfg.model).posterior)
    cond = Conditionals(Model(synthetic_data(**KW), cfg.model, device="cpu").posterior)
    c = cond.consts
    assert (c.min_size, c.max_size, c.N) == (2, 10, 30)
    rng = np.random.default_rng(0)
    z = rng.uniform(0.0, 0.1, size=(K + 3, c.N)).astype(np.float32)
    z[0] += 0.8                                     # every object favours cluster 0
    total = min(c.N, K * c.max_size)                # the largest total the EM draws
    kw = dict(initial_size=4, attempts=1)
    want = np.asarray(JaxInitializer(jcond, **kw)._discretize_fuzzy_clusters(
        jnp.asarray(z), jnp.int32(total)))
    got = _np(Initializer(cond, **kw)._discretize_fuzzy_clusters(
        torch.as_tensor(z)[None], torch.tensor([total])))[0]
    np.testing.assert_array_equal(got, want)
    sizes = got.sum(-1)
    assert sizes.tolist() == [c.N - 2 * c.min_size, c.min_size, c.min_size]
    assert sizes.max() > c.max_size
