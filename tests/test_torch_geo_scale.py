"""The geo prior of the port at scale against the JAX package on the CPU:
the cost-row tiles of the masked reductions (each object's cheapest edge to
a cluster, the complete graph's longest edge) against one tile of all rows
and against the JAX functions, the batched Prim past 2,048 objects against
the JAX package's gather-form Prim (its engine there), and one initial
sample with the cost-based geo term (the EM's geo term, then the ten ML
steps that weigh membership by the geo prior) on the packed source over
feature tiles against the JAX initializer with the same forced chunk.

Tolerances: tiled against untiled is bit-equal (a min or a max is exact);
against JAX 1e-5 relative (float32 sums of edge costs in another order,
through an exponential or a log-sigmoid), atol 1e-6 at the zeros; the
per-object change log p(after) - log p(before) 1e-5 relative to the larger
of its two terms (their f32 rounding, which the subtraction keeps); the
Prim's edge counts exactly, its totals 1e-5 relative; the initial sample's
clusters and sources exactly (the categorical draws of both packages are
forced to the most probable component)."""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_posterior_ops import _np

SHAPE = dict(n_objects=300, n_features=8, n_states=3, n_families=2, seed=1)
K, B = 3, 3
ROW_TILE = 64
RTOL = 1e-5
AGGREGATIONS = ["mean", "sum", "max"]
FUNCTIONS = ["exponential", "sigmoid"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n_clusters, geo, **mcmc):
    """Both packages' synthetic configs with the cost-based geo settings
    ``geo`` (planar costs of ``synthetic_data_large``: a rate of a few
    units makes the geo prior matter)."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.testing import synthetic_config as jax_config
    from sbayes_tpu_torch.testing import synthetic_config

    override = {"model": {"clusters": n_clusters, "prior": {"geo": {"type": "cost_based", **geo}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=n_clusters).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=n_clusters).update(override)
    return jcfg, cfg


_MODELS = {}


def geo_models(aggregation="mean", function="exponential", skeleton="mst"):
    """Both packages' models at N = 300 for one geo setting, and B numpy
    clusterings of K disjoint clusters of 20-120 objects (cached)."""
    key = (aggregation, function, skeleton)
    if key not in _MODELS:
        from sbayes_tpu.model.model import Model as JaxModel
        from sbayes_tpu.testing_scale import synthetic_data_large as jax_large
        from sbayes_tpu_torch.model.model import Model
        from sbayes_tpu_torch.testing_scale import synthetic_data_large

        jcfg, cfg = _configs(K, {"aggregation": aggregation, "probability_function": function,
                                 "skeleton": skeleton, "rate": 5.0, "inflection_point": 8.0})
        jm = JaxModel(jax_large(**SHAPE), jcfg.model)
        m = Model(synthetic_data_large(**SHAPE), cfg.model, device="cpu")
        rng = np.random.default_rng(7)
        clusters = np.zeros((B, K, SHAPE["n_objects"]), bool)
        for b in range(B):
            order = rng.permutation(SHAPE["n_objects"])
            sizes = rng.integers(20, 121, size=K)
            bounds = np.concatenate([[0], np.cumsum(sizes)])
            for k in range(K):
                clusters[b, k, order[bounds[k]:bounds[k + 1]]] = True
        _MODELS[key] = (jm, m, clusters)
    return _MODELS[key]


def test_auto_cost_row_tile():
    """The rule: all rows while (masks, N, N) stays within 2**26 elements
    (the main shape, 1024 chains x 100 objects), tiles of 419 rows for 16
    chains at 10,000 objects (a 268 MB temporary where one tile of all rows
    would take 6.4 GB), 83 rows for the 80 masks of an initial batch."""
    from sbayes_tpu_torch.model.constants import auto_cost_row_tile

    assert auto_cost_row_tile(1024, 100) == 100
    assert auto_cost_row_tile(16, 10_000) == 419
    assert 16 * 419 * 10_000 * 4 < 0.3e9
    assert auto_cost_row_tile(80, 10_000) == 83
    assert auto_cost_row_tile(10 ** 6, 10 ** 5) == 1


@pytest.mark.parametrize("carried", [True, False], ids=["carried", "recomputed"])
@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_geo_costs_per_object_tiled(aggregation, function, carried):
    """Each chain's cluster ``i_cluster[b]``: tiles of 64 cost rows against
    one tile of all 300 (bit-equal), and against JAX's vmapped
    ``geo_prior_costs_per_object`` (with the carried aggregates of each
    package, or the MST recomputed)."""
    jm, m, clusters = geo_models(aggregation, function)
    post = m.posterior
    cl = torch.as_tensor(clusters)
    i_cluster = torch.tensor([0, 1, 2])
    agg = post.geo_agg_of(cl) if carried else None
    tiled = post.geo_prior_costs_per_object(cl, i_cluster, geo_agg=agg, row_tile=ROW_TILE)
    untiled = post.geo_prior_costs_per_object(cl, i_cluster, geo_agg=agg,
                                              row_tile=SHAPE["n_objects"])
    assert torch.equal(tiled, untiled)
    assert torch.equal(post.geo_prior_costs_per_object(cl, i_cluster, geo_agg=agg), untiled)
    jpost = jm.posterior
    jcl = jnp.asarray(clusters)
    if carried:
        jagg = jax.vmap(jpost.geo_agg_of)(jcl)
        want = jax.vmap(lambda c, i, a: jpost.geo_prior_costs_per_object(c, i, geo_agg=a))(
            jcl, jnp.asarray(i_cluster.numpy()), jagg)
    else:
        want = jax.vmap(jpost.geo_prior_costs_per_object)(jcl, jnp.asarray(i_cluster.numpy()))
    assert bool((tiled != 0).any())                                       # the term is not idle
    # The change is log p(after) - log p(before): f32 rounding of the two
    # terms (sums of up to 120 edges in another order) scales with them.
    before = post._geo_probability_function(post._aggregate_of_triple(
        post.geo_agg_of(cl)[torch.arange(B), i_cluster]))
    atol = 1e-6 + RTOL * _np(before.abs())[:, None]
    assert (np.abs(_np(tiled) - np.asarray(want)) <= atol + RTOL * np.abs(np.asarray(want))).all()


def test_complete_graph_triple_tiled():
    """The complete graph's [total, n_edges, max_edge] (the full (m, m)
    submatrix, diagonal included) of every cluster and of an empty and a
    one-object mask: the longest edge over tiles of 64
    rows equals one tile of all rows and JAX's vmapped ``skeleton_triple``."""
    jm, m, clusters = geo_models("max", "exponential", skeleton="complete_graph")
    masks = np.concatenate([clusters.reshape(B * K, -1),
                            np.zeros((2, SHAPE["n_objects"]), bool)])
    masks[-1, 5] = True
    post = m.posterior
    got = post.skeleton_triple(torch.as_tensor(masks), row_tile=ROW_TILE)
    assert torch.equal(got, post.skeleton_triple(torch.as_tensor(masks),
                                                 row_tile=SHAPE["n_objects"]))
    want = np.asarray(jax.vmap(jm.posterior.skeleton_triple)(jnp.asarray(masks)))
    np.testing.assert_array_equal(_np(got)[:, 1], want[:, 1])
    np.testing.assert_array_equal(_np(got)[:, 2], want[:, 2])
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=1e-6)
    # empty: nothing; one object: its diagonal, the one (m, m) edge of cost 0
    np.testing.assert_array_equal(_np(got)[-2:], [[0, 0, 0], [0, 1, 0]])


@pytest.mark.parametrize("seed", [0, 1])
def test_prim_past_2048_objects_equals_jax_gather_form(seed):
    """At N = 2,100 the JAX package's posterior takes the gather-form Prim
    ``cluster_mst_edge_costs``. The port's Prim against it on masks of 50 to
    400 members, one of them split by an infinite cut (its tree stops at
    the cut in both): [sum, count, max] of the edges."""
    from sbayes_tpu.ops.mst import cluster_mst_edge_costs
    from sbayes_tpu_torch.ops.mst import cluster_mst_stats

    n = 2_100
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-75, -35, size=(n, 2))
    cost = np.linalg.norm(xy[:, None] - xy[None], axis=-1).astype(np.float32)
    cut = n // 2
    cost[:cut, cut:] = np.inf
    cost[cut:, :cut] = np.inf
    sizes = [50, 120, 250, 400, 300]
    masks = np.zeros((len(sizes), n), bool)
    for row, size in zip(masks[:-1], sizes[:-1]):
        row[rng.choice(cut, size=size, replace=False)] = True
    masks[-1, rng.choice(n, size=sizes[-1], replace=False)] = True          # both sides of the cut
    assert masks[-1, :cut].any() and masks[-1, cut:].any()

    got = _np(cluster_mst_stats(torch.as_tensor(cost), torch.as_tensor(masks)))
    edges, count = jax.vmap(cluster_mst_edge_costs, in_axes=(None, 0))(jnp.asarray(cost),
                                                                      jnp.asarray(masks))
    want = np.stack([np.asarray(edges).sum(-1), np.asarray(count), np.asarray(edges).max(-1)], -1)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_array_equal(got[:-1, 1], np.asarray(sizes[:-1]) - 1)
    assert got[-1, 1] < sizes[-1] - 1                                     # stopped at the cut
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isfinite(got).all()


@pytest.fixture
def forced_init_draws(monkeypatch):
    """Both initializers' categorical draws forced to the most probable
    component (the prior source, the full source passes, the ML steps'
    source resamples)."""
    import sbayes_tpu.sampling.conditionals as jax_cond
    import sbayes_tpu.sampling.initializer as jax_init
    import sbayes_tpu.sampling.operators as jax_ops
    import sbayes_tpu_torch.sampling.conditionals as cond_mod
    import sbayes_tpu_torch.sampling.initializer as init_mod
    import sbayes_tpu_torch.sampling.operators as ops_mod

    def jax_argmax(key, p):
        return jnp.arange(p.shape[-1]) == jnp.argmax(p, -1)[..., None]

    def torch_argmax(gen, p):
        return torch.nn.functional.one_hot(p.argmax(-1), p.shape[-1]).bool()

    for mod in (jax_cond, jax_init, jax_ops):
        monkeypatch.setattr(mod, "sample_categorical_onehot", jax_argmax)
    for mod in (cond_mod, init_mod, ops_mod):
        monkeypatch.setattr(mod, "sample_categorical_onehot", torch_argmax)
    return jax_init, init_mod


def test_initial_sample_with_the_geo_term_on_packed_tiles_equals_jax(monkeypatch,
                                                                    forced_init_draws):
    """One initial attempt at K = 3 under the cost-based geo prior (mean,
    rate 5 on planar costs): the annealed EM with its geo term from the
    same start and total size, a prior source, a full source pass, the
    first three ML steps (``consider_geo``: the cluster's MST recomputed,
    no aggregates carried yet), the weights re-estimate, a second source
    pass and three more ML steps. The port on the packed source over
    feature tiles of 5 (60 objects x 20 features), the JAX package with
    SBAYES_TPU_FEATURE_CHUNK=5: the same clusters and sources; and the geo
    term moves the EM's clusters."""
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.testing_scale import synthetic_data_large as jax_large
    from sbayes_tpu_torch.model.math import source_onehot
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.testing_scale import synthetic_data_large

    jax_init, init_mod = forced_init_draws
    shape = dict(n_objects=60, n_features=20, n_states=4, n_families=3, seed=2)
    monkeypatch.setenv("SBAYES_TPU_FEATURE_CHUNK", "5")
    jcfg, cfg = _configs(3, {"aggregation": "mean", "rate": 5.0})
    jm = JaxModel(jax_large(**shape), jcfg.model)
    m = Model(synthetic_data_large(**shape), cfg.model, device="cpu", source_packed=True,
              feature_chunk=5)
    c = m.consts
    assert jm.consts.feature_chunk == c.feature_chunk == 5 and c.source_packed
    G = c.K + 1 + 3
    z0 = np.random.default_rng(0).random((G, c.N)).astype(np.float32)
    monkeypatch.setattr(jax_init, "_truncnorm_sample",
                        lambda key, mid, lower, upper, scale: jnp.float32(mid))
    monkeypatch.setattr(init_mod, "_truncnorm_sample",
                        lambda gen, n, mid, lower, upper, scale, device: torch.full((n,), mid))
    jax_uniform, torch_rand = jax.random.uniform, torch.rand
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **kw: (
        jnp.asarray(z0) if tuple(shape) == z0.shape else jax_uniform(key, shape, *a, **kw)))
    monkeypatch.setattr(torch, "rand", lambda *size, **kw: (
        torch.as_tensor(z0)[None] if tuple(size[0]) == (1,) + z0.shape
        else torch_rand(*size, **kw)))
    kw = dict(initial_size=8, attempts=1, n_em_steps=3)
    cond = Conditionals(m.posterior)
    got = init_mod.Initializer(cond, **kw).generate_sample_attempt(
        torch.Generator().manual_seed(0), 1)
    want = jax.jit(jax_init.Initializer(JaxCond(jm.posterior), **kw).generate_sample_attempt)(
        jax.random.PRNGKey(0))
    assert got.source.dtype == torch.int8
    np.testing.assert_array_equal(_np(got.clusters)[0], np.asarray(want.clusters))
    np.testing.assert_array_equal(_np(source_onehot(got.source, c.C))[0],
                                  np.asarray(want.source))
    np.testing.assert_allclose(_np(got.weights)[0], np.asarray(want.weights), rtol=1e-6)
    sizes = _np(got.clusters).sum(-1)[0]
    assert ((sizes >= c.min_size) & (sizes > 0)).all()

    em = init_mod.Initializer(cond, **kw).generate_clusters_em(
        torch.Generator().manual_seed(0), 1)
    _, cfg_u = _configs(3, {"aggregation": "mean", "rate": 5.0})
    cfg_u = cfg_u.update({"model": {"prior": {"geo": {"type": "uniform"}}}})
    plain = init_mod.Initializer(Conditionals(
        Model(synthetic_data_large(**shape), cfg_u.model, device="cpu", source_packed=True,
              feature_chunk=5).posterior), **kw).generate_clusters_em(
        torch.Generator().manual_seed(0), 1)
    assert not torch.equal(plain, em)
