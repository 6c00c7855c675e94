"""The PyTorch port's posterior, sample view, proposals and count updates
against the JAX package, on one numpy state carried into both packages
(``ChainState.from_numpy``); and the carried invariants of a sampling run
against a full recompute.

Tolerances: counts are exact integers in float32 on both sides (equal);
log-densities rtol 1e-5 (float32 lgamma / log sums in another order);
proposal probabilities rtol 1e-4 (a sum of F logs through a sigmoid, and
the wide operator's rescale loop)."""
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

FIXTURES = Path(__file__).parent / "fixtures"
KW = dict(n_objects=40, n_features=12, n_states=4, n_families=3, seed=2)
RTOL_DENSITY = 1e-5
RTOL_PROPOSAL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_state(K, N, F, C, na, seed, min_size=2):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, K + 2, size=N)                 # > K-1: in no cluster
    label[:K * min_size] = np.repeat(np.arange(K), min_size)
    clusters = np.stack([label == k for k in range(K)])
    comp = rng.integers(0, C, size=(N, F))
    source = (comp[..., None] == np.arange(C)) & ~na[:, :, None]
    weights = rng.dirichlet(np.ones(C), size=F).astype(np.float32)
    return {"clusters": clusters, "weights": weights, "source": source,
            "log_lh": 0.0, "log_prior": 0.0, "prior_parts": np.zeros(4, np.float32)}


@pytest.fixture(scope="module")
def pair():
    # a Dirichlet weights prior so that the weights prior is not identically 0
    return make_pair({"model": {"prior": {"weights": {"type": "jeffreys"}}}})


def make_pair(override):
    """Both packages' model, conditionals, operator factory and filled state
    of one numpy state, for the synthetic config updated by ``override``."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.sampling.operators import OperatorFactory as JaxFactory
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.operators import OperatorFactory
    from sbayes_tpu_torch.sampling.state import ChainState
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=1).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=1).update(override)
    jm = JaxModel(jax_data(**KW), jcfg.model)
    m = Model(synthetic_data(**KW), cfg.model, device="cpu")
    c = m.consts
    d = numpy_state(c.K, c.N, c.F, c.C, c.na.numpy(), seed=9)
    jcond = JaxCond(jm.posterior)
    cond = Conditionals(m.posterior)
    jstate = jcond.post.fill_state(JaxState.from_numpy(d))
    state = cond.post.fill_state(ChainState.from_numpy(d))
    return dict(jm=jm, jcfg=jcfg, jcond=jcond, jfact=JaxFactory(jcond), jstate=jstate,
                m=m, cfg=cfg, cond=cond, fact=OperatorFactory(cond), state=state, d=d)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_from_numpy_batches_single_and_batched(pair):
    from sbayes_tpu_torch.sampling.state import ChainState

    d = pair["d"]
    single = ChainState.from_numpy(d)
    assert single.clusters.shape == (1,) + d["clusters"].shape
    batched = ChainState.from_numpy({k: np.stack([v, v]) if isinstance(v, np.ndarray)
                                     else np.asarray([v, v]) for k, v in d.items()})
    assert batched.source.shape == (2,) + d["source"].shape
    back = single.to_numpy(chain=0)
    for k in ("clusters", "weights", "source"):
        np.testing.assert_array_equal(back[k], d[k])


@pytest.mark.parametrize("key", ["cl_counts", "conf_counts", "pat_counts"])
def test_fill_state_counts_equal_jax(pair, key):
    np.testing.assert_array_equal(_np(getattr(pair["state"], key))[0],
                                  _np(getattr(pair["jstate"], key)))


@pytest.mark.parametrize("key", ["log_lh", "log_prior", "prior_parts"])
def test_fill_state_densities_match_jax(pair, key):
    np.testing.assert_allclose(_np(getattr(pair["state"], key))[0],
                               _np(getattr(pair["jstate"], key)), rtol=RTOL_DENSITY, atol=1e-5)


def test_parts_match_jax(pair):
    got = pair["cond"].post.parts(pair["state"])
    want = pair["jcond"].post.parts(pair["jstate"])
    for f in got._fields:
        np.testing.assert_allclose(_np(getattr(got, f))[0], _np(getattr(want, f)),
                                   rtol=RTOL_DENSITY, atol=1e-5, err_msg=f)


def test_make_record_matches_jax(pair):
    from sbayes_tpu.sampling.runner import SamplerRuntime as JaxRuntime
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime

    want = JaxRuntime(pair["jm"], pair["jcfg"].mcmc).make_record(pair["jstate"], i_step=7)
    got = SamplerRuntime(pair["m"], pair["cfg"].mcmc).make_record(pair["state"], i_step=7)
    for f in ("clusters", "weights", "source", "cluster_counts", "conf_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("log_lh", "log_prior", "size_prior", "geo_prior", "weights_prior",
              "source_prior"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=RTOL_DENSITY,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(got.observation_lh, want.observation_lh, rtol=RTOL_DENSITY)
    assert got.i_step == want.i_step == 7


def test_gibbsish_proposal_probabilities_match_jax(pair):
    c = pair["jm"].consts
    avail = ~jnp.asarray(pair["jstate"].clusters).any(0)
    want = pair["jfact"]._cluster_posterior(pair["jstate"], 0, avail, consider_geo=False)
    got = pair["fact"]._cluster_posterior(pair["state"], torch.zeros(1, dtype=torch.long))
    assert got.shape == (1, c.N)
    np.testing.assert_allclose(_np(got)[0], _np(want), rtol=RTOL_PROPOSAL, atol=1e-7)


def test_wide_proposal_probabilities_match_jax(pair):
    c = pair["jm"].consts
    js, s = pair["jstate"], pair["state"]
    eps = 0.01 / c.N
    avail_np = ~np.asarray(js.clusters).any(0) | np.asarray(js.clusters)[0]
    want = pair["jfact"]._make_wide_cluster_probs(False, 0.15, eps, 2.0)(
        js, 0, jnp.asarray(avail_np), (js.cl_counts, js.conf_counts))
    got = pair["fact"]._make_wide_cluster_probs(0.15, eps)(
        s, torch.zeros(1, dtype=torch.long), torch.as_tensor(avail_np)[None],
        (s.cl_counts, s.conf_counts))
    np.testing.assert_allclose(_np(got)[0], _np(want), rtol=RTOL_PROPOSAL, atol=1e-7)


OBJ_IDX = [3, 17, 0, 29, 40]     # the last one is padding (N)


def test_source_posterior_rows_match_jax(pair):
    from sbayes_tpu.model.math import gather_const_rows

    c = pair["jm"].consts
    js, s = pair["jstate"], pair["state"]
    idx = jnp.asarray(OBJ_IDX)
    feats_m = gather_const_rows(jnp.asarray(c.features), idx)
    na_m = gather_const_rows(jnp.asarray(c.na), idx) > 0.5
    want = pair["jcond"].source_posterior_rows(js.clusters, js.weights,
                                               (js.cl_counts, js.conf_counts), idx, feats_m, na_m)
    tidx = torch.as_tensor(OBJ_IDX)[None]
    tf, tna, thc = pair["cond"].gather_obj(tidx)
    got = pair["cond"].source_posterior_rows(s.clusters, s.weights, (s.cl_counts, s.conf_counts),
                                             tidx, tf, tna, thc)
    valid = np.asarray(OBJ_IDX) < c.N
    np.testing.assert_allclose(_np(got)[0][valid], _np(want)[valid], rtol=RTOL_PROPOSAL,
                               atol=1e-7)


def test_delta_counts_rows_move_equals_jax(pair):
    from sbayes_tpu.model.math import gather_const_rows, gather_rows as jax_gather_rows
    from sbayes_tpu_torch.model.math import gather_rows

    c = pair["jm"].consts
    js, s = pair["jstate"], pair["state"]
    rng = np.random.default_rng(1)
    clusters_new = np.asarray(js.clusters).copy()
    clusters_new[0, OBJ_IDX[:-1]] = ~clusters_new[0, OBJ_IDX[:-1]]
    comp = rng.integers(0, c.C, size=(len(OBJ_IDX), c.F))
    na_rows = np.asarray(c.na)[np.minimum(OBJ_IDX, c.N - 1)]
    new_rows = (comp[..., None] == np.arange(c.C)) & ~na_rows[..., None]
    valid = np.asarray(OBJ_IDX) < c.N
    idx = jnp.asarray(OBJ_IDX)
    want = pair["jcond"].delta_counts_rows_move(
        (js.cl_counts, js.conf_counts), js.clusters, jnp.asarray(clusters_new), idx,
        jnp.asarray(valid), jax_gather_rows(js.source, idx, c.C), jnp.asarray(new_rows),
        gather_const_rows(jnp.asarray(c.features), idx))
    tidx = torch.as_tensor(OBJ_IDX)[None]
    got = pair["cond"].delta_counts_rows_move(
        (s.cl_counts, s.conf_counts), s.clusters, torch.as_tensor(clusters_new)[None], tidx,
        torch.as_tensor(valid)[None], gather_rows(s.source, tidx),
        torch.as_tensor(new_rows)[None], pair["cond"].gather_obj(tidx)[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g)[0], _np(w))


def test_log_likelihood_diff_from_counts_matches_jax(pair):
    js, s = pair["jstate"], pair["state"]
    jpost, post = pair["jcond"].post, pair["cond"].post
    bump = np.zeros(np.asarray(js.cl_counts).shape, np.float32)
    bump[0, 2, 1], bump[0, 5, 0] = 1.0, -1.0
    bump = np.where(np.asarray(js.cl_counts) + bump < 0, 0.0, bump).astype(np.float32)
    jnew = (js.cl_counts + jnp.asarray(bump), js.conf_counts)
    want = float(jpost.log_likelihood_diff_from_counts(jnew, (js.cl_counts, js.conf_counts)))
    new = (s.cl_counts + torch.as_tensor(bump)[None], s.conf_counts)
    got = post.log_likelihood_diff_from_counts(new, (s.cl_counts, s.conf_counts))
    np.testing.assert_allclose(float(got[0]), want, rtol=RTOL_DENSITY, atol=1e-5)
    # unchanged counts cancel exactly: the diff of a state with itself is 0
    zero = post.log_likelihood_diff_from_counts((s.cl_counts, s.conf_counts),
                                                (s.cl_counts, s.conf_counts))
    assert float(zero[0]) == 0.0
    # and the diff agrees with the difference of totals
    total = post.log_likelihood_from_counts(*new) - post.log_likelihood_from_counts(
        s.cl_counts, s.conf_counts)
    np.testing.assert_allclose(float(got[0]), float(total[0]), atol=1e-3)


def test_carried_invariants_equal_recompute_after_sampling():
    """64 chains x 300 steps on the fixture data (uniform geo): the carried
    log-likelihood, log-prior and counts equal a full recompute; sources
    stay one-hot on observed cells and zero at NA; sizes stay in bounds."""
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(
            FIXTURES / "config.yaml", {"model": {"prior": {"geo": {"type": "uniform"}}}})
    model = Model(Data.from_config(cfg), cfg.model, device="cpu")
    rt = SamplerRuntime(model, cfg.mcmc)
    gen, op_gen = make_generators(3, "cpu")
    states = rt.init_chains(gen, 64)
    states, stats = rt.run_chunk(gen, op_gen, states, rt.new_stats(64), 300)
    assert int((stats.accepts + stats.rejects).sum()) == 64 * 300
    assert int(stats.non_finite.sum()) == 0
    ref = rt.refresh(states)
    for key in ("cl_counts", "conf_counts", "pat_counts"):
        torch.testing.assert_close(getattr(states, key), getattr(ref, key), rtol=0, atol=0)
    for key in ("log_lh", "log_prior", "prior_parts"):
        np.testing.assert_allclose(_np(getattr(states, key)), _np(getattr(ref, key)),
                                   rtol=1e-4, atol=1e-3, err_msg=key)
    src = _np(states.source)
    na = _np(model.consts.na)
    assert np.all(src[:, na].sum(-1) == 0)
    assert np.all(src[:, ~na].sum(-1) == 1)
    sizes = _np(states.clusters).sum(-1)
    assert np.all(sizes >= model.consts.min_size) and np.all(sizes <= model.consts.max_size)
