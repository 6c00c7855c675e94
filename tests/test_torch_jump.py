"""The port's jump operator (one object moves between two clusters) against
the JAX operator on one numpy state, with every random draw forced to the
same value in both packages: the ordered cluster pair, the most probable
member, the most probable source component of every resampled cell. The
chosen object carries the comparison of the jump probabilities; log_q,
log_q_back, ll_delta, source_prior_delta and the candidate's counts follow.

The JAX side runs once through its plain path and once through its Pallas
marginal kernel (feature chunks, interpret mode), the way
``tests/test_pallas_marginal.py`` runs it; the port's ``marginal`` runs its
plain version on these CPU tensors.

Tolerance: 1e-4 absolute (a log proposal probability from two sums of F logs
plus a sum of F source-row logs, float32 on both sides)."""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_posterior_ops import _np, numpy_state

ATOL = 1e-4
PAIR = (1, 0)          # the forced ordered pair (i_src, i_tgt)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jump_pair(monkeypatch, n_clusters, n_features, pallas=False, geo="uniform", min_size=2,
              state_seed=4):
    """Both packages' conditionals, operator factory and filled state of one
    numpy state. ``pallas``: the JAX model is built with feature chunks and
    its Pallas marginal in interpret mode."""
    if pallas:
        monkeypatch.setenv("SBAYES_TPU_FEATURE_CHUNK", str(n_features // 2))
        monkeypatch.setenv("SBAYES_TPU_PALLAS_MARGINAL", "1")
        monkeypatch.setenv("SBAYES_TPU_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("SBAYES_TPU_PALLAS_BF16MM", "0")
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

    kw = dict(n_objects=24, n_features=n_features, n_states=3, n_families=2, seed=6)
    geo_cfg = {"type": geo}
    if geo == "cost_based":
        geo_cfg.update({"rate": 2e5, "aggregation": "sum"})
    override = {"model": {"clusters": n_clusters, "prior": {
        "geo": geo_cfg,
        "objects_per_cluster": {"type": "uniform_area", "min": min_size, "max": 8}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=n_clusters).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=n_clusters).update(override)
    jm = JaxModel(jax_data(**kw), jcfg.model)
    assert (jm.consts.feature_chunk is not None) == pallas
    m = Model(synthetic_data(**kw), cfg.model, device="cpu")
    c = m.consts
    d = numpy_state(c.K, c.N, c.F, c.C, c.na.numpy(), seed=state_seed, min_size=3)
    d["clusters"][:, 8:] &= np.cumsum(d["clusters"][:, 8:], axis=1) <= 2     # sizes within max
    # a source that is valid for the clusters (each cell from an available component)
    avail = np.concatenate([d["clusters"].any(0)[:, None], _np(c.hc_conf)], axis=1)
    score = np.random.default_rng(state_seed).random((c.N, c.F, c.C)) * avail[:, None, :]
    d["source"] = (score.argmax(-1)[..., None] == np.arange(c.C)) & ~_np(c.na)[..., None]
    jcond, cond = JaxCond(jm.posterior), Conditionals(m.posterior)
    jstate = jcond.post.fill_state(JaxState.from_numpy(d))
    state = cond.post.fill_state(ChainState.from_numpy(d))
    return dict(jm=jm, m=m, jcond=jcond, cond=cond, jfact=JaxFactory(jcond),
                fact=OperatorFactory(cond), jstate=jstate, state=state, d=d)


@pytest.fixture
def forced_draws(monkeypatch):
    """Fix the jump's random draws in both packages: the ordered cluster
    pair ``PAIR``, the most probable member of the source cluster, the most
    probable source component of every resampled cell."""
    import sbayes_tpu.sampling.conditionals as jax_cond_mod
    import sbayes_tpu.sampling.operators as jax_ops_mod
    import sbayes_tpu_torch.sampling.conditionals as cond_mod
    import sbayes_tpu_torch.sampling.operators as ops_mod

    def fixed_permutation(key, k):
        return jnp.asarray(list(PAIR) + [i for i in range(int(k)) if i not in PAIR])

    def fixed_pair(gen, n_chains, n_clusters, device):
        return (torch.full((n_chains,), PAIR[0]), torch.full((n_chains,), PAIR[1]))

    monkeypatch.setattr(jax.random, "permutation", fixed_permutation)
    monkeypatch.setattr(ops_mod, "_random_cluster_pair", fixed_pair)
    monkeypatch.setattr(jax_ops_mod, "_masked_categorical",
                        lambda key, p, mask: jnp.argmax(jnp.where(mask, p, -1.0)))
    monkeypatch.setattr(ops_mod, "_masked_categorical",
                        lambda gen, p, mask: torch.argmax(torch.where(mask, p, -1.0), -1))
    monkeypatch.setattr(jax_cond_mod, "sample_categorical_onehot",
                        lambda key, p: jnp.arange(p.shape[-1]) == jnp.argmax(p, -1)[..., None])
    monkeypatch.setattr(cond_mod, "sample_categorical_onehot",
                        lambda gen, p: torch.nn.functional.one_hot(p.argmax(-1),
                                                                   p.shape[-1]).bool())


def _compare(res, jres, geo=False):
    np.testing.assert_array_equal(_np(res.state.clusters)[0], np.asarray(jres.state.clusters))
    for name in ("log_q", "log_q_back", "ll_delta", "source_prior_delta"):
        got, want = float(_np(getattr(res, name))[0]), float(getattr(jres, name))
        assert np.isfinite(got) and np.isfinite(want), name
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        np.testing.assert_array_equal(_np(getattr(res.state, name))[0],
                                      np.asarray(getattr(jres.state, name)), err_msg=name)
    idx, rows = res.source_rows
    jidx, jrows = jres.source_rows
    np.testing.assert_array_equal(_np(idx)[0], np.asarray(jidx))
    np.testing.assert_array_equal(_np(rows)[0], np.asarray(jrows))
    if geo:
        np.testing.assert_allclose(_np(res.state.geo_agg)[0], np.asarray(jres.state.geo_agg),
                                   rtol=1e-5)
    else:
        assert res.state.geo_agg is None and jres.state.geo_agg is None


def _moved_object(res, p):
    before = _np(p["state"].clusters)[0]
    after = _np(res.state.clusters)[0]
    moved = np.flatnonzero(before[PAIR[0]] & ~after[PAIR[0]])
    assert moved.size == 1 and after[PAIR[1], moved[0]] and not before[PAIR[1], moved[0]]
    assert (after.sum(0) <= 1).all()
    return int(moved[0])


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_plain", "jax_pallas"])
def test_jump_at_4_features_matches_jax(monkeypatch, forced_draws, pallas):
    """K = 2, 4 features: the products of the EPS-flooring form stay above
    the float32 epsilon, so the members' jump probabilities differ and the
    chosen object is the one both packages score highest."""
    p = jump_pair(monkeypatch, n_clusters=2, n_features=4, pallas=pallas)
    s = p["state"]
    pj = p["fact"]._jump_probability(s, (s.cl_counts, s.conf_counts), torch.tensor([PAIR[0]]),
                                     torch.tensor([PAIR[1]]), logspace=False)
    members = _np(pj)[0][_np(s.clusters)[0, PAIR[0]]]
    assert members.std() > 1e-2 and np.all((members > 0) & (members < 1))
    res = p["fact"].make_cluster_jump()(torch.Generator().manual_seed(0), s)
    jres = p["jfact"].make_cluster_jump(gibbsish=True)(jax.random.PRNGKey(0), p["jstate"])
    obj = _moved_object(res, p)
    assert pj[0, obj] == pj[0][s.clusters[0, PAIR[0]]].max()
    _compare(res, jres)


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_plain", "jax_pallas"])
def test_jump_k3_with_geo_matches_jax(monkeypatch, forced_draws, pallas):
    """K = 3, 12 features, a cost-based geo prior: the candidate also
    carries the re-derived skeleton aggregates of both changed clusters."""
    p = jump_pair(monkeypatch, n_clusters=3, n_features=12, pallas=pallas, geo="cost_based")
    res = p["fact"].make_cluster_jump()(torch.Generator().manual_seed(0), p["state"])
    jres = p["jfact"].make_cluster_jump(gibbsish=True)(jax.random.PRNGKey(0), p["jstate"])
    _moved_object(res, p)
    _compare(res, jres, geo=True)
    want = p["cond"].post.geo_agg_of(res.state.clusters)
    np.testing.assert_allclose(_np(res.state.geo_agg), _np(want), rtol=1e-6)
    assert not np.allclose(_np(res.state.geo_agg), _np(p["state"].geo_agg))


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_plain", "jax_pallas"])
def test_logspace_jump_matches_jax(monkeypatch, forced_draws, pallas):
    """The log-space form sigmoid((log m_jump - log m_stay) / T) at 8
    features: the JAX package switched by its environment variable, the
    port by the ``logspace`` keyword (default: from 512 features on)."""
    monkeypatch.setenv("SBAYES_TPU_JUMP_LOGSPACE", "1")
    p = jump_pair(monkeypatch, n_clusters=2, n_features=8, pallas=pallas)
    res = p["fact"].make_cluster_jump(logspace=True)(torch.Generator().manual_seed(0),
                                                     p["state"])
    jres = p["jfact"].make_cluster_jump(gibbsish=True)(jax.random.PRNGKey(0), p["jstate"])
    _moved_object(res, p)
    _compare(res, jres)


def test_eps_form_floors_to_one_half_at_36_features(monkeypatch):
    """At the south_america width both f32 products fall below the epsilon
    floor: every member's jump probability is 0.5 within 1e-3, an uninformed
    proposal (which is why the small-F cases above exist); the log-space
    form, equal to it where nothing is floored, stays informative."""
    p = jump_pair(monkeypatch, n_clusters=2, n_features=36)
    s = p["state"]
    args = (s, (s.cl_counts, s.conf_counts), torch.tensor([PAIR[0]]), torch.tensor([PAIR[1]]))
    member = _np(s.clusters)[0, PAIR[0]]
    floored = _np(p["fact"]._jump_probability(*args, logspace=False))[0][member]
    np.testing.assert_allclose(floored, 0.5, atol=1e-3)
    informed = _np(p["fact"]._jump_probability(*args, logspace=True))[0][member]
    assert informed.std() > 1e-2


def test_default_form_follows_the_feature_count(monkeypatch):
    """``logspace=None`` picks the EPS-flooring form below 512 features."""
    p = jump_pair(monkeypatch, n_clusters=2, n_features=8)
    gen = torch.Generator().manual_seed(3)
    default = p["fact"].make_cluster_jump()(gen, p["state"])
    gen.manual_seed(3)
    eps_form = p["fact"].make_cluster_jump(logspace=False)(gen, p["state"])
    torch.testing.assert_close(default.log_q, eps_form.log_q, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["source_at_min", "target_at_max"])
def test_jump_beyond_the_size_bounds_is_rejected(monkeypatch, forced_draws, which):
    """A jump that would leave the source cluster below ``min_size``, or
    take the target above ``max_size``, carries the reject sentinels (log_q
    0, log_q_back -inf), zero deltas and a dropped row write, as in JAX; the
    MH step then keeps the old state."""
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu_torch.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorSpec
    from sbayes_tpu_torch.sampling.state import ChainState

    p = jump_pair(monkeypatch, n_clusters=2, n_features=8, min_size=3)
    c = p["m"].consts
    d = dict(p["d"])
    clusters = np.zeros((2, c.N), bool)
    if which == "source_at_min":
        clusters[PAIR[0], :3] = True                  # at min_size = 3
        clusters[PAIR[1], 3:8] = True
    else:
        clusters[PAIR[0], :5] = True
        clusters[PAIR[1], 5:13] = True                # at max_size = 8
    d["clusters"] = clusters
    jstate = p["jcond"].post.fill_state(JaxState.from_numpy(d))
    state = p["cond"].post.fill_state(ChainState.from_numpy(d))
    op = p["fact"].make_cluster_jump()
    res = op(torch.Generator().manual_seed(0), state)
    jres = p["jfact"].make_cluster_jump(gibbsish=True)(jax.random.PRNGKey(0), jstate)
    assert float(res.log_q[0]) == float(jres.log_q) == 0.0
    assert float(res.log_q_back[0]) == float(jres.log_q_back) == -np.inf
    assert float(res.ll_delta[0]) == 0.0 and float(res.source_prior_delta[0]) == 0.0
    assert int(res.source_rows[0][0, 0]) == int(jres.source_rows[0][0]) == c.N
    apply = make_mh_apply_fn(p["cond"], [OperatorSpec("cluster_jump_gibbsish", 1.0, op)])
    new_state, accept, _, _ = apply(0, torch.Generator().manual_seed(1), state)
    assert not bool(accept[0])
    for a, b in zip(new_state, state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_jump_resample_engine_settings_match_jax(monkeypatch, forced_draws):
    """``gibbs_resample_source_jump_rows`` alone: forward under the target
    cluster's effect, backward under the source cluster's, unheated weights
    from the new clusters, against the JAX function on the same move."""
    p = jump_pair(monkeypatch, n_clusters=3, n_features=12)
    js, s = p["jstate"], p["state"]
    obj = int(np.flatnonzero(p["d"]["clusters"][PAIR[0]])[1])
    new = p["d"]["clusters"].copy()
    new[PAIR[0], obj], new[PAIR[1], obj] = False, True
    jrs = p["jcond"].gibbs_resample_source_jump_rows(
        jax.random.PRNGKey(0), js, jnp.asarray(new), jnp.asarray([obj]), jnp.ones(1, bool),
        i_cluster_new=PAIR[1], i_cluster_old=PAIR[0], counts=(js.cl_counts, js.conf_counts))
    rs = p["cond"].gibbs_resample_source_jump_rows(
        torch.Generator().manual_seed(0), s, torch.as_tensor(new)[None], torch.tensor([[obj]]),
        torch.ones((1, 1), dtype=torch.bool), i_cluster_new=torch.tensor([PAIR[1]]),
        i_cluster_old=torch.tensor([PAIR[0]]), counts=(s.cl_counts, s.conf_counts))
    np.testing.assert_array_equal(_np(rs.new_rows)[0], np.asarray(jrs.new_rows))
    for name in ("log_q", "log_q_back", "source_prior_delta"):
        np.testing.assert_allclose(float(getattr(rs, name)[0]), float(getattr(jrs, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    # the within-cluster engine (shared likelihoods, heated weights, backward
    # availability from the old clusters) is a different density on this move
    same = p["cond"].gibbs_resample_source_rows(
        torch.Generator().manual_seed(0), s, torch.as_tensor(new)[None], torch.tensor([[obj]]),
        torch.ones((1, 1), dtype=torch.bool), torch.tensor([PAIR[1]]),
        (s.cl_counts, s.conf_counts))
    assert abs(float(same.log_q_back[0]) - float(rs.log_q_back[0])) > 1e-3


def test_schedule_names_and_weights_match_jax(monkeypatch):
    """The ten operators of the K > 1 schedule, their normalized weights and
    which of them weight by the geo prior, against the JAX schedule."""
    from sbayes_tpu.sampling.operators import get_operator_schedule as jax_schedule
    from sbayes_tpu_torch.config.schema import OperatorsConfig
    from sbayes_tpu_torch.sampling.operators import get_operator_schedule

    p = jump_pair(monkeypatch, n_clusters=3, n_features=12, geo="cost_based")
    ops_cfg = OperatorsConfig.from_dict({"clusters": 45, "weights": 15, "source": 40})
    got = get_operator_schedule(p["cond"], ops_cfg)
    want = jax_schedule(p["jcond"], ops_cfg)
    assert [o.name for o in got] == [o.name for o in want] and len(got) == 10
    np.testing.assert_allclose([o.weight for o in got], [o.weight for o in want], rtol=1e-12)
    assert [o.changes for o in got] == [o.changes for o in want]
    assert [o.parameters for o in got] == [o.parameters for o in want]
    jump = next(o for o in got if o.name == "cluster_jump_gibbsish")
    assert jump.weight == pytest.approx(0.25 * 45 / 100)
