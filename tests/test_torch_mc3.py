"""MC3 in the PyTorch port against the JAX package on the CPU: per-chain
temperatures, the swap phase, the temperature ladder, the ladder warm-up,
the swap cadence across chunks, and two statistical checks.

A batch of three chains at (T, Tp) = (1, 1), (1.3, 1.7), (2, 1.2) (the
port's (B,) tensors) is held per chain against JAX ``Conditionals`` built at
that chain's scalar temperatures (``jnp.float32``, so that the JAX package
takes its traced-temperature path, heat variant included, as under its
vmapped ladder). The JAX heat marginal runs once on its XLA path and once
through its Pallas kernel in interpret mode (the env setup of
tests/test_pallas_marginal.py).

Tolerances: membership log-odds rtol = atol = 2e-4 (the JAX package's own
for its kernel against its XLA path: sums of F logs in another order);
source posteriors and heated membership probabilities rtol 1e-4, atol 1e-6;
jump log proposal densities and deltas 1e-4 absolute; the MH log ratio
within 1e-3 + 1e-4 |ratio| (bracketed by two forced uniforms); a tensor of
unit temperatures against the float path 1e-6."""
import math
import warnings
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import binomtest

import jax
import jax.numpy as jnp
import torch

from test_torch_posterior_ops import _np, numpy_state

FIXTURES = Path(__file__).parent / "fixtures"
TEMPS = ((1.0, 1.0), (1.3, 1.7), (2.0, 1.2))
TOL_ODDS = dict(rtol=2e-4, atol=2e-4)
TOL_PROB = dict(rtol=1e-4, atol=1e-6)
ATOL_JUMP = 1e-4
PAIR = (1, 0)
PALLAS_ENV = {"SBAYES_TPU_FEATURE_CHUNK": "4", "SBAYES_TPU_PALLAS_MARGINAL": "1",
              "SBAYES_TPU_PALLAS_INTERPRET": "1", "SBAYES_TPU_PALLAS_BF16MM": "0"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ladder_pair(monkeypatch, pallas=False, n_features=8):
    """Both packages' models (K = 2, cost-based geo prior, 24 objects) and
    three numpy states: the port's batch at the per-chain temperatures
    ``TEMPS``, and per chain the JAX state, conditionals and operator
    factory at that chain's temperatures."""
    if pallas:
        for k, v in PALLAS_ENV.items():
            monkeypatch.setenv(k, v)
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
    override = {"model": {"clusters": 2, "prior": {
        "geo": {"type": "cost_based", "rate": 2e5, "aggregation": "sum"},
        "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 8}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=2).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=2).update(override)
    jm = JaxModel(jax_data(**kw), jcfg.model)
    assert (jm.consts.feature_chunk is not None) == pallas
    m = Model(synthetic_data(**kw), cfg.model, device="cpu")
    c = m.consts
    na = _np(c.na)
    dicts = []
    for seed in (4, 5, 6):
        d = numpy_state(c.K, c.N, c.F, c.C, na, seed=seed, min_size=3)
        d["clusters"][:, 8:] &= np.cumsum(d["clusters"][:, 8:], axis=1) <= 2   # sizes within max
        avail = np.concatenate([d["clusters"].any(0)[:, None], _np(c.hc_conf)], axis=1)
        score = np.random.default_rng(seed).random((c.N, c.F, c.C)) * avail[:, None, :]
        d["source"] = (score.argmax(-1)[..., None] == np.arange(c.C)) & ~na[..., None]
        dicts.append(d)
    jconds = [JaxCond(jm.posterior, jnp.float32(t), jnp.float32(tp)) for t, tp in TEMPS]
    jstates = [jconds[0].post.fill_state(JaxState.from_numpy(d)) for d in dicts]
    batch = {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}
    cond = Conditionals(m.posterior, torch.tensor([t for t, _ in TEMPS]),
                        torch.tensor([tp for _, tp in TEMPS]))
    state = cond.post.fill_state(ChainState.from_numpy(batch))
    return dict(jm=jm, m=m, jconds=jconds, jfacts=[JaxFactory(jc) for jc in jconds],
                jstates=jstates, cond=cond, fact=OperatorFactory(cond), state=state)


def _xla(jfact, fn, *args, **kw):
    jfact._pm_cache = None
    try:
        return fn(*args, **kw)
    finally:
        jfact._pm_cache = False


@pytest.mark.parametrize("path", ["jax_xla", "jax_pallas"])
@pytest.mark.parametrize("heat", [False, True], ids=["noheat", "heat"])
def test_cluster_log_odds_per_chain_match_jax(monkeypatch, heat, path):
    """The membership log-odds of cluster 1: the ratio marginal, and with
    ``heat_effect_lh`` (the wide operator) its heat variant with each
    chain's own 1/T, the cold chain's included."""
    p = ladder_pair(monkeypatch, pallas=path == "jax_pallas")
    s = p["state"]
    got = _np(p["fact"]._cluster_log_odds(s, torch.tensor([1, 1, 1]), heat_effect_lh=heat))
    avail = jnp.ones(p["jm"].consts.N, bool)
    for b, (jf, js) in enumerate(zip(p["jfacts"], p["jstates"])):
        args = (js, 1, avail)
        kw = dict(counts=(js.cl_counts, js.conf_counts), heat_effect_lh=heat)
        want = (_xla(jf, jf._cluster_log_odds, *args, **kw) if path == "jax_xla"
                else jf._cluster_log_odds(*args, **kw))
        np.testing.assert_allclose(got[b], np.asarray(want), err_msg=f"chain {b}", **TOL_ODDS)


@pytest.mark.parametrize("heat", [False, True], ids=["noheat", "heat"])
def test_log_marginal_with_without_per_chain_match_jax(monkeypatch, heat):
    """Both absolute log-marginals (the EPS-flooring jump's variant) per chain."""
    p = ladder_pair(monkeypatch)
    g0, g1 = p["fact"]._log_marginal_with_without(p["state"], torch.tensor([1, 1, 1]),
                                                  heat_effect_lh=heat)
    avail = jnp.ones(p["jm"].consts.N, bool)
    for b, (jf, js) in enumerate(zip(p["jfacts"], p["jstates"])):
        w0, w1 = _xla(jf, jf._log_marginal_with_without, js, 1, avail,
                      counts=(js.cl_counts, js.conf_counts), heat_effect_lh=heat)
        np.testing.assert_allclose(_np(g0)[b], np.asarray(w0), err_msg=f"chain {b}", **TOL_ODDS)
        np.testing.assert_allclose(_np(g1)[b], np.asarray(w1), err_msg=f"chain {b}", **TOL_ODDS)


def test_source_posterior_per_chain_matches_jax(monkeypatch):
    """The source posterior, likelihoods heated by 1/T and weights by 1/Tp."""
    p = ladder_pair(monkeypatch)
    s = p["state"]
    got = _np(p["cond"].source_posterior(s.clusters, s.weights, s.source))
    for b, (jc, js) in enumerate(zip(p["jconds"], p["jstates"])):
        want = jc.source_posterior(js.clusters, js.weights, js.source)
        np.testing.assert_allclose(got[b], np.asarray(want), err_msg=f"chain {b}", **TOL_PROB)


def test_grow_shrink_posterior_per_chain_matches_jax(monkeypatch):
    """The Gibbsish grow/shrink proposal ``p_post``: the membership
    posterior with the geo term over Tp, heated by 1/T in logit space."""
    import sbayes_tpu.sampling.operators as jax_ops
    from sbayes_tpu_torch.sampling.operators import _heat_prob

    p = ladder_pair(monkeypatch)
    s, fact = p["state"], p["fact"]
    got = _np(_heat_prob(fact._cluster_posterior(
        s, torch.tensor([0, 0, 0]), True, (s.cl_counts, s.conf_counts), consider_geo=True),
        fact.T))
    avail = jnp.ones(p["jm"].consts.N, bool)
    for b, (jf, jc, js) in enumerate(zip(p["jfacts"], p["jconds"], p["jstates"])):
        jf._pm_cache = None
        want = jax_ops._heat_prob(jf._cluster_posterior(
            js, 0, avail, True, counts=(js.cl_counts, js.conf_counts)), jc.T)
        np.testing.assert_allclose(got[b], np.asarray(want), err_msg=f"chain {b}", **TOL_PROB)


@pytest.fixture
def forced_jump_draws(monkeypatch):
    """The jump's draws fixed in both packages: the ordered cluster pair
    ``PAIR``, the most probable member, the most probable source component
    of every resampled cell; ``forced["u"]`` is the JAX kernel's uniform."""
    import sbayes_tpu.sampling.conditionals as jax_cond_mod
    import sbayes_tpu.sampling.operators as jax_ops_mod
    import sbayes_tpu_torch.sampling.conditionals as cond_mod
    import sbayes_tpu_torch.sampling.operators as ops_mod

    forced = {"u": 0.5}
    jax_uniform = jax.random.uniform

    def fixed_uniform(key, shape=(), *args, **kw):
        if tuple(shape) == ():
            return jnp.float32(forced["u"])
        return jax_uniform(key, shape, *args, **kw)

    monkeypatch.setattr(jax.random, "uniform", fixed_uniform)
    monkeypatch.setattr(jax.random, "permutation", lambda key, k: jnp.asarray(
        list(PAIR) + [i for i in range(int(k)) if i not in PAIR]))
    monkeypatch.setattr(ops_mod, "_random_cluster_pair", lambda gen, n, k, device: (
        torch.full((n,), PAIR[0]), torch.full((n,), PAIR[1])))
    monkeypatch.setattr(jax_ops_mod, "_masked_categorical",
                        lambda key, p, mask: jnp.argmax(jnp.where(mask, p, -1.0)))
    monkeypatch.setattr(ops_mod, "_masked_categorical",
                        lambda gen, p, mask: torch.argmax(torch.where(mask, p, -1.0), -1))
    monkeypatch.setattr(jax_cond_mod, "sample_categorical_onehot",
                        lambda key, p: jnp.arange(p.shape[-1]) == jnp.argmax(p, -1)[..., None])
    monkeypatch.setattr(cond_mod, "sample_categorical_onehot",
                        lambda gen, p: torch.nn.functional.one_hot(p.argmax(-1),
                                                                   p.shape[-1]).bool())
    return forced


@pytest.mark.parametrize("logspace", [False, True], ids=["eps_form", "logspace"])
def test_jump_per_chain_matches_jax(monkeypatch, forced_jump_draws, logspace):
    """The jump at 8 features under forced draws: per chain the moved
    object, log_q, log_q_back (the heated jump probabilities of both
    directions and the source resample), ll_delta and source_prior_delta."""
    if logspace:
        monkeypatch.setenv("SBAYES_TPU_JUMP_LOGSPACE", "1")
    p = ladder_pair(monkeypatch)
    res = p["fact"].make_cluster_jump(logspace=logspace)(torch.Generator().manual_seed(0),
                                                         p["state"])
    for b, (jf, js) in enumerate(zip(p["jfacts"], p["jstates"])):
        jres = jf.make_cluster_jump(gibbsish=True)(jax.random.PRNGKey(0), js)
        np.testing.assert_array_equal(_np(res.state.clusters)[b], np.asarray(jres.state.clusters))
        for name in ("log_q", "log_q_back", "ll_delta", "source_prior_delta"):
            got, want = float(_np(getattr(res, name))[b]), float(getattr(jres, name))
            assert np.isfinite(got) and np.isfinite(want), name
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JUMP,
                                       err_msg=f"{name}, chain {b}")


def test_mh_log_ratio_per_chain_matches_jax(monkeypatch, forced_jump_draws):
    """The MH log ratio d_ll / T + d_prior / Tp - (log_q - log_q_back) of
    the jump step per chain: the port's ratio r_b is read in its kernel;
    the JAX kernel, run per chain with its uniform forced to exp(r_b -+ d),
    must accept below it and reject above it."""
    import sbayes_tpu_torch.sampling.kernel as kernel_mod
    from sbayes_tpu.sampling.kernel import make_mh_apply_fn as jax_apply_fn
    from sbayes_tpu.sampling.operators import OperatorSpec as JaxSpec
    from sbayes_tpu_torch.sampling.operators import OperatorSpec

    p = ladder_pair(monkeypatch)
    seen = []
    ratio = kernel_mod.mh_log_ratio

    def record(*args):
        r = ratio(*args)
        seen.append(r)
        return r

    monkeypatch.setattr(kernel_mod, "mh_log_ratio", record)
    spec = OperatorSpec("cluster_jump_gibbsish", 1.0, p["fact"].make_cluster_jump())
    kernel_mod.make_mh_apply_fn(p["cond"], [spec])(0, torch.Generator().manual_seed(0),
                                                  p["state"])
    r = _np(seen[0])
    assert r.shape == (3,) and np.all(np.isfinite(r)) and len(set(r.round(4))) == 3
    for b, (jc, jf, js) in enumerate(zip(p["jconds"], p["jfacts"], p["jstates"])):
        d = 1e-3 + 1e-4 * abs(float(r[b]))
        for sign, accepted in ((-1, True), (1, False)):
            forced_jump_draws["u"] = math.exp(float(r[b]) + sign * d)
            apply = jax_apply_fn(jc, [JaxSpec("cluster_jump_gibbsish", 1.0,
                                              jf.make_cluster_jump(gibbsish=True))])
            _, accept, _, _ = apply(0, jax.random.PRNGKey(0), js)
            assert bool(accept) == accepted, f"chain {b}: JAX ratio not within {d} of {r[b]}"


def _small_runtime(settings=None, n_clusters=1):
    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.utils import update_recursive

    base = {"model": {"clusters": n_clusters, "prior": {"geo": {"type": "uniform"}}}}
    update_recursive(base, settings or {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(FIXTURES / "config.yaml", base)
    model = Model(Data.from_config(cfg), cfg.model, device="cpu")
    return SamplerRuntime(model, cfg.mcmc, sample_from_prior=cfg.mcmc.sample_from_prior)


def test_unit_temperature_paths(monkeypatch):
    """Python-float temperatures keep the plain path: the marginal without
    its heat input, the effect and the log-odds bit-equal to the unheated
    formula; a tensor of ones takes the heat variant on every chain and
    gives the float path's chunk within 1e-6."""
    import sbayes_tpu_torch.sampling.operators as ops_mod
    from sbayes_tpu_torch.model.math import normalize
    from sbayes_tpu_torch.ops.marginal import marginal
    from sbayes_tpu_torch.sampling.conditionals import _pick_cluster
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = _small_runtime({"mcmc": {"operators": {"clusters": 1.0, "weights": 1.0,
                                                "source": 1.0}}}, n_clusters=2)
    c = rt.consts
    gen, op_gen = make_generators(2, "cpu")
    states = rt.init_chains(gen, 4)
    fact = ops_mod.OperatorFactory(rt.cond)
    assert fact.unit_T and isinstance(rt.cond.T, float) and isinstance(rt.cond.Tp, float)
    ic = torch.tensor([0, 1, 0, 1])
    odds = fact._cluster_log_odds(states, ic, heat_effect_lh=True)
    hc = rt.post.has_components(states.clusters)
    hc_flip = hc.clone()
    hc_flip[..., 0] = ~hc[..., 0]
    unif = c.unif_conc[None]
    p_eff = normalize(unif + (c.conc_cluster[None] - unif) / 1.0
                      + _pick_cluster(states.cl_counts, ic) / 1.0)
    want = marginal(c, p_eff[:, None].contiguous(),
                    normalize(states.conf_counts + c.conc_conf[None]),
                    states.weights ** (1.0 / 1.0), hc.float(), hc_flip.float(),
                    hc[..., 0].float(), None, ratio=True) / 1.0
    assert torch.equal(odds, want)

    calls = []

    def spy(*args, **kw):
        calls.append(args[7] is not None)
        return marginal(*args, **kw)

    monkeypatch.setattr(ops_mod, "marginal", spy)
    gen, op_gen = make_generators(3, "cpu")
    a, stats_a = rt.run_chunk(gen, op_gen, states, rt.new_stats(4), 40)
    float_calls, calls[:] = list(calls), []
    ones = torch.ones(4)
    gen, op_gen = make_generators(3, "cpu")
    b, stats_b = rt.run_chunk(gen, op_gen, states, rt.new_stats(4), 40, ones, ones)
    assert float_calls and not any(float_calls)
    assert calls and any(calls)
    for name in ("log_lh", "log_prior", "weights"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=1e-6)
    assert torch.equal(a.clusters, b.clusters) and torch.equal(a.source, b.source)
    assert torch.equal(stats_a.accepts, stats_b.accepts)


@pytest.mark.parametrize("exponential", [False, True], ids=["linear", "exponential"])
def test_temperature_ladder_matches_jax_formula(exponential):
    """``temperature_ladder`` against sbayes_tpu/sampling/runner.py:1009-1015."""
    from sbayes_tpu_torch.config.schema import MC3Config
    from sbayes_tpu_torch.sampling.runner import temperature_ladder

    mc3 = MC3Config.from_dict({"activate": True, "chains": 6, "temperature_diff": 0.15,
                               "prior_temperature_diff": 0.4,
                               "exponential_temperatures": exponential})
    chain_idxs = np.arange(mc3.chains)
    if mc3.exponential_temperatures:
        temperatures = (1 + mc3.temperature_diff) ** chain_idxs
        prior_temperatures = (1 + mc3.prior_temperature_diff) ** chain_idxs
    else:
        temperatures = 1 + mc3.temperature_diff * chain_idxs
        prior_temperatures = 1 + mc3.prior_temperature_diff * chain_idxs
    t, tp = temperature_ladder(mc3)
    np.testing.assert_array_equal(t, temperatures)
    np.testing.assert_array_equal(tp, prior_temperatures)
    assert t[0] == tp[0] == 1.0
    same = temperature_ladder(MC3Config.from_dict({"chains": 3, "temperature_diff": 0.2}))
    np.testing.assert_array_equal(same[0], same[1])      # prior diff defaults to the diff


def _jax_swap_phase(ll, lp, T, Tp, pair_a, pair_b, order, us, swap_matrix):
    """numpy float32 transcription of sbayes_tpu/sampling/runner.py:271-305
    (``do_swap`` over ``order``; ``us`` are the log-uniforms)."""
    perm = np.arange(len(ll))
    ll, lp = ll.astype(np.float32).copy(), lp.astype(np.float32).copy()
    T, Tp = T.astype(np.float32), Tp.astype(np.float32)
    swap_matrix = swap_matrix.copy()
    n_acc = 0
    for t in range(len(order)):
        idx = order[t]
        a, b = pair_a[idx], pair_b[idx]
        prior_exp_diff = np.float32(1.0) / Tp[a] - np.float32(1.0) / Tp[b]
        lh_exp_diff = np.float32(1.0) / T[a] - np.float32(1.0) / T[b]
        mh = -((lp[a] - lp[b]) * prior_exp_diff + (ll[a] - ll[b]) * lh_exp_diff)
        accept = np.float32(us[t]) < mh
        pa, pb = perm[a], perm[b]
        perm[a], perm[b] = (pb, pa) if accept else (pa, pb)
        la, lb = ll[a], ll[b]
        ll[a], ll[b] = (lb, la) if accept else (la, lb)
        qa, qb = lp[a], lp[b]
        lp[a], lp[b] = (qb, qa) if accept else (qa, qb)
        swap_matrix[0, a, b] += int(accept)
        swap_matrix[1, a, b] += 1
        n_acc += int(accept)
    return perm, ll, lp, swap_matrix, n_acc


@pytest.mark.parametrize("only_adjacent,attempts", [(False, 100), (True, 100), (False, 4)],
                         ids=["all_pairs", "adjacent", "capped"])
def test_swap_phase_matches_jax_transcription(only_adjacent, attempts):
    """Ten swap phases of a 6-rung ladder on random log-likelihoods and
    log-priors, with the port's pair order and uniforms: perm, the running
    ll / lp, the (2, n, n) matrix and the accept count agree."""
    from sbayes_tpu_torch.sampling.runner import draw_swap_proposals, swap_pairs, swap_phase

    n = 6
    rng = np.random.default_rng(3)
    T = (1 + 0.3 * np.arange(n)).astype(np.float32).astype(np.float64)
    Tp = (1 + 0.5 * np.arange(n)).astype(np.float32).astype(np.float64)
    pairs = swap_pairs(n, only_adjacent)
    assert len(pairs) == (n - 1 if only_adjacent else n * (n - 1) // 2)
    assert all(a < b for a, b in pairs) and (not only_adjacent or all(b == a + 1 for a, b in pairs))
    n_att = min(attempts, len(pairs))
    op_gen = torch.Generator().manual_seed(0)
    got_m = np.zeros((2, n, n), np.int64)
    want_m = got_m.copy()
    total_acc = 0
    for _ in range(10):
        ll = rng.normal(-50, 4, n).astype(np.float32)
        lp = rng.normal(-10, 3, n).astype(np.float32)
        order, log_u = draw_swap_proposals(op_gen, len(pairs), n_att)
        assert len(order) == n_att and len(set(order.tolist())) == n_att
        perm, ll2, lp2, acc = swap_phase(ll, lp, T, Tp, pairs, order, log_u, got_m)
        w_perm, w_ll, w_lp, want_m, w_acc = _jax_swap_phase(
            ll, lp, T, Tp, pairs[:, 0], pairs[:, 1], order, log_u, want_m)
        np.testing.assert_array_equal(perm, w_perm)
        np.testing.assert_array_equal(ll2.astype(np.float32), w_ll)
        np.testing.assert_array_equal(lp2.astype(np.float32), w_lp)
        np.testing.assert_array_equal(ll[perm], w_ll)
        assert acc == w_acc
        total_acc += acc
    np.testing.assert_array_equal(got_m, want_m)
    assert int(got_m[1].sum()) == 10 * n_att and int(got_m[0].sum()) == total_acc
    assert 0 < total_acc < 10 * n_att


def test_swap_phases_fire_at_global_multiples_across_chunks():
    """``run_mc3_chunk`` swaps after every global step that is a multiple of
    ``swap_interval``, wherever the chunks end: chunks of 5 steps from step
    0 to 35 with an interval of 7 make 5 phases; the states stay a
    permutation of the rungs' and each rung keeps its statistics."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = _small_runtime()
    gen, op_gen = make_generators(4, "cpu")
    states = rt.init_chains(gen, 3)
    stats = rt.new_stats(3)
    temps = torch.tensor([1.0, 1.5, 2.0])
    m = np.zeros((2, 3, 3), np.int64)
    n_att = 0
    for step0 in range(0, 35, 5):
        states, stats, acc, att = rt.run_mc3_chunk(gen, op_gen, states, stats, temps, temps, m,
                                                   step0, 5, 7, 2, False)
        assert att == (2 if (step0 + 5) // 7 > step0 // 7 else 0)
        n_att += att
    assert n_att == 5 * 2 and int(m[1].sum()) == n_att
    assert int((stats.accepts + stats.rejects).sum(1).max()) == 35
    ref = rt.refresh(states)
    torch.testing.assert_close(states.log_lh, ref.log_lh, rtol=1e-5, atol=1e-4)


def test_mc3_cli_sample_cadence_independent_of_swaps(tmp_path):
    """The analogue of tests/test_e2e.py:176 through the port's CLI: a swap
    interval (50) longer than the logging interval (20) still gives all 10
    samples, with sample ids 20..200, and the rungs' files beside them."""
    import shutil

    from sbayes_tpu_torch.cli import main
    from sbayes_tpu_torch.results.results import Results

    for f in ("config.yaml", "features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / f, tmp_path / f)
    settings = {"results": {"path": str(tmp_path / "results"), "log_likelihood": False},
                "mcmc": {"steps": 200, "samples": 10,
                         "warmup": {"warmup_steps": 10, "warmup_chains": 2},
                         "mc3": {"activate": True, "chains": 2, "swap_interval": 50,
                                 "temperature_diff": 0.2}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(tmp_path / "config.yaml", experiment_name="mc3cadence", custom_settings=settings,
             device="cpu")
    out = tmp_path / "results" / "mc3cadence" / "K1"
    res = Results.from_csv_files(out / "clusters_K1_0.txt", out / "stats_K1_0.txt", burn_in=0.0)
    assert list(res.sample_id) == list(range(20, 201, 20))
    hot = Results.from_csv_files(out / "hot_chains" / "clusters_K1_0.chain1.txt",
                                 out / "hot_chains" / "stats_K1_0.chain1.txt", burn_in=0.0)
    assert list(hot.sample_id) == list(range(20, 201, 20))
    assert np.loadtxt(out / "mc3_swaps_K1_0.txt").shape == (2, 2)


def test_warmup_ladder_best_of_w_per_rung():
    """The analogue of tests/test_parallel.py:152: with no warm-up steps the
    ladder keeps, per rung, the argmax by log-likelihood of its W
    initializations (the same init grid from the same generator), and the
    rungs keep distinct initializations; with steps it returns one finite
    state per rung."""
    from sbayes_tpu_torch.sampling.runner import make_generators

    rt = _small_runtime({"mcmc": {"initialization": {"objects_per_cluster": 2}}})
    n_chains, W = 3, 4
    temps = 1.0 + 0.2 * torch.arange(n_chains, dtype=torch.float32)
    gen, op_gen = make_generators(21, "cpu")
    picked = rt.warmup_ladder(gen, op_gen, n_chains, W, temps, temps, n_steps=0)
    assert picked.n_chains == n_chains
    gen, _ = make_generators(21, "cpu")
    grid = rt.init_chains(gen, n_chains * W)
    ll = _np(grid.log_lh).reshape(n_chains, W)
    sel = ll.argmax(axis=1) + np.arange(n_chains) * W
    np.testing.assert_array_equal(_np(picked.log_lh), _np(grid.log_lh)[sel])
    np.testing.assert_array_equal(_np(picked.clusters), _np(grid.clusters)[sel])
    flat = _np(grid.clusters).reshape(n_chains * W, -1)
    assert len({r.tobytes() for r in flat}) > 1
    gen, op_gen = make_generators(22, "cpu")
    picked2 = rt.warmup_ladder(gen, op_gen, n_chains, 2, temps, temps, n_steps=10)
    assert picked2.n_chains == n_chains and bool(torch.isfinite(picked2.log_lh).all())


def test_swap_phase_preserves_a_product_of_tempered_distributions():
    """Toy ladder: 3 rungs over 4 states, rung r targets exp(ll(x) / T_r +
    lp(x) / Tp_r). 20000 ladders drawn from the product of the rung targets
    go through one swap phase (all three pairs, random order); every rung's
    marginal must still be its target (binomial test per rung and state at
    p > 0.005). A rule that swaps regardless moves the cold rung's mass."""
    from sbayes_tpu_torch.sampling.runner import draw_swap_proposals, swap_pairs, swap_phase

    ll_x = np.array([-1.0, -4.0, -7.0, -2.5])
    lp_x = np.array([-3.0, -0.5, -1.0, -6.0])
    T = np.array([1.0, 2.0, 4.0])
    Tp = np.array([1.0, 1.5, 3.0])
    logits = ll_x[None] / T[:, None] + lp_x[None] / Tp[:, None]
    target = np.exp(logits - logits.max(1, keepdims=True))
    target /= target.sum(1, keepdims=True)
    rng = np.random.default_rng(0)
    n_ladders = 20000
    x = np.stack([rng.choice(4, n_ladders, p=target[r]) for r in range(3)], axis=1)
    pairs = swap_pairs(3, False)
    op_gen = torch.Generator().manual_seed(1)
    m = np.zeros((2, 3, 3), np.int64)
    for i in range(n_ladders):
        order, log_u = draw_swap_proposals(op_gen, len(pairs), len(pairs))
        perm, _, _, _ = swap_phase(ll_x[x[i]], lp_x[x[i]], T, Tp, pairs, order, log_u, m)
        x[i] = x[i][perm]
    assert 0 < m[0].sum() < m[1].sum()
    for r in range(3):
        for s in range(4):
            pv = binomtest(int((x[:, r] == s).sum()), n_ladders, target[r, s]).pvalue
            assert pv > 0.005, f"rung {r}, state {s}: {(x[:, r] == s).mean()} vs {target[r, s]}"


def test_cold_rung_keeps_the_prior_under_swaps():
    """512 ladders of three rungs sample the prior (uniform size prior, K =
    1, the 5-object fixture, cluster operators only) at prior temperatures
    1, 3 and 5 with a swap phase every 10 steps. The cold rung must draw
    each allowed size 1..5 with probability 1/5 (binomial tests at p >
    0.005). The hot rungs are biased (the tempered size and source priors
    favour the middle and large sizes), so a swap rule that ignores the
    temperatures biases the cold rung."""
    from sbayes_tpu_torch.sampling.runner import (
        draw_swap_proposals,
        make_generators,
        swap_pairs,
        swap_phase,
    )

    rt = _small_runtime({"model": {"prior": {"objects_per_cluster": {
        "type": "uniform_size", "min": 1, "max": 5}}},
        "mcmc": {"sample_from_prior": True,
                 "operators": {"clusters": 1.0, "weights": 0.0, "source": 0.0}}})
    n_ladders, n_rungs = 512, 3
    B = n_ladders * n_rungs
    tp = torch.tensor([1.0, 3.0, 5.0]).repeat(n_ladders)
    ones = torch.ones(B)
    gen, op_gen = make_generators(9, "cpu")
    states = rt.init_chains(gen, B)
    stats = rt.new_stats(B)
    pairs = swap_pairs(n_rungs, False)
    m = np.zeros((2, n_rungs, n_rungs), np.int64)
    tp_host = np.array([1.0, 3.0, 5.0])
    for _ in range(40):
        states, stats = rt.run_chunk(gen, op_gen, states, stats, 10, ones, tp)
        lp = _np(states.log_prior).reshape(n_ladders, n_rungs)
        perm = np.arange(B).reshape(n_ladders, n_rungs)
        for i in range(n_ladders):
            order, log_u = draw_swap_proposals(op_gen, len(pairs), len(pairs))
            p, _, _, _ = swap_phase(np.zeros(n_rungs), lp[i], np.ones(n_rungs), tp_host, pairs,
                                    order, log_u, m)
            perm[i] = perm[i][p]
        states = states.select(torch.as_tensor(perm.reshape(-1)))
    assert int(stats.non_finite.sum()) == 0
    assert 0 < m[0].sum() < m[1].sum()
    sizes = _np(states.clusters.sum(-1)[:, 0]).reshape(n_ladders, n_rungs)
    for k in range(1, 6):
        pv = binomtest(int((sizes[:, 0] == k).sum()), n_ladders, 0.2).pvalue
        assert pv > 0.005, f"cold rung size {k}: {(sizes[:, 0] == k).mean():.3f} vs 0.2"
    # the hottest rung is biased: it draws size 1 far less often than 1/5
    assert binomtest(int((sizes[:, 2] == 1).sum()), n_ladders, 0.2).pvalue < 1e-6
