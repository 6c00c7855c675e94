"""The operators no schedule draws, in the port against the JAX package on
the CPU: the cluster-effect proposals (gibbs, residual, residual_counts),
``expected_confounder_features``, the membership log-odds under each effect
(unit temperatures, and per chain at MC3 temperatures with the wide
operator's heat), the wide operator's proposal probabilities under each
effect and its EM proposal (``consider_geo`` off and on), and
``make_alter_weights`` under forced draws. Then statistical checks, since the
random streams differ: the EM wide, the residual wide and the weights move,
each in a schedule with the source and weights operators, reach the
membership frequencies and weight means of the default schedule.

One numpy state goes into both packages (``ChainState.from_numpy``). The
JAX side runs its XLA path (the residual effects have no other); the port's
marginal runs its plain version on these CPU tensors.

Tolerances: effects, expected features and proposal probabilities rtol
1e-4, atol 1e-5 (float32 sums in another order, the EM's ten softmax steps);
log-odds rtol = atol = 2e-4 (sums of F logs, as tests/test_torch_mc3.py);
alter_weights' log densities 1e-5 absolute; the statistical checks two-sided
p > 1e-3 per object and per weight (two-proportion and Welch z tests)."""
import numpy as np
import pytest
from scipy.stats import norm

import jax
import jax.numpy as jnp
import torch

from test_torch_jump import jump_pair
from test_torch_mc3 import FIXTURES, TOL_ODDS, ladder_pair
from test_torch_posterior_ops import _np

TOL = dict(rtol=1e-4, atol=1e-5)
EFFECTS = ["gibbs", "residual", "residual_counts"]
P_MIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """Both packages' K = 2 and K = 3 models (24 objects x 8 features,
    cost-based geo prior) and one filled state each, built once."""
    with pytest.MonkeyPatch.context() as mp:
        return {k: jump_pair(mp, k, 8, geo="cost_based") for k in (2, 3)}


@pytest.fixture(scope="module")
def ladder():
    """Three chains at the MC3 temperatures of tests/test_torch_mc3.py."""
    with pytest.MonkeyPatch.context() as mp:
        return ladder_pair(mp)


def _avail(state, i_cluster):
    """(N,) objects free or in cluster ``i_cluster`` of chain 0 (numpy)."""
    cl = _np(state.clusters)[0]
    return ~cl.any(0) | cl[i_cluster]


@pytest.mark.parametrize("effect", EFFECTS)
@pytest.mark.parametrize("k", [2, 3])
def test_effect_proposals_match_jax(pairs, effect, k):
    p = pairs[k]
    js, s = p["jstate"], p["state"]
    want = getattr(p["jfact"], f"cluster_effect_proposal_{effect}")(
        js, js.cl_counts, js.conf_counts, 1)
    got = getattr(p["fact"], f"cluster_effect_proposal_{effect}")(
        s, s.cl_counts, s.conf_counts, torch.tensor([1]))
    assert got.shape == (1,) + tuple(np.shape(want))
    np.testing.assert_allclose(_np(got)[0], np.asarray(want), **TOL)


def test_expected_confounder_features_per_chain_match_jax(ladder):
    p = ladder
    s = p["state"]
    got = _np(p["cond"].expected_confounder_features(s.clusters, s.weights, s.conf_counts))
    for b, (jc, js) in enumerate(zip(p["jconds"], p["jstates"])):
        want = jc.expected_confounder_features(js.clusters, js.weights, js.conf_counts)
        np.testing.assert_allclose(got[b], np.asarray(want), err_msg=f"chain {b}", **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nanquantile_rows_matches_numpy(seed):
    """The per-chain quantile of ``residual_counts``: one sort per row,
    against ``np.nanquantile`` row by row (rows without a valid entry: NaN)."""
    from sbayes_tpu_torch.sampling.operators import _nanquantile_rows

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(7, 30)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = np.nan
    x[3] = np.nan
    x[5, 1:] = np.nan
    q = rng.random(7).astype(np.float32)
    q[0], q[1] = 0.0, 1.0
    got = _np(_nanquantile_rows(torch.as_tensor(x), torch.as_tensor(q)))
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = np.array([np.nanquantile(r, qq) for r, qq in zip(x, q)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isnan(got[3])


@pytest.mark.parametrize("effect", EFFECTS)
@pytest.mark.parametrize("heat", [False, True], ids=["noheat", "heat"])
def test_cluster_log_odds_per_chain_match_jax(ladder, effect, heat):
    """The membership log-odds of cluster 1 under each effect, per chain at
    the MC3 temperatures: the kernel's ratio form, and with the wide
    operator's ``heat_effect_lh`` its heat variant with each chain's 1/T."""
    p = ladder
    got = _np(p["fact"]._cluster_log_odds(p["state"], torch.tensor([1, 1, 1]),
                                          heat_effect_lh=heat, effect_proposal=effect))
    avail = jnp.ones(p["jm"].consts.N, bool)
    for b, (jf, js) in enumerate(zip(p["jfacts"], p["jstates"])):
        jf._pm_cache = None
        want = jf._cluster_log_odds(js, 1, avail, effect_proposal=effect,
                                    counts=(js.cl_counts, js.conf_counts), heat_effect_lh=heat)
        np.testing.assert_allclose(got[b], np.asarray(want), err_msg=f"chain {b}", **TOL_ODDS)


@pytest.mark.parametrize("effect", EFFECTS)
@pytest.mark.parametrize("geo", [False, True], ids=["nogeo", "geo"])
def test_wide_proposal_probabilities_match_jax(pairs, effect, geo):
    p = pairs[2]
    js, s = p["jstate"], p["state"]
    eps = 0.01 / p["jm"].consts.N
    avail = _avail(s, 0)
    want = p["jfact"]._make_wide_cluster_probs(geo, 0.15, eps, 2.0, effect)(
        js, 0, jnp.asarray(avail), (js.cl_counts, js.conf_counts))
    got = p["fact"]._make_wide_cluster_probs(0.15, eps, geo, 2.0, effect)(
        s, torch.tensor([0]), torch.as_tensor(avail)[None], (s.cl_counts, s.conf_counts))
    np.testing.assert_allclose(_np(got)[0], np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("geo", [False, True], ids=["nogeo", "geo"])
def test_em_proposal_probabilities_match_jax(pairs, geo, k):
    p = pairs[k]
    js, s = p["jstate"], p["state"]
    eps = 0.01 / p["jm"].consts.N
    avail = _avail(s, 1)
    want = p["jfact"]._make_em_cluster_probs(geo, 0.15, eps, 10)(
        js, 1, jnp.asarray(avail), (js.cl_counts, js.conf_counts))
    got = p["fact"]._make_em_cluster_probs(geo, 0.15, eps, 10)(
        s, torch.tensor([1]), torch.as_tensor(avail)[None], (s.cl_counts, s.conf_counts))
    assert float(_np(got)[0][~avail].max(initial=0.0)) == 0.0
    np.testing.assert_allclose(_np(got)[0], np.asarray(want), **TOL)


@pytest.mark.parametrize("feature,pair,draw", [(3, (0, 2), (0.3, 0.7)),
                                               (0, (2, 1), (0.999999999, 1e-9))])
def test_alter_weights_matches_jax_under_forced_draws(monkeypatch, pairs, feature, pair, draw):
    """The feature, the ordered component pair and the Dirichlet draw forced
    in both packages: the new weights, log_q and log_q_back agree (the second
    case is clipped to [1e-7, 1 - 1e-7])."""
    import sbayes_tpu_torch.sampling.operators as ops_mod

    p = pairs[2]
    C = p["jm"].consts.C
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.int32(feature))
    monkeypatch.setattr(jax.random, "permutation", lambda key, k: jnp.asarray(
        list(pair) + [i for i in range(int(k)) if i not in pair]))
    monkeypatch.setattr(jax.random, "dirichlet", lambda key, alpha: jnp.asarray(draw, jnp.float32))
    monkeypatch.setattr(torch, "randint", lambda lo, hi, size, **kw: torch.full(size, feature))
    monkeypatch.setattr(ops_mod, "_random_cluster_pair", lambda gen, n, k, device: (
        torch.full((n,), pair[0]), torch.full((n,), pair[1])))
    monkeypatch.setattr(torch, "_standard_gamma",
                        lambda alpha, generator=None: torch.tensor([draw], dtype=alpha.dtype))
    jres = p["jfact"].make_alter_weights()(jax.random.PRNGKey(0), p["jstate"])
    res = p["fact"].make_alter_weights()(torch.Generator().manual_seed(0), p["state"])
    np.testing.assert_allclose(_np(res.state.weights)[0], np.asarray(jres.state.weights),
                               rtol=1e-6, atol=1e-7)
    changed = _np(res.state.weights)[0] != _np(p["state"].weights)[0]
    assert set(zip(*np.nonzero(changed))) <= {(feature, c) for c in range(C)}
    for name in ("log_q", "log_q_back", "step_size"):
        np.testing.assert_allclose(float(_np(getattr(res, name))[0]), float(getattr(jres, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ----------------------------------------------------------------------
# Statistical checks on the fixture data (5 objects, cost-based geo prior)
# ----------------------------------------------------------------------

N_CHAINS, N_STEPS = 640, 200


@pytest.fixture(scope="module")
def fixture_runtime():
    import warnings

    from sbayes_tpu_torch.config.schema import SBayesConfig
    from sbayes_tpu_torch.data.loader import Data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = SBayesConfig.from_config_file(FIXTURES / "config.yaml", {})
    return SamplerRuntime(Model(Data.from_config(cfg), cfg.model, device="cpu"), cfg.mcmc)


def run_schedule(rt, specs, seed, ops=None):
    """``N_STEPS`` MH steps of ``N_CHAINS`` chains from the initializer, one
    operator of ``specs`` (drawn by weight, or the given ``ops``) per step,
    as ``run_chunk`` does. Returns the final states and the acceptance rate
    of each operator."""
    from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn
    from sbayes_tpu_torch.sampling.runner import make_generators

    gen, op_gen = make_generators(seed, "cpu")
    states = rt.init_chains(gen, N_CHAINS)
    stats = OperatorStats.zeros(N_CHAINS, len(specs), "cpu")
    apply = make_mh_apply_fn(rt.cond, specs)
    weights = torch.tensor([s.weight for s in specs], dtype=torch.float64)
    if ops is None:
        ops = torch.multinomial(weights, N_STEPS, replacement=True, generator=op_gen).tolist()
    for op in ops:
        states, accept, step_size, nf = apply(op, gen, states)
        stats = stats.record(op, accept, step_size, nf)
    assert int(stats.non_finite.sum()) == 0
    tried = (stats.accepts + stats.rejects).sum(0)
    return states, (stats.accepts.sum(0) / tried.clamp(min=1)).tolist()


@pytest.fixture(scope="module")
def default_run(fixture_runtime):
    from sbayes_tpu_torch.sampling.operators import get_operator_schedule

    rt = fixture_runtime
    return run_schedule(rt, get_operator_schedule(rt.cond, rt.mcmc_config.operators), 1)[0]


@pytest.fixture(scope="module")
def wide_run(fixture_runtime):
    """The schedule with the plain wide operator (the Gibbs effect, geo
    weighted) as the only cluster operator."""
    from sbayes_tpu_torch.sampling.operators import (
        OperatorFactory, OperatorSpec, get_operator_schedule)

    rt = fixture_runtime
    wide = OperatorFactory(rt.cond).make_alter_cluster_wide(True)
    rest = [s for s in get_operator_schedule(rt.cond, rt.mcmc_config.operators)
            if s.changes != "clusters"]
    return run_schedule(rt, [OperatorSpec("wide", 1.0, wide)] + rest, 1)[0]


def assert_same_posterior(states, ref):
    """Membership frequency of every object (two-proportion z test) and the
    mean of every weight (Welch z test), p > P_MIN each."""
    failures = []
    a, b = _np(states.clusters.any(1)).astype(float), _np(ref.clusters.any(1)).astype(float)
    pooled = (a.mean(0) + b.mean(0)) / 2
    z = (a.mean(0) - b.mean(0)) / np.sqrt(np.maximum(pooled * (1 - pooled), 1e-12) * 2 / len(a))
    failures += [f"object {o}: {a.mean(0)[o]:.3f} vs {b.mean(0)[o]:.3f}"
                 for o in np.flatnonzero(2 * norm.sf(np.abs(z)) <= P_MIN)]
    wa, wb = _np(states.weights), _np(ref.weights)
    se = np.sqrt(wa.var(0, ddof=1) / len(wa) + wb.var(0, ddof=1) / len(wb))
    zw = (wa.mean(0) - wb.mean(0)) / np.maximum(se, 1e-12)
    failures += [f"weight {fc}: {wa.mean(0)[fc]:.3f} vs {wb.mean(0)[fc]:.3f}"
                 for fc in zip(*np.nonzero(2 * norm.sf(np.abs(zw)) <= P_MIN))]
    assert not failures, "differs from the default schedule:\n" + "\n".join(failures)


@pytest.mark.parametrize("variant", ["em", "residual", "residual_counts"])
def test_wide_variants_sample_the_default_posterior(fixture_runtime, wide_run, variant):
    """The wide operator with the EM or a residual-effect proposal (geo
    weighted, as the fixture's prior is cost-based) as the only cluster
    operator, beside the source and weights operators of the schedule,
    against the same schedule with the plain wide operator. (Not against the
    default schedule: its grow/shrink operators follow the JAX package's
    rule, which samples the bound sizes at half their probability, ROADMAP
    C.1, and every wide operator stops redrawing after 100 draws, which
    over-weights the full cluster, C.8; both move the weights' means.)"""
    from sbayes_tpu_torch.sampling.operators import (
        OperatorFactory, OperatorSpec, get_operator_schedule)

    rt = fixture_runtime
    fact = OperatorFactory(rt.cond)
    wide = (fact.make_alter_cluster_wide(True, em_proposal=True) if variant == "em"
            else fact.make_alter_cluster_wide(True, effect_proposal=variant))
    rest = [s for s in get_operator_schedule(rt.cond, rt.mcmc_config.operators)
            if s.changes != "clusters"]
    states, acc = run_schedule(rt, [OperatorSpec(variant, 1.0, wide)] + rest, 2)
    assert 0.05 < acc[0] < 0.95
    assert_same_posterior(states, wide_run)


def test_default_schedule_samples_the_jax_posterior(fixture_runtime):
    """The default schedule (the JAX rule of grow/shrink, ROADMAP C.1, and
    the wide operator's redraw limit, C.8, included) against the JAX
    package's default schedule on the fixture, each from its own initial
    states, both on the same operator draws: membership of every object and
    mean of every weight, p > P_MIN each, as the wide variants are held
    against the plain wide operator above."""
    import warnings

    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.data.loader import Data as JaxData
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.model.posterior import Posterior as JaxPosterior
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxConditionals
    from sbayes_tpu.sampling.kernel import make_mh_apply_fn as jax_mh_apply_fn
    from sbayes_tpu.sampling.operators import get_operator_schedule as jax_schedule
    from sbayes_tpu.sampling.runner import SamplerRuntime as JaxRuntime
    from sbayes_tpu_torch.sampling.operators import get_operator_schedule

    rt = fixture_runtime
    specs = get_operator_schedule(rt.cond, rt.mcmc_config.operators)
    w = np.array([s.weight for s in specs])
    ops = np.random.default_rng(4).choice(len(specs), size=N_STEPS, p=w / w.sum()).tolist()
    states, _ = run_schedule(rt, specs, 4, ops)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = JaxConfig.from_config_file(FIXTURES / "config.yaml", custom_settings={})
    jrt = JaxRuntime(JaxModel(JaxData.from_config(cfg), cfg.model), cfg.mcmc)
    cond = JaxConditionals(JaxPosterior(jrt.consts, False), 1.0, 1.0)
    jspecs = jax_schedule(cond, cfg.mcmc.operators)
    assert [s.name for s in jspecs] == [s.name for s in specs]
    np.testing.assert_allclose([s.weight for s in jspecs], w, rtol=1e-6)
    apply = jax.jit(jax.vmap(jax_mh_apply_fn(cond, jspecs), in_axes=(None, 0, 0)))
    jstates = jrt.init_chains(jax.random.PRNGKey(4), N_CHAINS, shard=False)
    key = jax.random.PRNGKey(5)
    for op in ops:
        key, k = jax.random.split(key)
        jstates = apply(op, jax.random.split(k, N_CHAINS), jstates)[0]
    assert_same_posterior(states, jstates)


def test_alter_weights_samples_the_default_posterior(fixture_runtime, default_run):
    """``make_alter_weights`` added to the default schedule, on more steps
    than the weights Gibbs step (alone it mixes too slowly for this run)."""
    from sbayes_tpu_torch.sampling.operators import (
        OperatorFactory, OperatorSpec, get_operator_schedule)

    rt = fixture_runtime
    specs = get_operator_schedule(rt.cond, rt.mcmc_config.operators)
    specs.append(OperatorSpec("alter_weights", 0.4, OperatorFactory(rt.cond).make_alter_weights(),
                              "weights"))
    states, acc = run_schedule(rt, specs, 3)
    assert 0.05 < acc[-1] < 1.0
    assert_same_posterior(states, default_run)
