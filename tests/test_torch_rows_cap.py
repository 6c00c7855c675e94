"""The wide operator's rows cap in the port (``wide_rows_cap_rule``,
``OperatorFactory(wide_rows_cap=)``) against the JAX package
(``SBAYES_TPU_WIDE_ROWS_CAP``): the rule, the automatic rejection of a move
that changes more objects than the cap, forward and back, and stationarity
under the prior with a small cap, as tests/test_operator_stationarity.py:67
checks it for the JAX package.

Tolerances: log_q / log_q_back of moves within the cap rtol 1e-4, atol 1e-4
(tests/test_torch_operators.py); the stationarity check is a binomial test
per object at p > 0.005."""
from types import SimpleNamespace

import numpy as np
import pytest
from scipy.stats import binomtest

import jax
import jax.numpy as jnp
import torch

from test_torch_operators import _cluster_state, bounded, forced_draws  # noqa: F401
from test_torch_posterior_ops import RTOL_PROPOSAL, _np

ATOL_LOG_Q = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [5, 12, 1024, 1025, 4000, 8192, 10_000, 50_000])
def test_cap_rule_equals_jax(monkeypatch, n):
    from sbayes_tpu.sampling.operators import OperatorFactory as JaxFactory
    from sbayes_tpu_torch.sampling.operators import wide_rows_cap_rule

    monkeypatch.delenv("SBAYES_TPU_WIDE_ROWS_CAP", raising=False)
    cond = SimpleNamespace(consts=SimpleNamespace(N=n), T=1.0, Tp=1.0, sample_from_prior=False)
    assert wide_rows_cap_rule(n) == JaxFactory(cond).wide_rows_cap
    assert wide_rows_cap_rule(10_000) == 625 and wide_rows_cap_rule(1024) == 1024


def test_cap_argument_overrides_the_rule(bounded):  # noqa: F811
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    cond = bounded["cond"]
    assert OperatorFactory(cond).wide_rows_cap == cond.consts.N      # N <= 1024: no cap
    assert OperatorFactory(cond, wide_rows_cap=3).wide_rows_cap == 3
    assert OperatorFactory(cond, wide_rows_cap=10 ** 6).wide_rows_cap == cond.consts.N


def _wide_move(bounded, forced, members, target, cap, monkeypatch):  # noqa: F811
    """The wide move from cluster ``members`` to ``target`` (forced draws) in
    both packages at the cap ``cap``: (port result, JAX result)."""
    from sbayes_tpu.sampling.operators import OperatorFactory as JaxFactory
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    monkeypatch.setenv("SBAYES_TPU_WIDE_ROWS_CAP", str(cap))
    jstate, state = _cluster_state(bounded, members)
    forced["u_objects"] = np.where(target, 0.0, 1.0).astype(np.float32)
    jres = JaxFactory(bounded["jcond"]).make_alter_cluster_wide(consider_geo=False)(
        jax.random.PRNGKey(0), jstate)
    res = OperatorFactory(bounded["cond"], wide_rows_cap=cap).make_alter_cluster_wide()(
        torch.Generator().manual_seed(0), state)
    np.testing.assert_array_equal(_np(res.state.clusters)[0, 0], target)
    if len(set(members) ^ set(np.flatnonzero(target))) <= cap:
        # (a rejected JAX result carries the old state)
        np.testing.assert_array_equal(np.asarray(jres.state.clusters)[0], target)
    return res, jres


@pytest.mark.parametrize("cap", [3, 4])
def test_moves_above_the_cap_are_rejected_both_ways(  # noqa: F811
        bounded, forced_draws, monkeypatch, cap):
    """A move that changes 4 objects (2 out, 2 in) at a cap of 3 is rejected
    (log_q 0, log_q_back -inf; its flip count still 4), and so is its
    reverse; at a cap of 4 both moves are proposals as without a cap, with
    JAX's log_q and log_q_back. A move of 2 objects is never capped here."""
    N = bounded["cond"].consts.N
    members = np.arange(0, 12, 3)
    start = np.zeros(N, bool)
    start[members] = True
    far = start.copy()
    far[members[:2]] = False
    far[[1, 2]] = True                                                # 2 out, 2 in
    near = start.copy()
    near[members[0]] = False
    near[1] = True                                                    # 1 out, 1 in
    for src, dst in ((start, far), (far, start), (start, near)):
        res, jres = _wide_move(bounded, forced_draws, np.flatnonzero(src), dst, cap,
                               monkeypatch)
        m = int((src != dst).sum())
        assert float(_np(res.step_size)[0]) == m == float(jres.step_size)
        if m > cap:
            assert float(_np(res.log_q)[0]) == 0.0 == float(jres.log_q)
            assert np.isneginf(float(_np(res.log_q_back)[0])) and np.isneginf(
                float(jres.log_q_back))
            continue
        for name in ("log_q", "log_q_back"):
            got, want = float(_np(getattr(res, name))[0]), float(getattr(jres, name))
            assert np.isfinite(got) and np.isfinite(want), name
            np.testing.assert_allclose(got, want, rtol=RTOL_PROPOSAL, atol=ATOL_LOG_Q,
                                       err_msg=name)


def test_wide_cap_truncation_is_stationary():
    """The wide operator alone at a cap of 3 of 12 objects under the prior
    (K = 2, uniform geo prior): many proposals change more than 3 objects
    and are rejected, a symmetric truncation, so the per-object membership
    frequencies of 512 chains after 300 steps stay the prior's (4000 prior
    samples). Binomial test per object at p > 0.005."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.model.posterior import Posterior
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.kernel import OperatorStats, make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec
    from sbayes_tpu_torch.sampling.prior_sampling import (
        generate_prior_sample, generate_prior_samples)
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=12, n_features=4, n_states=3, n_families=2, seed=11)
    model = Model(data, synthetic_config(n_clusters=2, geo_prior="uniform").model, device="cpu")
    cond = Conditionals(Posterior(model.consts, sample_from_prior=True))
    factory = OperatorFactory(cond, wide_rows_cap=3)
    wide = factory.make_alter_cluster_wide()
    apply = make_mh_apply_fn(cond, [OperatorSpec("wide", 1.0, wide, "clusters")])
    gen = torch.Generator().manual_seed(42)
    n_chains = 512
    states = cond.post.fill_state(generate_prior_sample(gen, cond, n_chains))
    flips = torch.cat([wide(gen, states).step_size for _ in range(4)])
    assert float((flips > 3).float().mean()) > 0.2, "the cap never binds: the test is vacuous"
    stats = OperatorStats.zeros(n_chains, 1, "cpu")
    for _ in range(300):
        states, accept, step_size, nf = apply(0, gen, states)
        stats = stats.record(0, accept, step_size, nf)
    assert int(stats.non_finite.sum()) == 0
    assert int(stats.accepts.sum()) > 200 * n_chains // 10, "the wide operator stopped mixing"
    member = states.clusters.any(1).numpy()
    p_ref = generate_prior_samples(torch.Generator().manual_seed(5), cond, 4000
                                   ).clusters.any(1).float().mean(0).numpy()
    failures = []
    for o in range(member.shape[1]):
        p = float(np.clip(p_ref[o], 1e-9, 1 - 1e-9))
        pv = binomtest(int(member[:, o].sum()), n_chains, p).pvalue
        if pv <= 0.005:
            failures.append(f"object {o}: mcmc={member[:, o].mean():.3f} prior={p:.3f}")
    assert not failures, "wide-cap stationarity violations:\n" + "\n".join(failures)


@pytest.mark.parametrize("n_set", [0, 37, 625, 700])
def test_compact_indices_at_the_scale_shape(n_set):
    """``compact_indices`` in its padded form at N = 10,000 and the cap's 625
    columns (where the JAX package switches to ``jnp.nonzero``): the
    ascending indices of the set entries, padded with N; more set entries
    than columns keep the first 625 (the operator rejects such a move)."""
    from sbayes_tpu.model.math import compact_indices as jax_compact
    from sbayes_tpu_torch.model.math import compact_indices

    N, cap = 10_000, 625
    rng = np.random.default_rng(n_set)
    mask = np.zeros((2, N), bool)
    for row in mask:
        row[rng.choice(N, n_set, replace=False)] = True
    got = compact_indices(torch.as_tensor(mask), cap, N).numpy()
    for b in range(2):
        want = np.full(cap, N)
        idx = np.flatnonzero(mask[b])[:cap]
        want[:idx.size] = idx
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(got[b], np.asarray(jax_compact(jnp.asarray(mask[b]),
                                                                     cap, N)))
