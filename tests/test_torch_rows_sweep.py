"""The exact sequential source sweep of the port (``op_rows_sweep``: one
object after the other from its leave-self-out conditional) against the JAX
package's, at F = 512 features, where the rule chooses it, on 12 objects.

Tolerances: the conditionals of every sub-step rtol 1e-5, atol 1e-7 (float32
normalisations of the same counts; the JAX scan runs eagerly under
``jax.disable_jit`` so that each sub-step's conditional can be read);
counts are exact integers (equal); the log-likelihood change of a sweep
rtol 1e-5, atol 1e-3 (a sum of 12 x 512 logs in float32). The draws are
held against the conditional by a chi-square goodness-of-fit test at
p > 0.005."""
import numpy as np
import pytest
from scipy.stats import chi2

import jax
import jax.numpy as jnp
import torch

from test_torch_posterior_ops import _np, numpy_state

KW = dict(n_objects=12, n_features=512, n_states=3, n_families=2, seed=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Both packages' model (K = 2, uniform geo prior) and conditionals, and
    a numpy batch of two chains."""
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    jm = JaxModel(jax_data(**KW), jax_config(n_clusters=2, geo_prior="uniform").model)
    m = Model(synthetic_data(**KW), synthetic_config(n_clusters=2, geo_prior="uniform").model,
              device="cpu")
    c = m.consts
    ds = [numpy_state(c.K, c.N, c.F, c.C, c.na.numpy(), seed=s) for s in (3, 4)]
    d = {k: np.stack([x[k] for x in ds]) for k in ds[0]}
    # each cell's component among those available to its object (a finite prior)
    rng = np.random.default_rng(8)
    avail = np.concatenate([d["clusters"].any(1)[..., None],
                            np.broadcast_to(c.hc_conf.numpy(), (2, c.N, c.C - 1))], axis=-1)
    comp = (rng.random((2, c.N, c.F, c.C)) * avail[:, :, None]).argmax(-1)
    d["source"] = (comp[..., None] == np.arange(c.C)) & ~c.na.numpy()[None, :, :, None]
    return JaxCond(jm.posterior), Conditionals(m.posterior), d


def _state(cond, d):
    from sbayes_tpu_torch.sampling.state import ChainState

    return cond.post.fill_state(ChainState.from_numpy(d))


def test_the_rule_chooses_the_sweep_at_512_features(models):
    from sbayes_tpu_torch.sampling.operators import (
        OperatorFactory, get_operator_schedule, source_sweep_rule)
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.model.posterior import Posterior
    from sbayes_tpu_torch.testing import synthetic_config

    _, cond, _ = models
    assert source_sweep_rule(512) and not source_sweep_rule(511)
    assert OperatorFactory(cond).source_sweep
    assert not OperatorFactory(cond, source_sweep=False).source_sweep
    specs = {s.name: s for s in get_operator_schedule(
        cond, synthetic_config(n_clusters=2).mcmc.operators)}
    for name in ("gibbs_sample_sources", "gibbs_sample_sources_groups"):
        assert specs[name].fn.__name__ == "op_rows_sweep"
    assert not any(s.fn.__name__ == "op_rows_sweep" for n, s in specs.items()
                   if "sources" not in n)
    prior = Conditionals(Posterior(cond.consts, sample_from_prior=True))
    op = OperatorFactory(prior).make_gibbs_sample_source("random_subset", 20)
    assert op.__name__ == "op_rows"


def test_sweep_conditionals_match_jax(models, monkeypatch):
    """All 12 objects swept in the order 0..11 in both packages, each draw
    forced to the most probable component: the conditional of every
    sub-step, the new rows, the carried counts and the log-likelihood
    change equal JAX's."""
    import sbayes_tpu.sampling.operators as jax_ops
    import sbayes_tpu_torch.sampling.operators as ops_mod
    from sbayes_tpu.sampling.operators import OperatorFactory as JaxFactory
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    jcond, cond, d = models
    N = cond.consts.N
    seen = {"jax": [], "torch": []}

    def jax_argmax(key, p):
        seen["jax"].append(np.asarray(p))
        return jnp.arange(p.shape[-1]) == jnp.argmax(p, -1)[..., None]

    def torch_argmax(gen, p):
        seen["torch"].append(p.numpy().copy())
        return torch.nn.functional.one_hot(p.argmax(-1), p.shape[-1]).bool()

    torch_rand = torch.rand

    def ordered_rand(*size, **kw):                   # the subset's order: 0..N-1
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        if shape == (2, N):
            return torch.arange(N, dtype=torch.float32).expand(2, N) / N
        return torch_rand(*size, **kw)

    monkeypatch.setattr(jax_ops, "sample_categorical_onehot", jax_argmax)
    monkeypatch.setattr(ops_mod, "sample_categorical_onehot", torch_argmax)
    monkeypatch.setattr(jax.random, "choice", lambda key, n, shape, replace: jnp.arange(shape[0]))
    monkeypatch.setattr(torch, "rand", ordered_rand)

    state = _state(cond, d)
    res = OperatorFactory(cond).make_gibbs_sample_source("random_subset", 20)(
        torch.Generator().manual_seed(0), state)
    assert torch.isneginf(res.log_q).all() and (res.log_q_back == 0).all()
    jop = JaxFactory(jcond).make_gibbs_sample_source("random_subset", 20)
    assert len(seen["torch"]) == N
    for b in range(2):
        seen["jax"].clear()
        jstate = jcond.post.fill_state(JaxState.from_numpy({k: v[b] for k, v in d.items()}))
        with jax.disable_jit():
            jres = jop(jax.random.PRNGKey(0), jstate)
        assert len(seen["jax"]) == N
        for j in range(N):
            np.testing.assert_allclose(seen["torch"][j][b], seen["jax"][j], rtol=1e-5, atol=1e-7,
                                       err_msg=f"sub-step {j}")
        idx, rows = res.source_rows
        np.testing.assert_array_equal(_np(idx)[b], np.asarray(jres.source_rows[0]))
        np.testing.assert_array_equal(_np(rows)[b], np.asarray(jres.source_rows[1]))
        for name in ("cl_counts", "conf_counts", "pat_counts"):
            np.testing.assert_array_equal(_np(getattr(res.state, name))[b],
                                          np.asarray(getattr(jres.state, name)), err_msg=name)
        np.testing.assert_allclose(float(res.ll_delta[b]), float(jres.ll_delta), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(float(res.source_prior_delta[b]),
                                   float(jres.source_prior_delta), rtol=1e-5, atol=1e-3)


def test_sweep_draws_follow_the_conditional(models, monkeypatch):
    """2000 copies of one chain, the subset's order forced: the first swept
    object's new components, pooled over its observed features, follow the
    conditional the sweep computed for it (chi-square at p > 0.005)."""
    import sbayes_tpu_torch.sampling.operators as ops_mod
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    _, cond, d = models
    N, n = cond.consts.N, 2000
    first = {}
    sample = ops_mod.sample_categorical_onehot

    def recording(gen, p):
        first.setdefault("p", p[0].clone())
        return sample(gen, p)

    torch_rand = torch.rand

    def ordered_rand(*size, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        if shape == (n, N):
            return torch.arange(N, dtype=torch.float32).expand(n, N) / N
        return torch_rand(*size, **kw)

    monkeypatch.setattr(ops_mod, "sample_categorical_onehot", recording)
    monkeypatch.setattr(torch, "rand", ordered_rand)
    one = {k: np.repeat(v[:1], n, axis=0) for k, v in d.items()}
    res = OperatorFactory(cond).make_gibbs_sample_source("random_subset", 20)(
        torch.Generator().manual_seed(1), _state(cond, one))
    idx, rows = res.source_rows
    assert bool((idx[:, 0] == 0).all())
    counts = rows[:, 0].sum(0).double().numpy()                     # (F, C) over the copies
    p = first["p"].double().numpy()
    observed = ~cond.consts.na[0].numpy()
    expect = n * p[observed]
    keep = expect > 5                                                # chi-square cells
    stat = ((counts[observed][keep] - expect[keep]) ** 2 / expect[keep]).sum()
    dof = int(keep.sum()) - int(observed.sum())
    assert dof > 100
    assert chi2.sf(stat, dof) > 0.005, (stat, dof)


def test_sweep_is_accepted_and_carries_exact_counts(models):
    """Ten MH steps of the sweep on each source selector: always accepted,
    the carried counts equal the recompute exactly, the carried
    log-likelihood within rtol 1e-5 of it."""
    from sbayes_tpu_torch.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu_torch.sampling.operators import OperatorFactory, OperatorSpec

    _, cond, d = models
    fact = OperatorFactory(cond)
    specs = [OperatorSpec(sel, 1.0, fact.make_gibbs_sample_source(sel, cap), "source")
             for sel, cap in (("random_subset", 20), ("groups", 30))]
    apply = make_mh_apply_fn(cond, specs)
    state = _state(cond, d)
    gen = torch.Generator().manual_seed(3)
    for spec in specs:
        # Forced acceptance: the Gibbs sentinel log_q = -inf, and the
        # operator's own exact likelihood delta (no count difference).
        res = spec.fn(torch.Generator().manual_seed(4), state)
        assert bool((res.log_q == float("-inf")).all()) and res.ll_delta is not None
    changed = 0.0
    assert bool(torch.isfinite(state.log_prior).all())
    for i in range(10):
        new, accept, step, nf = apply(i % 2, gen, state)
        assert bool(accept.all()) and not bool(nf.any())
        changed += float(step.sum())
        state = new
    assert changed > 0
    ref = cond.post.fill_state(state)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        torch.testing.assert_close(getattr(state, name), getattr(ref, name), rtol=0, atol=0)
    for name in ("log_lh", "log_prior"):
        torch.testing.assert_close(getattr(state, name), getattr(ref, name), rtol=1e-5, atol=1e-3)
