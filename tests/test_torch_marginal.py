"""Kernel 2 of the PyTorch port (membership marginal, ``ops/marginal.py``)
against the JAX package on the CPU, where the wrapper runs its plain
PyTorch version: all four variants against ``OperatorFactory._marginal_impl``
on the XLA path (``_pm_cache = None``) where it has the variant, and against
the Pallas kernel in interpret mode (the env setup of
tests/test_pallas_marginal.py, popped afterwards).

Tolerance: rtol = atol = 2e-4, the JAX package's own for its kernel against
its XLA path (sums of F logs in another order, float32)."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

KW = dict(n_objects=48, n_features=8, n_states=3, n_families=2, seed=5)
T, TP = 1.2, 1.5
TOL = dict(rtol=2e-4, atol=2e-4)
ENV = {"SBAYES_TPU_FEATURE_CHUNK": "4", "SBAYES_TPU_PALLAS_MARGINAL": "1",
       "SBAYES_TPU_PALLAS_INTERPRET": "1", "SBAYES_TPU_PALLAS_BF16MM": "0"}


def numpy_state(K, N, F, C, na, seed):
    """One chain's state dict in the JAX checkpoint format (numpy)."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, K + 1, size=N)
    clusters = np.stack([label == k for k in range(K)])
    comp = rng.integers(0, C, size=(N, F))
    source = (comp[..., None] == np.arange(C)) & ~na[:, :, None]
    weights = rng.dirichlet(np.ones(C), size=F).astype(np.float32)
    return {"clusters": clusters, "weights": weights, "source": source}


@pytest.fixture(scope="module")
def setup():
    os.environ.update(ENV)
    try:
        from sbayes_tpu.model.model import Model as JaxModel
        from sbayes_tpu.model.posterior import Posterior as JaxPosterior
        from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
        from sbayes_tpu.sampling.operators import OperatorFactory as JaxFactory
        from sbayes_tpu.sampling.state import ChainState as JaxState
        from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
        from sbayes_tpu_torch.model.model import Model
        from sbayes_tpu_torch.model.posterior import Posterior
        from sbayes_tpu_torch.sampling.conditionals import Conditionals
        from sbayes_tpu_torch.sampling.operators import OperatorFactory
        from sbayes_tpu_torch.sampling.state import ChainState
        from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

        jm = JaxModel(jax_data(**KW), jax_config(n_clusters=2).model)
        assert jm.consts.features_idx_tl is not None, "pallas layout not built"
        jcond = JaxCond(JaxPosterior(jm.consts), T, TP)
        jfact = JaxFactory(jcond)
        m = Model(synthetic_data(**KW), synthetic_config(n_clusters=2).model, device="cpu")
        cond = Conditionals(Posterior(m.consts), T, TP)
        fact = OperatorFactory(cond)
        c = m.consts
        d = numpy_state(c.K, c.N, c.F, c.C, c.na.numpy(), seed=4)
        jstate = jcond.post.fill_state(JaxState.from_numpy(
            {**d, "log_lh": 0.0, "log_prior": 0.0, "prior_parts": np.zeros(4)}))
        state = cond.post.fill_state(ChainState.from_numpy(
            {**d, "log_lh": 0.0, "log_prior": 0.0, "prior_parts": np.zeros(4)}))
        yield jm, jcond, jfact, jstate, m, cond, fact, state
    finally:
        for k in ENV:
            os.environ.pop(k, None)


def _xla(jfact, fn, *args, **kw):
    jfact._pm_cache = None
    try:
        return fn(*args, **kw)
    finally:
        jfact._pm_cache = False


@pytest.mark.parametrize("heat", [False, True], ids=["noheat", "heat"])
def test_ratio_variants_match_jax_xla(setup, heat):
    """(ratio, noheat) — the Gibbsish / wide / ML-step variant — and
    (ratio, heat) — the wide operator at T != 1."""
    jm, jcond, jfact, jstate, m, cond, fact, state = setup
    avail = jnp.ones(jm.consts.N, bool)
    want = _xla(jfact, jfact._cluster_log_odds, jstate, 1, avail,
                counts=(jstate.cl_counts, jstate.conf_counts), heat_effect_lh=heat)
    got = fact._cluster_log_odds(state, torch.tensor([1]), heat_effect_lh=heat)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("heat", [False, True], ids=["noheat", "heat"])
def test_absolute_variant_matches_jax_xla(setup, heat):
    """(abs) — both absolute marginals, the EPS-flooring jump's variant."""
    jm, jcond, jfact, jstate, m, cond, fact, state = setup
    avail = jnp.ones(jm.consts.N, bool)
    w0, w1 = _xla(jfact, jfact._log_marginal_with_without, jstate, 1, avail,
                  counts=(jstate.cl_counts, jstate.conf_counts), heat_effect_lh=heat)
    g0, g1 = fact._log_marginal_with_without(state, torch.tensor([1]), heat_effect_lh=heat)
    np.testing.assert_allclose(g0[0].numpy(), np.asarray(w0), **TOL)
    np.testing.assert_allclose(g1[0].numpy(), np.asarray(w1), **TOL)


def _kernel_inputs(jcond, jstate):
    """Numpy inputs of one chain: effect rows of clusters 1 and 0, confounder
    effects, heated weights, availabilities."""
    from sbayes_tpu.model.math import normalize

    c = jcond.consts
    unif = jnp.asarray(c.unif_conc)

    def eff(i):
        return normalize(unif + (jnp.asarray(c.conc_cluster) - unif) / TP
                         + jstate.cl_counts[i] / T, axis=-1)

    hc = np.asarray(jcond.post.has_components(jstate.clusters), np.float32)
    hc_flip = hc.copy()
    hc_flip[:, 0] = 1.0 - hc[:, 0]
    return dict(p1=np.asarray(eff(1)), p0=np.asarray(eff(0)),
                conf_eff=np.asarray(normalize(jstate.conf_counts + jnp.asarray(c.conc_conf),
                                              axis=-1)),
                wh=np.asarray(jstate.weights ** (1.0 / TP)), hc=hc, hc_flip=hc_flip)


@pytest.mark.parametrize("ratio,heat,two_eff", [
    (True, False, False), (True, True, False), (True, False, True), (False, False, False),
], ids=["ratio", "ratio_heat", "two_eff", "abs"])
def test_variants_match_jax_pallas_interpret(setup, ratio, heat, two_eff):
    """Every variant of the kernel's function against the Pallas kernel run
    in interpret mode on the same inputs (two_eff with distinct rows and
    hc_flip == hc, as the log-space jump calls it)."""
    from sbayes_tpu.ops.pallas_marginal import make_pallas_marginal, tile_layout_eff, wh_layout
    from sbayes_tpu_torch.ops.marginal import marginal

    jm, jcond, jfact, jstate, m, cond, fact, state = setup
    c = jm.consts
    x = _kernel_inputs(jcond, jstate)
    rows = [x["p1"]] if (ratio and not two_eff) else [x["p1"], x["p0"]]
    hc_flip = x["hc"] if two_eff else x["hc_flip"]
    incl = x["hc"][:, 0]
    inv_t = 1.0 / T if heat else None

    pm = make_pallas_marginal(c, interpret=True, ratio=ratio, heat=heat, two_eff=two_eff)
    p_tl = jnp.concatenate([tile_layout_eff(jnp.asarray(r), c.F).reshape(1, -1) for r in rows])
    want = pm(p_tl, wh_layout(jnp.asarray(x["wh"]).T, c.F), jnp.asarray(x["hc"]),
              jnp.asarray(hc_flip), jnp.asarray(incl)[:, None],
              tile_layout_eff(jnp.asarray(x["conf_eff"]), c.F),
              None if inv_t is None else jnp.float32(inv_t))
    want = np.asarray(want) if ratio else np.stack([np.asarray(w) for w in want], -1)

    def t(a):
        return torch.as_tensor(np.array(a))[None]

    got = marginal(m.consts, t(np.stack(rows)), t(x["conf_eff"]), t(x["wh"]), t(x["hc"]),
                   t(hc_flip), t(incl), None if inv_t is None else torch.tensor([inv_t]),
                   ratio=ratio, two_eff=two_eff)
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)


def test_wrapper_batches_chains_independently(setup):
    """A batch of chains gives each chain's own single-chain result."""
    from sbayes_tpu_torch.ops.marginal import marginal

    jm, jcond, jfact, jstate, m, cond, fact, state = setup
    x = _kernel_inputs(jcond, jstate)
    B = 3
    rng = np.random.default_rng(0)
    wh = np.stack([x["wh"] * rng.uniform(0.5, 1.5, x["wh"].shape) for _ in range(B)])
    args = [torch.as_tensor(np.broadcast_to(a, (B,) + a.shape).copy()) for a in
            (x["p1"][None], x["conf_eff"])]
    rest = [torch.as_tensor(np.broadcast_to(a, (B,) + a.shape).copy()) for a in
            (x["hc"], x["hc_flip"], x["hc"][:, 0])]
    batched = marginal(m.consts, args[0], args[1], torch.as_tensor(wh, dtype=torch.float32),
                       *rest)
    for b in range(B):
        single = marginal(m.consts, args[0][b:b + 1], args[1][b:b + 1],
                          torch.as_tensor(wh[b:b + 1], dtype=torch.float32),
                          *[r[b:b + 1] for r in rest])
        torch.testing.assert_close(batched[b], single[0])
