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


def test_feature_major_index_is_the_transpose(setup):
    """``feat_idx_t`` (F, N), which the kernel's lanes read along objects, is
    the contiguous transpose of ``feat_idx`` (N, F), sentinel S at NA."""
    m = setup[4]
    c = m.consts
    assert c.feat_idx_t.shape == (c.F, c.N) and c.feat_idx_t.dtype == torch.int8
    assert c.feat_idx_t.is_contiguous()
    assert torch.equal(c.feat_idx_t, c.feat_idx.T)
    assert torch.equal(c.feat_idx_t.T == c.S, c.na)


def _odd_model():
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=37, n_features=7, n_states=5, n_families=5,
                          no_family_share=0.2, seed=1)
    return Model(data, synthetic_config(n_clusters=2).model, device="cpu")


def test_synthetic_data_can_leave_objects_out_of_every_family():
    """``no_family_share`` empties some objects' family column (group index
    -1, availability 0) and changes nothing else of the data."""
    from sbayes_tpu_torch.testing import synthetic_data

    kw = dict(n_objects=37, n_features=7, n_states=5, n_families=5, seed=1)
    base, odd = synthetic_data(**kw), synthetic_data(no_family_share=0.2, **kw)
    np.testing.assert_array_equal(base.features.values, odd.features.values)
    fam, fam_odd = base.confounders["family"].group_assignment, odd.confounders["family"].group_assignment
    assert fam.sum(0).min() == 1
    out = fam_odd.sum(0) == 0
    assert 0 < out.sum() < 37
    np.testing.assert_array_equal(fam[:, ~out], fam_odd[:, ~out])
    c = _odd_model().consts
    assert torch.equal(c.group_idx[1] < 0, torch.as_tensor(out))
    assert (c.group_idx[0] == 0).all() and not c.hc_conf[torch.as_tensor(out), 1].any()


@pytest.mark.parametrize("names", [("family",), ("universal", "family", "area"),
                                   ("universal", "family", "area", "script")],
                         ids=["C2", "C4", "C5"])
def test_synthetic_data_with_other_confounders(names):
    """``confounders`` names the confounders of data and config: the model
    gets one component per name plus the cluster effect, every further
    confounder partitions the objects, and the features stay those of the
    default confounders."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    kw = dict(n_objects=50, n_features=12, n_states=4, n_families=3, seed=2)
    data = synthetic_data(confounders=names, **kw)
    np.testing.assert_array_equal(data.features.values, synthetic_data(**kw).features.values)
    assert tuple(data.confounders) == names
    c = Model(data, synthetic_config(n_clusters=2, confounders=names).model, device="cpu").consts
    assert c.C == len(names) + 1 and c.group_idx.shape == (len(names), 50)
    for i, name in enumerate(names):
        if name != "universal":
            assert data.confounders[name].group_assignment.sum(0).tolist() == [1] * 50
            assert len(torch.unique(c.group_idx[i])) == 3


@pytest.mark.parametrize("ratio,heat,two_eff", [
    (True, False, False), (True, True, False), (True, False, True), (False, False, False),
], ids=["ratio", "ratio_heat", "two_eff", "abs"])
def test_index_form_matches_plain_on_odd_shapes(ratio, heat, two_eff):
    """The kernel's arithmetic written as loops over the index tensors it
    reads (feature-major state index, group index with -1, NA at 1, TINY
    clamps, float64) against the plain version on data with objects in no
    family. Tolerance rtol = atol = 1e-4: float32 sums of 7 logs."""
    from sbayes_tpu_torch.ops.marginal import TINY, marginal_plain

    c = _odd_model().consts
    rng = np.random.default_rng(8)
    B, N, F, S, C, G = 2, c.N, c.F, c.S, c.C, c.Gmax
    E = 1 if (ratio and not two_eff) else 2

    def norm(x):
        return x / x.sum(-1, keepdims=True)

    app = c.applicable.numpy()
    p_eff = norm((rng.random((B, E, F, S)) + 0.05) * app)
    conf_eff = norm((rng.random((B, C - 1, G, F, S)) + 0.05) * app)
    wh = norm(rng.random((B, F, C)) + 0.05)
    in_cl = rng.random((B, N)) < 0.4
    hc = np.concatenate([in_cl[..., None], np.broadcast_to(c.hc_conf.numpy(), (B, N, C - 1))], -1)
    hc_flip = hc.copy()
    hc_flip[..., 0] = ~hc[..., 0]
    inv_t = rng.uniform(0.5, 1.0, B) if heat else None
    fit, gi = c.feat_idx_t.numpy(), c.group_idx.numpy()

    want = np.zeros((B, N) if ratio else (B, N, 2))
    for b in range(B):
        for n in range(N):
            acc = np.zeros(2)
            for f in range(F):
                s = fit[f, n]
                na = s >= S
                lh0 = [1.0 if na else (max(p_eff[b, e, f, s], TINY) ** inv_t[b] if heat
                                       else p_eff[b, e, f, s]) for e in range(E)]
                lh = [None] + [1.0 if na else (0.0 if gi[k, n] < 0 else conf_eff[b, k, gi[k, n], f, s])
                               for k in range(C - 1)]
                z_cur = sum(wh[b, f, k] * hc[b, n, k] for k in range(C))
                z_flip = sum(wh[b, f, k] * hc_flip[b, n, k] for k in range(C))
                s_cur = wh[b, f, 0] * hc[b, n, 0] * lh0[0] + sum(
                    wh[b, f, k] * hc[b, n, k] * lh[k] for k in range(1, C))
                s_flip = wh[b, f, 0] * hc_flip[b, n, 0] * lh0[-1] + sum(
                    wh[b, f, k] * hc_flip[b, n, k] * lh[k] for k in range(1, C))
                if ratio:
                    r = s_cur / max(s_flip, TINY) * (z_flip / max(z_cur, TINY))
                    acc[0] += np.log(max(r, TINY))
                else:
                    lh_cur, lh_flip = s_cur / max(z_cur, TINY), s_flip / max(z_flip, TINY)
                    lh_with, lh_without = (lh_cur, lh_flip) if in_cl[b, n] else (lh_flip, lh_cur)
                    acc += np.log([max(lh_without, TINY), max(lh_with, TINY)])
            want[b, n] = (acc[0] if in_cl[b, n] else -acc[0]) if ratio else acc

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    got = marginal_plain(c, t(p_eff), t(conf_eff), t(wh), t(hc), t(hc_flip), t(in_cl),
                         None if inv_t is None else t(inv_t), ratio=ratio, two_eff=two_eff)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,N,n_sm,tile", [(1024, 100, 132, 100), (132, 100, 132, 100),
                                          (64, 100, 132, 20), (16, 10_000, 132, 589),
                                          (2, 10_000, 132, 76), (1, 10, 132, 1),
                                          (3, 37, 132, 1)])
def test_object_tile_rule(B, N, n_sm, tile):
    """Objects per block of the marginal kernel's grid: all N (one block per
    chain, the launch of the main shapes) once the chains fill the SMs, else
    tiles that give chains x tiles >= 2 blocks per SM, every object in one
    tile."""
    from sbayes_tpu_torch.ops.marginal import object_tile

    got = object_tile(B, N, n_sm)
    assert got == tile
    tiles = -(-N // got)
    assert tiles * got >= N > (tiles - 1) * got
    if B < n_sm:
        assert B * tiles >= min(2 * n_sm, B * N)
