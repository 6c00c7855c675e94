"""MC3 on the scale layout of the port (the packed int8 source over feature
tiles) on the CPU: ``run_mc3_chunk`` with swaps, its carried state against
the exact recompute and against the same ladder on the bool source; and the
heated conditionals at per-chain temperatures over the feature tiles against
the JAX package with the same forced chunk (``SBAYES_TPU_FEATURE_CHUNK``).

A ladder of three chains at (T, Tp) = (1, 1), (1.3, 1.7), (2, 1.2) is held
per chain against JAX ``Conditionals`` at that chain's scalar temperatures
(as tests/test_torch_mc3.py does untiled).

Tolerances: counts exactly; the carried log-likelihood and log-prior within
1e-4 absolute + 1e-5 relative of their recompute (float32 running sums);
the packed ladder bit-equal to the bool one (every probability picks the
same floats); against JAX the membership log-odds rtol = atol = 2e-4,
heated membership and source probabilities rtol 1e-4, atol 1e-6, the mask
engine's sources exactly (draws forced to the most probable component) and
its log proposal densities 1e-4 absolute (those of
tests/test_torch_mc3.py)."""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_mc3 import TEMPS, TOL_ODDS, TOL_PROB, _xla
from test_torch_posterior_ops import _np, numpy_state

CHUNK = 4
KW = dict(n_objects=24, n_features=12, n_states=3, n_families=2, seed=6)
GEO = {"type": "cost_based", "rate": 2e5, "aggregation": "sum"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ladder_runtime(packed: bool):
    """K = 2 under the cost-based geo prior (its aggregates carried), the
    source packed or bool, features in tiles of CHUNK."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    cfg = synthetic_config(n_clusters=2).update({"model": {"prior": {"geo": GEO}}})
    model = Model(synthetic_data(**KW), cfg.model, device="cpu", source_packed=packed,
                  feature_chunk=CHUNK)
    return SamplerRuntime(model, cfg.mcmc)


def test_mc3_chunk_with_swaps_on_the_packed_source():
    """Four rungs at T = 1 + 0.5 i, prior temperatures 1 + 0.2 i, a swap
    phase every 2 steps (1 attempt, adjacent rungs), 30 steps on the packed
    source over tiles of 4 features: swaps are accepted (the states, their
    packed sources and carried geo aggregates permuted), the carried state
    equals its recompute, and the ladder equals the same ladder on the bool
    source bit for bit."""
    from sbayes_tpu_torch.model.math import source_onehot
    from sbayes_tpu_torch.sampling.runner import make_generators

    out = {}
    for packed in (True, False):
        rt = _ladder_runtime(packed)
        assert rt.consts.feature_chunk == CHUNK and rt.consts.source_packed == packed
        gen, op_gen = make_generators(5, "cpu")
        states = rt.init_chains(gen, 4)
        temps = 1.0 + 0.5 * torch.arange(4, dtype=torch.float32)
        prior_temps = 1.0 + 0.2 * torch.arange(4, dtype=torch.float32)
        swap_matrix = np.zeros((2, 4, 4), dtype=np.int64)
        states, stats, n_acc, n_att = rt.run_mc3_chunk(
            gen, op_gen, states, rt.new_stats(4), temps, prior_temps, swap_matrix, 0, 30, 2, 1,
            True)
        assert n_att == 15 and n_acc > 0
        ref = rt.refresh(states)
        for name in ("cl_counts", "conf_counts", "pat_counts", "geo_agg"):
            torch.testing.assert_close(getattr(states, name), getattr(ref, name),
                                       rtol=0 if name != "geo_agg" else 1e-5,
                                       atol=0, msg=name)
        for name in ("log_lh", "log_prior"):
            torch.testing.assert_close(getattr(states, name), getattr(ref, name), rtol=1e-5,
                                       atol=1e-4, msg=name)
        assert states.source.dtype == (torch.int8 if packed else torch.bool)
        out[packed] = (states, stats, swap_matrix, source_onehot(states.source, rt.consts.C))
    (a, sa, ma, src_a), (b, sb, mb, src_b) = out[True], out[False]
    np.testing.assert_array_equal(ma, mb)
    assert torch.equal(src_a, src_b) and torch.equal(sa.accepts, sb.accepts)
    for name in ("clusters", "weights", "log_lh", "log_prior", "cl_counts", "geo_agg"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.fixture
def tiled_ladder(monkeypatch):
    """Both packages' models (K = 2, cost-based geo prior, 24 objects x 12
    features) with features in tiles of 4: the port on the packed source
    with a (B,) batch at the per-chain temperatures TEMPS, JAX with
    SBAYES_TPU_FEATURE_CHUNK=4, per chain its state, conditionals and
    operator factory at that chain's temperatures."""
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

    monkeypatch.setenv("SBAYES_TPU_FEATURE_CHUNK", str(CHUNK))
    override = {"model": {"clusters": 2, "prior": {
        "geo": GEO, "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 8}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=2).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=2).update(override)
    jm = JaxModel(jax_data(**KW), jcfg.model)
    m = Model(synthetic_data(**KW), cfg.model, device="cpu", source_packed=True,
              feature_chunk=CHUNK)
    c = m.consts
    assert jm.consts.feature_chunk == c.feature_chunk == CHUNK and c.source_packed
    na = _np(c.na)
    dicts = []
    for seed in (4, 5, 6):
        d = numpy_state(c.K, c.N, c.F, c.C, na, seed=seed, min_size=3)
        d["clusters"][:, 8:] &= np.cumsum(d["clusters"][:, 8:], axis=1) <= 2
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
    state = state._replace(source=cond.post.source_form(state.source))
    assert state.source.dtype == torch.int8
    return dict(jm=jm, jconds=jconds, jfacts=[JaxFactory(jc) for jc in jconds],
                jstates=jstates, cond=cond, fact=OperatorFactory(cond), state=state)


def test_heated_gibbsish_conditionals_on_tiles_match_jax(tiled_ladder, monkeypatch):
    """Per chain at its own (T, Tp), the port on packed tiles against JAX
    under the same forced chunk: the Gibbsish grow/shrink proposal (the
    membership posterior with the geo term over Tp, heated by 1/T), the
    wide operator's heated log-odds (the heat variant), the source
    posterior tile by tile and the mask engine's resample of a subset
    (sources, log_q, log_q_back) under forced draws."""
    import sbayes_tpu.sampling.conditionals as jax_cond_mod
    import sbayes_tpu.sampling.operators as jax_ops
    import sbayes_tpu_torch.sampling.conditionals as cond_mod
    from sbayes_tpu_torch.model.math import feature_tiles, source_onehot
    from sbayes_tpu_torch.sampling.operators import _heat_prob

    monkeypatch.setattr(jax_cond_mod, "sample_categorical_onehot",
                        lambda key, p: jnp.arange(p.shape[-1]) == jnp.argmax(p, -1)[..., None])
    monkeypatch.setattr(cond_mod, "sample_categorical_onehot",
                        lambda gen, p: torch.nn.functional.one_hot(p.argmax(-1),
                                                                   p.shape[-1]).bool())
    p = tiled_ladder
    s, fact, cond = p["state"], p["fact"], p["cond"]
    counts = (s.cl_counts, s.conf_counts)
    grow = _np(_heat_prob(fact._cluster_posterior(s, torch.tensor([0, 0, 0]), True, counts,
                                                  consider_geo=True), fact.T))
    odds = _np(fact._cluster_log_odds(s, torch.tensor([1, 1, 1]), heat_effect_lh=True))
    tiles = feature_tiles(p["jm"].consts.F, CHUNK)
    assert len(tiles) == 3
    post = _np(torch.cat([cond.source_posterior(s.clusters, s.weights, s.source, sl=sl)
                          for sl in tiles], dim=2))
    subset = torch.zeros((3, KW["n_objects"]), dtype=torch.bool)
    subset[:, :10] = True
    mask = cond.gibbs_resample_source(torch.Generator().manual_seed(0), s, s.clusters, subset,
                                      torch.ones(3, dtype=torch.long))
    assert mask.source.dtype == torch.int8
    new_src = _np(source_onehot(mask.source, cond.consts.C))
    avail = jnp.ones(p["jm"].consts.N, bool)
    for b, (jf, jc, js) in enumerate(zip(p["jfacts"], p["jconds"], p["jstates"])):
        jcounts = (js.cl_counts, js.conf_counts)
        want = jax_ops._heat_prob(_xla(jf, jf._cluster_posterior, js, 0, avail, True,
                                       counts=jcounts), jc.T)
        np.testing.assert_allclose(grow[b], np.asarray(want), err_msg=f"chain {b}", **TOL_PROB)
        want = _xla(jf, jf._cluster_log_odds, js, 1, avail, counts=jcounts, heat_effect_lh=True)
        np.testing.assert_allclose(odds[b], np.asarray(want), err_msg=f"chain {b}", **TOL_ODDS)
        want = jc.source_posterior(js.clusters, js.weights, js.source)
        np.testing.assert_allclose(post[b], np.asarray(want), err_msg=f"chain {b}", **TOL_PROB)
        jmask = jc.gibbs_resample_source(jax.random.PRNGKey(0), js, js.clusters,
                                         jnp.arange(KW["n_objects"]) < 10, 1)
        np.testing.assert_array_equal(new_src[b], np.asarray(jmask.source))
        for name in ("log_q", "log_q_back"):
            np.testing.assert_allclose(float(_np(getattr(mask, name))[b]),
                                       float(getattr(jmask, name)), rtol=0, atol=1e-4,
                                       err_msg=f"{name}, chain {b}")
