"""Feature tiles of the port (``ModelConstants.feature_chunk``): the tiled
posterior, conditionals, source resamples and EM initializer against the
untiled ones, and against the JAX package with a forced chunk
(``SBAYES_TPU_FEATURE_CHUNK``), on one numpy state of three chains.

Tolerances (those of tests/test_torch_posterior_ops.py): counts are exact
integers (equal); log-densities rtol 1e-5, atol 1e-5 (float32 sums over the
tiles in another order); per-cell likelihoods and probabilities rtol 1e-6
between tiled and untiled port (the same elementwise arithmetic), 1e-4
against JAX (RTOL_PROPOSAL: float32 einsums in another order). Sampled
sources are compared under forced draws (the most probable component of
each cell), so they are equal."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_posterior_ops import RTOL_DENSITY, RTOL_PROPOSAL, _np, numpy_state

KW = dict(n_objects=30, n_features=12, n_states=4, n_families=3, seed=5)
B = 3
RTOL_TILES = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,f", [(100, 36), (10_000, 5_000), (2_000, 2_001), (4_000, 1_000),
                                 (3_000, 1_500), (20_000, 7)])
def test_auto_feature_chunk_equals_jax(monkeypatch, n, f):
    from sbayes_tpu.model.constants import auto_feature_chunk as jax_rule
    from sbayes_tpu_torch.model.constants import auto_feature_chunk

    monkeypatch.delenv("SBAYES_TPU_FEATURE_CHUNK", raising=False)
    assert auto_feature_chunk(n, f) == jax_rule(n, f)
    assert auto_feature_chunk(10_000, 5_000) == 500


def _state(model, d):
    from sbayes_tpu_torch.sampling.state import ChainState

    return model.posterior.fill_state(ChainState.from_numpy(d))


@pytest.fixture(scope="module")
def models():
    """Port models untiled, in tiles of 4 (a divisor of F = 12) and of 5 (a
    ragged last tile), and one numpy batch of three chains."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    data, cfg = synthetic_data(**KW), synthetic_config(n_clusters=2).model
    out = {fc: Model(data, cfg, device="cpu", feature_chunk=fc) for fc in (0, 4, 5)}
    c = out[0].consts
    assert out[0].consts.feature_chunk is None and out[4].consts.feature_chunk == 4
    ds = [numpy_state(c.K, c.N, c.F, c.C, c.na.numpy(), seed=s) for s in range(B)]
    d = {k: np.stack([x[k] for x in ds]) for k in ds[0]}
    return out, d


@pytest.mark.parametrize("fc", [4, 5])
def test_tiled_posterior_equals_untiled(models, fc):
    out, d = models
    ref, got = _state(out[0], d), _state(out[fc], d)
    for name in ("cl_counts", "conf_counts", "pat_counts"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=0, atol=0)
    for name in ("log_lh", "log_prior", "prior_parts"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=RTOL_DENSITY,
                                   atol=1e-5)
    from sbayes_tpu_torch.ops.loglh import log_likelihood_plain

    torch.testing.assert_close(log_likelihood_plain(out[fc].consts, got.clusters, got.source),
                               ref.log_lh, rtol=RTOL_DENSITY, atol=1e-5)


@pytest.mark.parametrize("fc", [4, 5])
def test_tiled_conditionals_equal_untiled(models, fc):
    from sbayes_tpu_torch.model.math import feature_tiles
    from sbayes_tpu_torch.sampling.conditionals import Conditionals

    out, d = models
    ref_state, state = _state(out[0], d), _state(out[fc], d)
    ref, cond = Conditionals(out[0].posterior), Conditionals(out[fc].posterior)
    torch.testing.assert_close(cond.likelihood_per_component_exact(state.clusters, state.source),
                               ref.likelihood_per_component_exact(ref_state.clusters,
                                                                  ref_state.source),
                               rtol=RTOL_TILES, atol=0)
    want = ref.source_posterior(ref_state.clusters, ref_state.weights, ref_state.source)
    tiles = feature_tiles(out[fc].consts.F, fc)
    assert len(tiles) == -(-12 // fc)
    got = torch.cat([cond.source_posterior(state.clusters, state.weights, state.source, sl=sl)
                     for sl in tiles], dim=2)
    torch.testing.assert_close(got, want, rtol=RTOL_TILES, atol=0)


@pytest.fixture
def argmax_draws(monkeypatch):
    """The categorical draws of both packages' conditionals and operators
    forced to the most probable component."""
    import sbayes_tpu.sampling.conditionals as jax_cond
    import sbayes_tpu.sampling.operators as jax_ops
    import sbayes_tpu_torch.sampling.conditionals as cond_mod
    import sbayes_tpu_torch.sampling.initializer as init_mod
    import sbayes_tpu_torch.sampling.operators as ops_mod

    def jax_argmax(key, p):
        return jnp.arange(p.shape[-1]) == jnp.argmax(p, -1)[..., None]

    def torch_argmax(gen, p):
        return torch.nn.functional.one_hot(p.argmax(-1), p.shape[-1]).bool()

    for mod in (jax_cond, jax_ops):
        monkeypatch.setattr(mod, "sample_categorical_onehot", jax_argmax)
    for mod in (cond_mod, ops_mod, init_mod):
        monkeypatch.setattr(mod, "sample_categorical_onehot", torch_argmax)


def _mask_engine(model, state):
    """The initializer's resample: objects 0..14 of cluster 1's move."""
    from sbayes_tpu_torch.sampling.conditionals import Conditionals

    subset = torch.zeros((state.n_chains, model.consts.N), dtype=torch.bool)
    subset[:, :15] = True
    i_cluster = torch.ones(state.n_chains, dtype=torch.long)
    return Conditionals(model.posterior).gibbs_resample_source(
        torch.Generator().manual_seed(0), state, state.clusters, subset, i_cluster)


@pytest.mark.parametrize("fc", [4, 5])
def test_tiled_source_resamples_equal_untiled(models, argmax_draws, fc):
    """The mask engine and the all-objects source operator over tiles: the
    same sources (forced draws), log_q and log_q_back."""
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    out, d = models
    results = []
    for m in (out[fc], out[0]):
        state = _state(m, d)
        mask = _mask_engine(m, state)
        op = OperatorFactory(Conditionals(m.posterior)).make_gibbs_sample_source("all", 10 ** 9)
        res = op(torch.Generator().manual_seed(0), state)
        results.append([(mask.source, mask.log_q, mask.log_q_back),
                        (res.state.source, res.log_q, res.log_q_back)])
    for got, want in zip(*results):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1:], want[1:], rtol=RTOL_DENSITY, atol=1e-5)


@pytest.mark.parametrize("fc", [4, 5])
def test_tiled_em_initializer_equals_untiled(models, fc):
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.initializer import Initializer

    out, _ = models
    got, want = (Initializer(Conditionals(m.posterior), initial_size=5, attempts=1,
                             n_em_steps=3).generate_clusters_em(
                                 torch.Generator().manual_seed(4), 6)
                 for m in (out[fc], out[0]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tiled_port_matches_jax_with_a_forced_chunk(models, monkeypatch, argmax_draws):
    """The port in tiles of 4 against the JAX package with
    SBAYES_TPU_FEATURE_CHUNK=4 on the same chains: counts, pattern counts,
    densities, the leave-self-out component likelihoods, the mask engine's
    and the all-objects operator's sources and proposal densities."""
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.sampling.operators import OperatorFactory as JaxFactory
    from sbayes_tpu.sampling.state import ChainState as JaxState
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.sampling.operators import OperatorFactory

    monkeypatch.setenv("SBAYES_TPU_FEATURE_CHUNK", "4")
    jm = JaxModel(jax_data(**KW), jax_config(n_clusters=2).model)
    assert jm.consts.feature_chunk == 4
    out, d = models
    state = _state(out[4], d)
    jcond = JaxCond(jm.posterior)
    cond = Conditionals(out[4].posterior)
    jop = JaxFactory(jcond).make_gibbs_sample_source("all", 10 ** 9)
    op = OperatorFactory(cond).make_gibbs_sample_source("all", 10 ** 9)
    res = op(torch.Generator().manual_seed(0), state)
    mask = _mask_engine(out[4], state)
    lh_exact = cond.likelihood_per_component_exact(state.clusters, state.source)
    for b in range(B):
        jstate = jcond.post.fill_state(JaxState.from_numpy({k: v[b] for k, v in d.items()}))
        for name in ("cl_counts", "conf_counts", "pat_counts"):
            np.testing.assert_array_equal(_np(getattr(state, name))[b],
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        for name in ("log_lh", "log_prior", "prior_parts"):
            np.testing.assert_allclose(_np(getattr(state, name))[b],
                                       np.asarray(getattr(jstate, name)),
                                       rtol=RTOL_DENSITY, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(
            _np(lh_exact)[b], np.asarray(jcond.likelihood_per_component_exact(
                jstate.clusters, jstate.source)), rtol=RTOL_PROPOSAL, atol=1e-7)
        subset = jnp.arange(KW["n_objects"]) < 15
        jmask = jcond.gibbs_resample_source(jax.random.PRNGKey(0), jstate, jstate.clusters,
                                            subset, 1)
        jres = jop(jax.random.PRNGKey(0), jstate)
        for got, want in (((mask.source, mask.log_q, mask.log_q_back),
                           (jmask.source, jmask.log_q, jmask.log_q_back)),
                          ((res.state.source, res.log_q, res.log_q_back),
                           (jres.state.source, jres.log_q, jres.log_q_back))):
            np.testing.assert_array_equal(_np(got[0])[b], np.asarray(want[0]))
            for name, g, w in zip(("log_q", "log_q_back"), got[1:], want[1:]):
                np.testing.assert_allclose(float(_np(g)[b]), float(w), rtol=RTOL_DENSITY,
                                           atol=1e-4, err_msg=name)
