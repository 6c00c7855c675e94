"""Prior sampling in the port (``sampling/prior_sampling.py``) against the
JAX package's ``generate_prior_samples``.

* Cluster sizes within the bounds after the masked rejection, the mean size
  of each cluster equal to the JAX sampler's (Welch z test, p > 1e-3, 2000
  samples each, bounds that reject about half the draws).
* Weights: the mean of every weight equal to the Dirichlet prior's mean
  a / sum(a) (z test with the Dirichlet variance, p > 1e-3), for the
  uniform, the Jeffreys and a symmetric Dirichlet(3) weights prior.
* Sources only on available components, none at NA.
* ``log_lh`` equal to the JAX package's collapsed likelihood of the same
  sample and ``log_prior`` to its geo prior (rtol 1e-5, float32)."""
import warnings

import numpy as np
import pytest
from scipy.stats import norm

import jax
import torch

from test_torch_posterior_ops import _np

P_MIN = 1e-3
N = 2000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool runs these small ops ten times slower when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prior_pair(weights_prior):
    """Both packages' conditionals for K = 2 on 24 objects x 8 features, a
    cost-based geo prior and sizes in [5, 9]."""
    from sbayes_tpu.config.schema import SBayesConfig as JaxConfig
    from sbayes_tpu.model.model import Model as JaxModel
    from sbayes_tpu.sampling.conditionals import Conditionals as JaxCond
    from sbayes_tpu.testing import synthetic_config as jax_config, synthetic_data as jax_data
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.conditionals import Conditionals
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    kw = dict(n_objects=24, n_features=8, n_states=3, n_families=2, seed=6)
    override = {"model": {"clusters": 2, "prior": {
        "geo": {"type": "cost_based", "rate": 2e5, "aggregation": "sum"},
        "weights": weights_prior,
        "objects_per_cluster": {"type": "uniform_area", "min": 5, "max": 9}}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(**jax_config(n_clusters=2).model_dump()).update(override)
        cfg = synthetic_config(n_clusters=2).update(override)
    return (JaxCond(JaxModel(jax_data(**kw), jcfg.model).posterior),
            Conditionals(Model(synthetic_data(**kw), cfg.model, device="cpu").posterior))


@pytest.fixture(scope="module")
def uniform_pair():
    return prior_pair({"type": "uniform"})


@pytest.fixture(scope="module")
def samples(uniform_pair):
    from sbayes_tpu_torch.sampling.prior_sampling import generate_prior_samples

    return generate_prior_samples(torch.Generator().manual_seed(0), uniform_pair[1], N)


def test_cluster_sizes_match_the_jax_sampler(uniform_pair, samples):
    from sbayes_tpu.sampling.prior_sampling import generate_prior_samples as jax_samples

    jcond, cond = uniform_pair
    c = cond.consts
    cl = _np(samples.clusters)
    sizes = cl.sum(-1)
    assert cl.shape == (N, c.K, c.N) and (cl.sum(1) <= 1).all()
    assert (sizes >= c.min_size).all() and (sizes <= c.max_size).all()
    jsizes = np.asarray(jax_samples(jax.random.PRNGKey(0), jcond, N).clusters).sum(-1)
    se = np.sqrt(sizes.var(0, ddof=1) / N + jsizes.var(0, ddof=1) / N)
    z = (sizes.mean(0) - jsizes.mean(0)) / se
    assert (2 * norm.sf(np.abs(z)) > P_MIN).all(), (sizes.mean(0), jsizes.mean(0))


@pytest.mark.parametrize("weights_prior", [
    {"type": "uniform"}, {"type": "jeffreys"},
    {"type": "symmetric_dirichlet", "prior_concentration": 3.0}],
    ids=["uniform", "jeffreys", "symmetric_3"])
def test_weights_have_the_dirichlet_mean(weights_prior):
    from sbayes_tpu_torch.sampling.prior_sampling import generate_prior_sample

    cond = prior_pair(weights_prior)[1]
    a = _np(cond.consts.conc_weights).astype(float)                 # (F, C)
    w = _np(generate_prior_sample(torch.Generator().manual_seed(1), cond, N).weights)
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-5)
    a0 = a.sum(-1, keepdims=True)
    mean, var = a / a0, a * (a0 - a) / (a0 ** 2 * (a0 + 1))
    z = (w.mean(0) - mean) / np.sqrt(var / N)
    assert (2 * norm.sf(np.abs(z)) > P_MIN).all(), w.mean(0)


def test_source_lies_on_available_components(uniform_pair, samples):
    c = uniform_pair[1].consts
    na, hc_conf = _np(c.na), _np(c.hc_conf)
    src = _np(samples.source)
    assert (src[:, na].sum(-1) == 0).all() and (src[:, ~na].sum(-1) == 1).all()
    assert not src[..., 0][~_np(samples.clusters.any(1))].any()
    assert not (src[..., 1:] & ~hc_conf[None, :, None, :]).any()


def test_log_lh_and_geo_prior_match_jax(uniform_pair, samples):
    """The filled ``log_lh`` and ``log_prior`` of the first 16 samples
    against the JAX posterior of the same states."""
    from sbayes_tpu.sampling.state import ChainState as JaxState

    jcond, cond = uniform_pair
    for b in range(16):
        js = JaxState.from_numpy(samples.to_numpy(chain=b))
        np.testing.assert_allclose(float(samples.log_lh[b]), float(jcond.post.log_likelihood(js)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(samples.log_prior[b]),
                                   float(jcond.post.geo_prior_per_cluster(js.clusters).sum()),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(samples.log_lh), _np(cond.post.log_likelihood(samples)))
