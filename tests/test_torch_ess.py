"""The port's ESS diagnostics (``results/ess.py``) and posterior
post-processing (``results/postprocess.py``) against the JAX package's
modules on the same numpy arrays: both are numpy only, so every value is
equal within rtol 1e-12 (the same operations in the same order)."""
import numpy as np
import pytest

import sbayes_tpu.results.ess as jax_ess
import sbayes_tpu.results.postprocess as jax_post
import sbayes_tpu_torch.results.ess as ess
import sbayes_tpu_torch.results.postprocess as post

RTOL = 1e-12


def ar1(rng, n_chains, n, phi, offsets=None):
    """(n_chains, n) AR(1) series with coefficient ``phi``, each chain
    shifted by ``offsets`` (unconverged ensembles)."""
    x = np.zeros((n_chains, n))
    eps = rng.normal(size=(n_chains, n))
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    return x + (0.0 if offsets is None else offsets[:, None])


SERIES = {
    "white": lambda rng: rng.normal(size=(8, 500)),
    "ar1_0.5": lambda rng: ar1(rng, 8, 500, 0.5),
    "ar1_0.95": lambda rng: ar1(rng, 16, 300, 0.95),
    "antithetic": lambda rng: ar1(rng, 4, 257, -0.6),
    "unconverged": lambda rng: ar1(rng, 6, 400, 0.3, offsets=np.arange(6) * 2.0),
    "short": lambda rng: rng.normal(size=(3, 3)),
    "constant": lambda rng: np.full((4, 50), 1.5),
}


@pytest.fixture(params=sorted(SERIES), ids=sorted(SERIES))
def series(request):
    return SERIES[request.param](np.random.default_rng(len(request.param)))


def test_autocorrelation_equals_jax(series):
    for row in series:
        np.testing.assert_allclose(ess.autocorrelation(row), jax_ess.autocorrelation(row),
                                   rtol=RTOL, atol=0)


def test_effective_sample_size_equals_jax(series):
    np.testing.assert_allclose(ess.effective_sample_size(series),
                               jax_ess.effective_sample_size(series), rtol=RTOL)
    np.testing.assert_allclose(ess.effective_sample_size(series[0]),
                               jax_ess.effective_sample_size(series[0]), rtol=RTOL)


def test_multichain_ess_and_split_rhat_equal_jax(series):
    got, want = ess.multichain_ess(series), jax_ess.multichain_ess(series)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert 0 < got <= series.size
    np.testing.assert_allclose(ess.split_rhat(series), jax_ess.split_rhat(series), rtol=RTOL)


def test_unconverged_ensemble_is_penalised():
    """Between-chain disagreement lowers the multichain ESS and raises R-hat."""
    rng = np.random.default_rng(0)
    agree = ar1(rng, 6, 400, 0.3)
    apart = agree + np.arange(6)[:, None] * 2.0
    assert ess.multichain_ess(apart) < 0.2 * ess.multichain_ess(agree)
    assert ess.split_rhat(apart) > 1.5 > 1.05 > ess.split_rhat(agree)


@pytest.mark.parametrize("burn_in", [0.0, 0.1, 0.5])
def test_compute_dic_equals_jax(burn_in):
    lh = -1000 + np.random.default_rng(3).normal(size=200).cumsum()
    np.testing.assert_allclose(post.compute_dic(lh, burn_in), jax_post.compute_dic(lh, burn_in),
                               rtol=RTOL)


def test_cluster_ranking_and_matching_equal_jax():
    """Samples of three clusters whose labels are permuted at random between
    samples: the running-sum Hungarian matching recovers one labelling, the
    same as the JAX package's, and the ranking by frequency agrees."""
    rng = np.random.default_rng(4)
    base = np.zeros((3, 30), bool)
    base[0, :12], base[1, 12:18], base[2, 20:23] = True, True, True
    samples = []
    for _ in range(40):
        s = base ^ (rng.random(base.shape) < 0.05)
        samples.append(s[rng.permutation(3)])
    samples = np.stack(samples)
    aligned = post.match_cluster_samples(samples)
    np.testing.assert_array_equal(aligned, jax_post.match_cluster_samples(samples))
    assert (aligned.sum(-1).mean(0)[None] > 0).all()
    per_cluster = aligned.transpose(1, 0, 2)                     # (clusters, samples, objects)
    order = post.rank_clusters_by_posterior_frequency(per_cluster)
    np.testing.assert_array_equal(order, jax_post.rank_clusters_by_posterior_frequency(
        per_cluster))
    sizes = per_cluster.sum(-1).mean(-1)
    assert (np.diff(sizes[order]) <= 0).all()
