"""Pareto-smoothed importance sampling (PSIS) and PSIS-LOO.

Self-contained implementation of Vehtari, Gelman & Gabry (2017)
"Practical Bayesian model evaluation using leave-one-out cross-validation
and WAIC" — replaces the reference ELPD tool's arviz dependency
(reference: sbayes/tools/elpd.py uses az.loo). Copy of
``sbayes_tpu/tools/psis.py`` for the PyTorch port (numpy and scipy only).

The generalized-Pareto fit is the Zhang & Stephens (2009) quadrature
posterior-mean estimator (the standard choice in PSIS implementations),
with the usual weak-prior adjustment shrinking khat towards 0.5.
"""
from __future__ import annotations

import numpy as np
from numpy.typing import NDArray
from scipy.special import logsumexp


def gpd_fit(x: NDArray) -> tuple[float, float]:
    """Fit a generalized Pareto distribution to exceedances ``x`` (> 0).

    Returns (k, sigma): shape and scale in the "modern xi" convention
    (k > 0 means heavy tail).
    """
    x = np.sort(np.asarray(x, dtype=float))
    n = len(x)
    if n < 5 or x[-1] <= 0:
        return np.inf, np.nan
    prior_bs = 3.0
    prior_k = 10.0
    m_est = 30 + int(np.sqrt(n))

    b = 1 - np.sqrt(m_est / (np.arange(1, m_est + 1) - 0.5))
    b = b / (prior_bs * x[int(n / 4 + 0.5) - 1]) + 1 / x[-1]

    # Profile likelihood over the quadrature points.
    # Note the sign convention: k(b) = E[log(1 - b x)] is negative for b > 0,
    # so -(b / k) is always positive and the log is well-defined.
    k = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
    len_scale = n * (np.log(-(b / k)) - k - 1)
    with np.errstate(over="ignore"):
        weights = 1 / np.exp(len_scale - len_scale[:, None]).sum(axis=1)
    weights = weights / weights.sum()

    b_post = np.sum(b * weights)
    k_post = np.mean(np.log1p(-b_post * x))
    # Posterior-mean adjustment: shrink khat towards 0.5 with 10 pseudo-obs.
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    sigma = -k_post / b_post
    return float(k_post), float(sigma)


def _gpd_inv_cdf(p: NDArray, k: float, sigma: float) -> NDArray:
    """Inverse CDF of the generalized Pareto distribution (mu = 0)."""
    if abs(k) < 1e-12:
        return -sigma * np.log1p(-p)
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def psislw(log_weights: NDArray) -> tuple[NDArray, float]:
    """Pareto-smooth one vector of log importance weights.

    Returns (smoothed log weights normalized to logsumexp = 0, khat).
    """
    lw = np.asarray(log_weights, dtype=float).copy()
    n = len(lw)
    lw -= lw.max()

    # tail size per Vehtari et al.: min(n/5, 3*sqrt(n))
    n_tail = int(min(0.2 * n, 3 * np.sqrt(n)))
    if n_tail < 5:
        return lw - logsumexp(lw), np.inf

    order = np.argsort(lw)
    tail_ids = order[-n_tail:]
    cutoff = lw[order[-n_tail - 1]]

    exceedances = np.exp(lw[tail_ids]) - np.exp(cutoff)
    k, sigma = gpd_fit(exceedances)

    if np.isfinite(k):
        # replace tail weights by expected order statistics of the fit
        p = (np.arange(1, n_tail + 1) - 0.5) / n_tail
        smoothed = np.log(_gpd_inv_cdf(p, k, sigma) + np.exp(cutoff))
        # assign in ascending order to the (ascending) tail positions
        lw[tail_ids[np.argsort(lw[tail_ids])]] = np.sort(smoothed)
    # truncate at the max raw weight (0 after shifting)
    lw = np.minimum(lw, 0.0)
    return lw - logsumexp(lw), k


def psis_loo(log_lik: NDArray) -> tuple[float, NDArray, NDArray]:
    """PSIS-LOO expected log pointwise predictive density.

    Args:
        log_lik: (n_samples, n_observations) pointwise log-likelihoods.
    Returns:
        (elpd_loo, pointwise elpd_i, khat diagnostics).
    """
    log_lik = np.asarray(log_lik, dtype=float)
    S, n = log_lik.shape
    elpd_i = np.empty(n)
    khats = np.empty(n)
    for i in range(n):
        lw, k = psislw(-log_lik[:, i])
        elpd_i[i] = logsumexp(lw + log_lik[:, i])
        khats[i] = k
    return float(elpd_i.sum()), elpd_i, khats
