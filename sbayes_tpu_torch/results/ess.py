"""Effective sample size and MCMC diagnostics.

Copy of ``sbayes_tpu/results/ess.py`` (numpy only, identical numbers). The
reference delegates ESS/convergence to the external Tracer tool on the
stats files (user manual); here ESS is first-class so throughput can be
reported as ESS/sec. Standard definitions: autocorrelation via FFT and
Geyer's initial monotone positive sequence estimator; split-R-hat.
"""
from __future__ import annotations

import numpy as np
from numpy.typing import NDArray


def autocorrelation(x: NDArray) -> NDArray:
    """Normalized autocorrelation function of a 1-D series (FFT-based)."""
    x = np.asarray(x, dtype=float)
    n = len(x)
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f))[:n].real / n
    if acov[0] <= 0:
        return np.zeros(n)
    return acov / acov[0]


def effective_sample_size(x: NDArray) -> float:
    """ESS of one chain (or summed over chains if 2-D: (chains, samples)).

    Uses Geyer's initial monotone positive sequence truncation.
    """
    x = np.asarray(x, dtype=float)
    if x.ndim == 2:
        return float(sum(effective_sample_size(xi) for xi in x))
    n = len(x)
    if n < 4 or np.allclose(x, x[0]):
        return float(n)

    rho = autocorrelation(x)
    # pair sums Gamma_k = rho[2k] + rho[2k+1]
    max_pairs = (n - 1) // 2
    gamma = rho[1 : 2 * max_pairs + 1 : 2][:max_pairs] + rho[2 : 2 * max_pairs + 2 : 2][:max_pairs]
    # initial positive sequence
    positive = gamma > 0
    if positive.all():
        cutoff = len(gamma)
    else:
        cutoff = int(np.argmin(positive))
    gamma = gamma[:cutoff]
    # initial monotone sequence
    gamma = np.minimum.accumulate(gamma) if len(gamma) else gamma

    tau = 1.0 + 2.0 * gamma.sum() - rho[0]  # = -1 + 2*sum(Gamma) with rho[0]=1 folded in
    tau = max(tau, 1.0 / n)
    return float(min(n / tau, n))


def multichain_ess(x: NDArray) -> float:
    """Multi-chain effective sample size (Stan-style, Vehtari et al. 2021).

    Combines within-chain autocorrelation with between-chain variance, so
    unconverged ensembles are penalized (each extra chain only counts as
    independent if the chains actually agree). x shape: (chains, samples).
    """
    x = np.asarray(x, dtype=float)
    m, n = x.shape
    if n < 4:
        return float(m)
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * W + B / n
    if var_plus <= 0 or W <= 0:
        return float(m * n)

    # mean autocovariance across chains (biased, FFT)
    xc = x - chain_means[:, None]
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), axis=1)[:, :n].real / n
    mean_acov = acov.mean(axis=0)

    rho = 1.0 - (W - mean_acov) / var_plus  # rho[0] == 1 up to fp error
    # Geyer initial monotone positive sequence on pair sums
    # P_k = rho[2k] + rho[2k+1]; tau = 2 * sum(P) - 1
    max_pairs = n // 2
    P = rho[0 : 2 * max_pairs : 2] + rho[1 : 2 * max_pairs : 2]
    positive = P > 0
    cutoff = len(P) if positive.all() else max(int(np.argmin(positive)), 1)
    P = np.minimum.accumulate(P[:cutoff])
    tau = max(2.0 * P.sum() - 1.0, 1e-3)
    return float(min(m * n / tau, m * n))


def split_rhat(x: NDArray) -> float:
    """Split-R-hat over chains: x shape (chains, samples)."""
    x = np.asarray(x, dtype=float)
    m, n = x.shape
    half = n // 2
    splits = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)  # (2m, half)
    chain_means = splits.mean(axis=1)
    chain_vars = splits.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = half * chain_means.var(ddof=1)
    var_plus = (half - 1) / half * W + B / half
    if W <= 0:
        return 1.0
    return float(np.sqrt(var_plus / W))
