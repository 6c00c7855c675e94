"""The benchmark's arithmetic: peaks of the card, the bytes and operations
of the marginal kernel, the bytes of a chain's state and the multichain
ESS. Numpy only; frozen copies where the program has the same arithmetic
(named at each function)."""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def roofline_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S)


def effect_cells_read(values: np.ndarray, group_of: np.ndarray) -> tuple:
    """(cluster-effect cells, confounder-effect cells) per chain and effect
    row that the data make the marginal read: the (f, s) pairs some object
    shows, and the (group, f, s) cells some member of the group shows.
    ``group_of`` (C-1, N): each object's group, -1 for none. Frozen copy of
    ``sbayes_tpu_torch/ops/marginal.py: effect_cells_read``."""
    N, F, S = values.shape
    observed = values.any(-1)
    fi = np.where(observed, values.argmax(-1), S)
    f_ar = np.arange(F)[None]
    p_cells = np.unique((f_ar * S + fi)[observed]).size
    conf_cells = 0
    for gi in group_of:
        ok = observed & (gi[:, None] >= 0)
        conf_cells += np.unique(((gi[:, None] * F + f_ar) * S + fi)[ok]).size
    return p_cells, conf_cells


def marginal_rows(ratio: bool, two_eff: bool) -> int:
    return 1 if (ratio and not two_eff) else 2


def marginal_bytes(cells: tuple, N: int, F: int, C: int, B: int, ratio=True, two_eff=False,
                   heat=False) -> int:
    """Bytes one marginal launch over B chains must move: each input cell it
    needs read once, the output written once. Frozen copy of
    ``sbayes_tpu_torch/ops/marginal.py: bytes_moved``."""
    p_cells, conf_cells = cells
    per_chain = 4 * (marginal_rows(ratio, two_eff) * p_cells + conf_cells + F * C + 2 * N * C
                     + N + (1 if heat else 0) + N * (1 if ratio else 2))
    return B * per_chain + N * F + 4 * (C - 1) * N


def marginal_operations(N: int, F: int, C: int, B: int, ratio=True, two_eff=False,
                        heat=False) -> int:
    """f32 operations of one marginal launch. Frozen copy of
    ``sbayes_tpu_torch/ops/marginal.py: operations``."""
    per_elem = 8 * C + (6 if ratio else 8) + (4 if heat else 0) * marginal_rows(ratio, two_eff)
    return B * N * F * per_elem


def state_bytes_per_chain(K: int, N: int, F: int, S: int, C: int, n_groups: int) -> int:
    """Bytes of one chain's state as the configuration's shapes fix it,
    whatever implements it: memberships (one byte each), weights (f32),
    the source (one byte a cell) and the collapsed counts (f32) of the K
    clusters and the ``n_groups`` confounder groups."""
    return K * N + 4 * F * C + N * F + 4 * (K + n_groups) * F * S


def multichain_ess(x) -> float:
    """Multichain effective sample size of ``x`` (chains, samples) (Stan's,
    Vehtari et al. 2021; Geyer's initial monotone sequence). Frozen copy of
    ``sbayes_tpu_torch/results/ess.py: multichain_ess``."""
    x = np.asarray(x, dtype=float)
    m, n = x.shape
    if n < 4:
        return float(m)
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = n * chain_means.var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b / n
    if var_plus <= 0 or w <= 0:
        return float(m * n)
    xc = x - chain_means[:, None]
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), axis=1)[:, :n].real / n
    rho = 1.0 - (w - acov.mean(axis=0)) / var_plus
    max_pairs = n // 2
    p = rho[0: 2 * max_pairs: 2] + rho[1: 2 * max_pairs: 2]
    positive = p > 0
    cutoff = len(p) if positive.all() else max(int(np.argmin(positive)), 1)
    p = np.minimum.accumulate(p[:cutoff])
    tau = max(2.0 * p.sum() - 1.0, 1e-3)
    return float(min(m * n / tau, m * n))
