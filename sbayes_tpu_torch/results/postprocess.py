"""Posterior post-processing (reference: sbayes/postprocessing.py).

Copy of ``sbayes_tpu/results/postprocess.py`` (numpy only)."""
from __future__ import annotations

import math

import numpy as np

from sbayes_tpu_torch.utils import get_best_permutation


def compute_dic(lh, burn_in: float) -> float:
    """Deviance information criterion with the posterior mode as point
    estimate (Celeux et al. 2006; reference: postprocessing.py:9-25)."""
    end_bi = math.ceil(len(lh) * burn_in)
    lh = np.asarray(lh)[end_bi:]
    d_phi_pm = -2 * np.max(lh)
    mean_d_phi = -4 * np.mean(lh)
    return float(mean_d_phi + d_phi_pm)


def rank_clusters_by_posterior_frequency(clusters):
    """Order clusters by their mean posterior membership frequency.

    Args:
        clusters: (n_clusters, n_samples, n_objects) boolean array.
    Returns:
        index array ordering clusters from most to least frequent.
    """
    freq = np.asarray(clusters).mean(axis=(1, 2))
    return np.argsort(-freq)


def match_cluster_samples(cluster_samples):
    """Align cluster labels across a sequence of samples via running-sum
    Hungarian matching (the same alignment the loggers perform online).

    Args:
        cluster_samples: (n_samples, n_clusters, n_objects) boolean array.
    Returns:
        aligned array of the same shape.
    """
    cluster_samples = np.asarray(cluster_samples)
    n_samples, n_clusters, n_objects = cluster_samples.shape
    aligned = np.empty_like(cluster_samples)
    cluster_sum = np.zeros((n_clusters, n_objects), dtype=int)
    for i in range(n_samples):
        perm = get_best_permutation(cluster_samples[i], cluster_sum)
        aligned[i] = cluster_samples[i][perm]
        cluster_sum += aligned[i]
    return aligned
