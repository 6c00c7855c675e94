"""Geodesic distances on the WGS84 ellipsoid (Vincenty's inverse formula,
haversine where it does not converge). A frozen copy of the arithmetic of
``sbayes_tpu_torch/data/geo.py`` (``vincenty_inverse``, ``haversine``)."""
from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1 / 298.257223563
WGS84_B = WGS84_A * (1 - WGS84_F)


def haversine(lat1, lon1, lat2, lon2):
    r = (2 * WGS84_A + WGS84_B) / 3
    phi1, phi2 = np.radians(lat1), np.radians(lat2)
    dphi = phi2 - phi1
    dlam = np.radians(np.asarray(lon2) - np.asarray(lon1))
    a = np.sin(dphi / 2) ** 2 + np.cos(phi1) * np.cos(phi2) * np.sin(dlam / 2) ** 2
    return 2 * r * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def vincenty(lat1, lon1, lat2, lon2, max_iter: int = 50, tol: float = 1e-12):
    lat1, lon1, lat2, lon2 = map(np.asarray, (lat1, lon1, lat2, lon2))
    phi1, phi2 = np.radians(lat1), np.radians(lat2)
    big_l = np.radians(lon2 - lon1)
    u1 = np.arctan((1 - WGS84_F) * np.tan(phi1))
    u2 = np.arctan((1 - WGS84_F) * np.tan(phi2))
    sin_u1, cos_u1, sin_u2, cos_u2 = np.sin(u1), np.cos(u1), np.sin(u2), np.cos(u2)
    lam = big_l.copy().astype(float)
    converged = np.zeros(np.broadcast(phi1, phi2, big_l).shape, dtype=bool)
    sin_sigma = np.zeros_like(lam)
    cos_sigma = np.ones_like(lam)
    sigma = np.zeros_like(lam)
    cos_sq_alpha = np.ones_like(lam)
    cos2sm = np.zeros_like(lam)
    for _ in range(max_iter):
        sin_lam, cos_lam = np.sin(lam), np.cos(lam)
        sin_sigma = np.sqrt((cos_u2 * sin_lam) ** 2
                            + (cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_lam) ** 2)
        cos_sigma = sin_u1 * sin_u2 + cos_u1 * cos_u2 * cos_lam
        sigma = np.arctan2(sin_sigma, cos_sigma)
        with np.errstate(divide="ignore", invalid="ignore"):
            sin_alpha = np.where(sin_sigma != 0,
                                 cos_u1 * cos_u2 * sin_lam / np.maximum(sin_sigma, 1e-300), 0.0)
        cos_sq_alpha = 1 - sin_alpha ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            cos2sm = np.where(cos_sq_alpha != 0,
                              cos_sigma - 2 * sin_u1 * sin_u2
                              / np.where(cos_sq_alpha == 0, 1.0, cos_sq_alpha), 0.0)
        c = WGS84_F / 16 * cos_sq_alpha * (4 + WGS84_F * (4 - 3 * cos_sq_alpha))
        lam_new = big_l + (1 - c) * WGS84_F * sin_alpha * (
            sigma + c * sin_sigma * (cos2sm + c * cos_sigma * (-1 + 2 * cos2sm ** 2)))
        converged |= np.abs(lam_new - lam) < tol
        lam = lam_new
        if np.all(converged):
            break
    u_sq = cos_sq_alpha * (WGS84_A ** 2 - WGS84_B ** 2) / WGS84_B ** 2
    a = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    b = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    delta_sigma = b * sin_sigma * (cos2sm + b / 4 * (
        cos_sigma * (-1 + 2 * cos2sm ** 2)
        - b / 6 * cos2sm * (-3 + 4 * sin_sigma ** 2) * (-3 + 4 * cos2sm ** 2)))
    dist = WGS84_B * a * (sigma - delta_sigma)
    dist = np.where(converged, dist, haversine(lat1, lon1, lat2, lon2))
    same = (lat1 == lat2) & (lon1 == lon2)
    return np.where(same, 0.0, dist)


def cost_matrix(locations, geodesic: bool) -> np.ndarray:
    """(N, N) float64 distances between the objects: geodesic for
    (longitude, latitude) degrees, else Euclidean."""
    loc = np.asarray(locations, dtype=float)
    if not geodesic:
        d = loc[:, None, :] - loc[None, :, :]
        return np.sqrt((d ** 2).sum(-1))
    lon, lat = loc[:, 0], loc[:, 1]
    return np.asarray(vincenty(lat[:, None], lon[:, None], lat[None, :], lon[None, :]))
