"""Geographic preprocessing: adjacency graphs and distance/cost matrices.

Behavioral counterpart of the reference's ``sbayes/preprocessing.py`` (the
``ComputeNetwork`` class: Delaunay triangulation adjacency + geodesic or
Euclidean distance matrix; custom cost matrices from CSV with
symmetrization).

Implementation notes (TPU-rebuild deltas):
* The reference uses pyproj+cartopy for geodesic distances on an ellipsoid.
  Those libraries are not available here; we implement the projection from
  the source CRS and geodesic distances ourselves: a WGS84 Vincenty inverse
  with haversine fallback — accurate to ~0.5% of the ellipsoidal distance,
  which only scales the cost matrix of the geo-prior.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from numpy.typing import NDArray
from scipy.sparse import csr_matrix
import scipy.spatial as spatial

from sbayes_tpu_torch.utils import PathLike, read_costs_from_csv

WGS84_A = 6378137.0           # semi-major axis [m]
WGS84_F = 1 / 298.257223563   # flattening
WGS84_B = WGS84_A * (1 - WGS84_F)


def compute_delaunay(locations: NDArray[np.float64]) -> csr_matrix:
    """Delaunay triangulation adjacency as a sparse boolean matrix.

    For fewer than 4 points (where qhull fails) a complete graph is returned,
    matching the reference fallback (sbayes/util.py:146-167).
    """
    n = len(locations)
    if n < 4:
        return csr_matrix(1 - np.eye(n, dtype=int))

    delaunay = spatial.Delaunay(locations, qhull_options="QJ Pp")
    indptr, indices = delaunay.vertex_neighbor_vertices
    data = np.ones_like(indices)
    return csr_matrix((data, indices, indptr), shape=(n, n))


def gabriel(distances: NDArray) -> NDArray[np.bool_]:
    """Adjacency matrix of the Gabriel graph from a distance matrix."""
    n = len(distances)
    adj = np.empty((n, n), dtype=bool)
    d_squared = np.asarray(distances) ** 2
    for i in range(n):
        detour = np.min(d_squared[i, :] + d_squared[:, :], axis=-1)
        adj[i, :] = d_squared[i] <= detour
    return adj


def vincenty_inverse(lat1, lon1, lat2, lon2, max_iter: int = 50, tol: float = 1e-12):
    """Vincenty inverse geodesic distance on the WGS84 ellipsoid (vectorized).

    Falls back to the haversine great-circle distance where the iteration
    fails to converge (nearly antipodal points).
    """
    lat1, lon1, lat2, lon2 = map(np.asarray, (lat1, lon1, lat2, lon2))
    phi1, phi2 = np.radians(lat1), np.radians(lat2)
    L = np.radians(lon2 - lon1)

    U1 = np.arctan((1 - WGS84_F) * np.tan(phi1))
    U2 = np.arctan((1 - WGS84_F) * np.tan(phi2))
    sinU1, cosU1 = np.sin(U1), np.cos(U1)
    sinU2, cosU2 = np.sin(U2), np.cos(U2)

    lam = L.copy().astype(float)
    converged = np.zeros(np.broadcast(phi1, phi2, L).shape, dtype=bool)
    sin_sigma = np.zeros_like(lam)
    cos_sigma = np.ones_like(lam)
    sigma = np.zeros_like(lam)
    cos_sq_alpha = np.ones_like(lam)
    cos2sm = np.zeros_like(lam)

    for _ in range(max_iter):
        sin_lam, cos_lam = np.sin(lam), np.cos(lam)
        sin_sigma = np.sqrt(
            (cosU2 * sin_lam) ** 2 + (cosU1 * sinU2 - sinU1 * cosU2 * cos_lam) ** 2
        )
        cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * cos_lam
        sigma = np.arctan2(sin_sigma, cos_sigma)
        with np.errstate(divide="ignore", invalid="ignore"):
            sin_alpha = np.where(sin_sigma != 0, cosU1 * cosU2 * sin_lam / np.maximum(sin_sigma, 1e-300), 0.0)
        cos_sq_alpha = 1 - sin_alpha**2
        with np.errstate(divide="ignore", invalid="ignore"):
            cos2sm = np.where(
                cos_sq_alpha != 0,
                cos_sigma - 2 * sinU1 * sinU2 / np.where(cos_sq_alpha == 0, 1.0, cos_sq_alpha),
                0.0,
            )
        C = WGS84_F / 16 * cos_sq_alpha * (4 + WGS84_F * (4 - 3 * cos_sq_alpha))
        lam_new = L + (1 - C) * WGS84_F * sin_alpha * (
            sigma + C * sin_sigma * (cos2sm + C * cos_sigma * (-1 + 2 * cos2sm**2))
        )
        newly = np.abs(lam_new - lam) < tol
        converged |= newly
        lam = lam_new
        if np.all(converged):
            break

    u_sq = cos_sq_alpha * (WGS84_A**2 - WGS84_B**2) / WGS84_B**2
    A = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    B = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    delta_sigma = (
        B
        * sin_sigma
        * (
            cos2sm
            + B
            / 4
            * (
                cos_sigma * (-1 + 2 * cos2sm**2)
                - B / 6 * cos2sm * (-3 + 4 * sin_sigma**2) * (-3 + 4 * cos2sm**2)
            )
        )
    )
    dist = WGS84_B * A * (sigma - delta_sigma)

    # Haversine fallback where Vincenty failed to converge
    hav = haversine(lat1, lon1, lat2, lon2)
    dist = np.where(converged, dist, hav)
    # Identical points
    same = (lat1 == lat2) & (lon1 == lon2)
    return np.where(same, 0.0, dist)


def haversine(lat1, lon1, lat2, lon2):
    """Great-circle distance on a sphere with WGS84 mean radius [m]."""
    R = (2 * WGS84_A + WGS84_B) / 3
    phi1, phi2 = np.radians(lat1), np.radians(lat2)
    dphi = phi2 - phi1
    dlam = np.radians(np.asarray(lon2) - np.asarray(lon1))
    a = np.sin(dphi / 2) ** 2 + np.cos(phi1) * np.cos(phi2) * np.sin(dlam / 2) ** 2
    return 2 * R * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def _parse_crs(projection: str):
    """Resolve a CRS identifier to 'lonlat', a Projection, or None (planar).

    epsg:4326 / WGS84 identifiers mean the coordinates already are lon/lat
    degrees. proj4 strings are parsed by ``sbayes_tpu_torch.data.proj`` (eqdc,
    lcc, aea, tmerc/utm, merc, eqc families); unsupported CRSs fall back to
    planar with a warning. The reference reprojects with pyproj
    (preprocessing.py:149-155) — but note its documented lat/lon axis-order
    swap for projected CRSs (see proj.py module docstring); we return true
    (lon, lat)."""
    if projection is None:
        return None
    p = projection.strip().lower()
    if "4326" in p or "wgs84" in p or "wgs 84" in p:
        return "lonlat"
    if "proj=" in p or p.startswith("+"):
        from sbayes_tpu_torch.data.proj import Projection

        try:
            prj = Projection(projection)
        except ValueError as err:
            import warnings

            warnings.warn(f"{err}; treating coordinates as planar (Euclidean distances).")
            return None
        return "lonlat" if prj.is_geographic else prj
    return None


class ComputeNetwork:
    """Graph + distance-matrix container for a set of object locations.

    Mirrors the reference's ComputeNetwork (sbayes/preprocessing.py:92-203):
    Delaunay adjacency; Euclidean distances when no CRS is given, geodesic
    distances for geographic coordinates.
    """

    def __init__(self, objects, crs: Optional[str] = "epsg:4326"):
        vertices = objects["id"]
        locations = np.asarray(objects["locations"], dtype=float)
        self.names = vertices

        delaunay = compute_delaunay(locations)
        v1, v2 = delaunay.toarray().nonzero()
        edges = np.column_stack((v1, v2))

        kind = _parse_crs(crs)
        self._dist_kind = kind
        if kind is not None:
            if kind == "lonlat":
                lons, lats = locations[:, 0], locations[:, 1]
            else:  # a parsed Projection: unproject to true lon/lat first
                lons, lats = kind.inverse(locations[:, 0], locations[:, 1])
            self.lat_lon = np.vstack((lons, lats)).T
        else:
            if crs is not None:
                import warnings

                warnings.warn(
                    f"CRS '{crs}' is not supported; treating "
                    f"coordinates as planar (Euclidean distances)."
                )
            self.lat_lon = None

        self.vertices = vertices
        self.edges = edges
        self.locations = locations
        self.adj_mat = delaunay.tocsr()
        self.n = len(vertices)
        self.m = edges.shape[0]
        self._dist_mat = None

    @property
    def dist_mat(self):
        """(N, N) distance matrix, computed lazily on first access — the
        O(N²) buffer is skipped entirely for configs that never read it
        (e.g. a uniform geo prior at the 10k scale-up)."""
        if self._dist_mat is None:
            if self._dist_kind is not None:
                lons, lats = self.lat_lon[:, 0], self.lat_lon[:, 1]
                self._dist_mat = np.asarray(vincenty_inverse(
                    lats[:, None], lons[:, None], lats[None, :], lons[None, :]
                ))
            else:
                from scipy.spatial.distance import cdist

                # cdist writes one (N, N) output with no (N, N, 2) temp
                self._dist_mat = cdist(self.locations, self.locations)
        return self._dist_mat

    def __getitem__(self, key):
        return getattr(self, key)


def read_geo_cost_matrix(object_names, file: PathLike, logger=None) -> NDArray[np.float64]:
    """Read a custom geo cost matrix from CSV, symmetrize if necessary.

    Mirrors reference behavior (sbayes/preprocessing.py:397-421).
    """
    costs = read_costs_from_csv(file, logger=logger)
    assert set(costs.columns) == set(object_names), (
        "Cost matrix columns must match object IDs"
    )
    costs = costs.loc[list(object_names), list(object_names)]
    cost_matrix = np.asarray(costs, dtype=float)

    if not np.allclose(cost_matrix, cost_matrix.T):
        cost_matrix = (cost_matrix + cost_matrix.T) / 2
        if logger:
            logger.info("Cost matrix is not symmetric. Using the average of (i,j) and (j,i).")
    assert np.all(cost_matrix >= 0), "Cost matrix must be non-negative."
    return cost_matrix
