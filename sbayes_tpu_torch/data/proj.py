"""Minimal map-projection engine: proj4-string parsing + inverse projections.

The reference reprojects any data CRS to lon/lat with pyproj before
computing geodesic distances (sbayes/preprocessing.py:149-155). pyproj is
not available here, so we implement the inverse projections ourselves for
the proj4 families the experiments use (``eqdc`` for south_america) plus
the common conics/cylindricals: ``lcc``, ``aea``, ``tmerc``/``utm``,
``merc``, ``eqc`` and ``longlat``. Formulas follow Snyder, *Map
Projections — A Working Manual* (USGS PP 1395).

Documented divergence from the reference: with pyproj >= 2 the reference's
``Transformer.from_crs(crs, "epsg:4326")`` returns coordinates in the
EPSG-authority (lat, lon) axis order, but preprocessing.py:151 unpacks
them as ``lons, lats`` — i.e. for every *projected* CRS the reference
feeds lat/lon-swapped coordinates to the geodesic. We deliberately do NOT
replicate that swap; this module returns true (lon, lat).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# name -> (a, 1/f); 1/f = 0 means sphere
ELLIPSOIDS = {
    "wgs84": (6378137.0, 298.257223563),
    "grs80": (6378137.0, 298.257222101),
    "aust_sa": (6378160.0, 298.25),
    "clrk66": (6378206.4, 294.9786982),
    "clrk80": (6378249.145, 293.465),
    "intl": (6378388.0, 297.0),
    "bessel": (6377397.155, 299.1528128),
    "krass": (6378245.0, 298.3),
    "airy": (6377563.396, 299.3249646),
    "sphere": (6370997.0, 0.0),
}
DATUM_ELLPS = {"wgs84": "wgs84", "nad83": "grs80", "nad27": "clrk66", "potsdam": "bessel"}


@dataclass
class ProjParams:
    proj: str
    a: float
    e2: float
    lat_0: float = 0.0
    lon_0: float = 0.0
    lat_1: float = 0.0
    lat_2: float = 0.0
    lat_ts: float = 0.0
    x_0: float = 0.0
    y_0: float = 0.0
    k_0: float = 1.0
    to_meter: float = 1.0

    @property
    def e(self):
        return np.sqrt(self.e2)


def parse_proj4(s: str) -> ProjParams:
    """Parse the subset of proj4 keys needed for the supported inverses."""
    kv = {}
    for tok in s.split():
        tok = tok.lstrip("+")
        if "=" in tok:
            k, v = tok.split("=", 1)
            kv[k] = v
        else:
            kv[tok] = True

    proj = str(kv.get("proj", "longlat")).lower()

    a = rf = b = None
    ellps = str(kv.get("ellps", "")).lower()
    datum = str(kv.get("datum", "")).lower()
    if not ellps and datum in DATUM_ELLPS:
        ellps = DATUM_ELLPS[datum]
    if ellps:
        if ellps not in ELLIPSOIDS:
            raise ValueError(f"Unknown ellipsoid '{ellps}' in projection '{s}'")
        a, rf = ELLIPSOIDS[ellps]
    if "a" in kv:
        a = float(kv["a"])
    if "rf" in kv:
        rf = float(kv["rf"])
    if "b" in kv:
        b = float(kv["b"])
    if "R" in kv:
        a, rf = float(kv["R"]), 0.0
    if a is None:
        a, rf = ELLIPSOIDS["grs80"]  # PROJ's default ellipsoid
    if b is not None:
        f = (a - b) / a
    elif rf in (None, 0.0):
        f = 0.0
    else:
        f = 1.0 / rf
    e2 = f * (2 - f)

    to_meter = float(kv.get("to_meter", 1.0))
    units = str(kv.get("units", "m")).lower()
    if units == "km":
        to_meter = 1000.0
    elif units not in ("m", "meter", "metre"):
        raise ValueError(f"Unsupported +units={units} in projection '{s}'")

    k_0 = float(kv.get("k_0", kv.get("k", 1.0)))
    p = ProjParams(
        proj=proj, a=a, e2=e2,
        lat_0=np.radians(float(kv.get("lat_0", 0.0))),
        lon_0=np.radians(float(kv.get("lon_0", 0.0))),
        lat_1=np.radians(float(kv.get("lat_1", 0.0))),
        lat_2=np.radians(float(kv.get("lat_2", kv.get("lat_1", 0.0)))),
        lat_ts=np.radians(float(kv.get("lat_ts", 0.0))),
        x_0=float(kv.get("x_0", 0.0)),
        y_0=float(kv.get("y_0", 0.0)),
        k_0=k_0, to_meter=to_meter,
    )
    if proj == "utm":
        zone = int(kv["zone"])
        p.proj = "tmerc"
        p.lon_0 = np.radians(zone * 6 - 183)
        p.k_0 = 0.9996
        p.x_0 = 500_000.0
        p.y_0 = 10_000_000.0 if "south" in kv else 0.0
        p.lat_0 = 0.0
    return p


# ----------------------------------------------------------------------
# Snyder building blocks
# ----------------------------------------------------------------------

def _m(p: ProjParams, phi):
    return np.cos(phi) / np.sqrt(1 - p.e2 * np.sin(phi) ** 2)


def _M(p: ProjParams, phi):
    """Meridian arc length from the equator (Snyder 3-21)."""
    e2, e4, e6 = p.e2, p.e2**2, p.e2**3
    return p.a * (
        (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
        - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * phi)
        + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * phi)
        - (35 * e6 / 3072) * np.sin(6 * phi)
    )


def _phi_from_M(p: ProjParams, M):
    """Footpoint latitude from meridian arc (Snyder 3-26, rectifying series)."""
    e2 = p.e2
    mu = M / (p.a * (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256))
    e1 = (1 - np.sqrt(1 - e2)) / (1 + np.sqrt(1 - e2))
    return (
        mu
        + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
        + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
        + (151 * e1**3 / 96) * np.sin(6 * mu)
        + (1097 * e1**4 / 512) * np.sin(8 * mu)
    )


def _t(p: ProjParams, phi):
    """Isometric-latitude helper for conformal projections (Snyder 15-9)."""
    e = p.e
    esin = e * np.sin(phi)
    return np.tan(np.pi / 4 - phi / 2) / ((1 - esin) / (1 + esin)) ** (e / 2)


def _phi_from_t(p: ProjParams, t, n_iter: int = 15):
    """Invert Snyder 15-9 by fixed-point iteration (7-9)."""
    e = p.e
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(n_iter):
        esin = e * np.sin(phi)
        phi = np.pi / 2 - 2 * np.arctan(t * ((1 - esin) / (1 + esin)) ** (e / 2))
    return phi


def _q(p: ProjParams, phi):
    """Authalic-latitude helper for equal-area projections (Snyder 3-12)."""
    if p.e2 == 0:
        return 2 * np.sin(phi)
    e, e2 = p.e, p.e2
    sinp = np.sin(phi)
    return (1 - e2) * (
        sinp / (1 - e2 * sinp**2) - (1 / (2 * e)) * np.log((1 - e * sinp) / (1 + e * sinp))
    )


def _phi_from_q(p: ProjParams, q, n_iter: int = 15):
    """Invert Snyder 3-12 by Newton iteration (3-16)."""
    if p.e2 == 0:
        return np.arcsin(np.clip(q / 2, -1, 1))
    e, e2 = p.e, p.e2
    q_p = _q(p, np.pi / 2)
    phi = np.arcsin(np.clip(q / 2, -1, 1))
    for _ in range(n_iter):
        sinp = np.sin(phi)
        esin2 = 1 - e2 * sinp**2
        dphi = (
            esin2**2 / (2 * np.cos(phi))
            * (q / (1 - e2) - sinp / esin2 + (1 / (2 * e)) * np.log((1 - e * sinp) / (1 + e * sinp)))
        )
        # clamp near the poles where cos(phi) -> 0
        phi = np.clip(phi + np.where(np.isfinite(dphi), dphi, 0.0), -np.pi / 2, np.pi / 2)
    _ = q_p
    return phi


# ----------------------------------------------------------------------
# Projections: forward (lon,lat)->(x,y) and inverse (x,y)->(lon,lat),
# all angles in radians internally; public API in degrees & meters.
# ----------------------------------------------------------------------

def _eqdc_constants(p: ProjParams):
    m1, m2 = _m(p, p.lat_1), _m(p, p.lat_2)
    M1, M2 = _M(p, p.lat_1), _M(p, p.lat_2)
    if abs(p.lat_1 - p.lat_2) < 1e-12:
        n = np.sin(p.lat_1)
    else:
        n = p.a * (m1 - m2) / (M2 - M1)
    G = m1 / n + M1 / p.a
    rho0 = p.a * G - _M(p, p.lat_0)
    return n, G, rho0


def _eqdc_fwd(p, lam, phi):
    n, G, rho0 = _eqdc_constants(p)
    rho = p.a * G - _M(p, phi)
    theta = n * (lam - p.lon_0)
    return rho * np.sin(theta), rho0 - rho * np.cos(theta)


def _eqdc_inv(p, x, y):
    n, G, rho0 = _eqdc_constants(p)
    sign = np.sign(n) if n != 0 else 1.0
    rho = sign * np.sqrt(x**2 + (rho0 - y) ** 2)
    theta = np.arctan2(sign * x, sign * (rho0 - y))
    M = p.a * G - rho
    phi = _phi_from_M(p, M)
    lam = p.lon_0 + theta / n
    return lam, phi


def _lcc_constants(p: ProjParams):
    m1 = _m(p, p.lat_1)
    t0, t1, t2 = _t(p, p.lat_0), _t(p, p.lat_1), _t(p, p.lat_2)
    if abs(p.lat_1 - p.lat_2) < 1e-12:
        n = np.sin(p.lat_1)
    else:
        m2 = _m(p, p.lat_2)
        n = np.log(m1 / m2) / np.log(t1 / t2)
    F = m1 / (n * t1**n)
    rho0 = p.a * F * t0**n * p.k_0
    return n, F, rho0


def _lcc_fwd(p, lam, phi):
    n, F, rho0 = _lcc_constants(p)
    rho = p.a * F * _t(p, phi) ** n * p.k_0
    theta = n * (lam - p.lon_0)
    return rho * np.sin(theta), rho0 - rho * np.cos(theta)


def _lcc_inv(p, x, y):
    n, F, rho0 = _lcc_constants(p)
    sign = np.sign(n) if n != 0 else 1.0
    rho = sign * np.sqrt(x**2 + (rho0 - y) ** 2)
    theta = np.arctan2(sign * x, sign * (rho0 - y))
    t = (rho / (p.a * F * p.k_0)) ** (1.0 / n)
    phi = _phi_from_t(p, t)
    lam = p.lon_0 + theta / n
    return lam, phi


def _aea_constants(p: ProjParams):
    m1 = _m(p, p.lat_1)
    q0, q1, q2 = _q(p, p.lat_0), _q(p, p.lat_1), _q(p, p.lat_2)
    if abs(p.lat_1 - p.lat_2) < 1e-12:
        n = np.sin(p.lat_1)
    else:
        m2 = _m(p, p.lat_2)
        n = (m1**2 - m2**2) / (q2 - q1)
    C = m1**2 + n * q1
    rho0 = p.a * np.sqrt(C - n * q0) / n
    return n, C, rho0


def _aea_fwd(p, lam, phi):
    n, C, rho0 = _aea_constants(p)
    rho = p.a * np.sqrt(C - n * _q(p, phi)) / n
    theta = n * (lam - p.lon_0)
    return rho * np.sin(theta), rho0 - rho * np.cos(theta)


def _aea_inv(p, x, y):
    n, C, rho0 = _aea_constants(p)
    sign = np.sign(n) if n != 0 else 1.0
    rho = np.sqrt(x**2 + (rho0 - y) ** 2)
    theta = np.arctan2(sign * x, sign * (rho0 - y))
    q = (C - (rho * n / p.a) ** 2) / n
    phi = _phi_from_q(p, q)
    lam = p.lon_0 + theta / n
    return lam, phi


def _tmerc_fwd(p, lam, phi):
    e2 = p.e2
    ep2 = e2 / (1 - e2)
    N = p.a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    T = np.tan(phi) ** 2
    C = ep2 * np.cos(phi) ** 2
    A = (lam - p.lon_0) * np.cos(phi)
    M, M0 = _M(p, phi), _M(p, p.lat_0)
    x = p.k_0 * N * (
        A + (1 - T + C) * A**3 / 6
        + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * A**5 / 120
    )
    y = p.k_0 * (
        M - M0 + N * np.tan(phi) * (
            A**2 / 2 + (5 - T + 9 * C + 4 * C**2) * A**4 / 24
            + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * A**6 / 720
        )
    )
    return x, y


def _tmerc_inv(p, x, y):
    e2 = p.e2
    ep2 = e2 / (1 - e2)
    M = _M(p, p.lat_0) + y / p.k_0
    phi1 = _phi_from_M(p, M)
    sin1, cos1, tan1 = np.sin(phi1), np.cos(phi1), np.tan(phi1)
    C1 = ep2 * cos1**2
    T1 = tan1**2
    N1 = p.a / np.sqrt(1 - e2 * sin1**2)
    R1 = p.a * (1 - e2) / (1 - e2 * sin1**2) ** 1.5
    D = x / (N1 * p.k_0)
    phi = phi1 - (N1 * tan1 / R1) * (
        D**2 / 2
        - (5 + 3 * T1 + 10 * C1 - 4 * C1**2 - 9 * ep2) * D**4 / 24
        + (61 + 90 * T1 + 298 * C1 + 45 * T1**2 - 252 * ep2 - 3 * C1**2) * D**6 / 720
    )
    lam = p.lon_0 + (
        D - (1 + 2 * T1 + C1) * D**3 / 6
        + (5 - 2 * C1 + 28 * T1 - 3 * C1**2 + 8 * ep2 + 24 * T1**2) * D**5 / 120
    ) / cos1
    return lam, phi


def _merc_k0(p: ProjParams):
    if p.lat_ts != 0.0:
        return _m(p, p.lat_ts)
    return p.k_0


def _merc_fwd(p, lam, phi):
    k0 = _merc_k0(p)
    x = p.a * k0 * (lam - p.lon_0)
    y = -p.a * k0 * np.log(_t(p, phi))
    return x, y


def _merc_inv(p, x, y):
    k0 = _merc_k0(p)
    t = np.exp(-y / (p.a * k0))
    phi = _phi_from_t(p, t)
    lam = p.lon_0 + x / (p.a * k0)
    return lam, phi


def _eqc_fwd(p, lam, phi):
    c = np.cos(p.lat_ts)
    return p.a * (lam - p.lon_0) * c, p.a * (phi - p.lat_0)


def _eqc_inv(p, x, y):
    c = np.cos(p.lat_ts)
    return p.lon_0 + x / (p.a * c), p.lat_0 + y / p.a


_PROJS = {
    "eqdc": (_eqdc_fwd, _eqdc_inv),
    "lcc": (_lcc_fwd, _lcc_inv),
    "aea": (_aea_fwd, _aea_inv),
    "tmerc": (_tmerc_fwd, _tmerc_inv),
    "merc": (_merc_fwd, _merc_inv),
    "eqc": (_eqc_fwd, _eqc_inv),
}


class Projection:
    """A parsed proj4 CRS with vectorized forward/inverse transforms."""

    def __init__(self, proj4_string: str):
        self.definition = proj4_string
        self.params = parse_proj4(proj4_string)
        proj = self.params.proj
        if proj in ("longlat", "latlong", "lonlat"):
            self._fwd = self._inv = None
        elif proj in _PROJS:
            self._fwd, self._inv = _PROJS[proj]
        else:
            raise ValueError(
                f"Projection family '+proj={proj}' is not supported "
                f"(supported: longlat, {', '.join(sorted(_PROJS))}, utm)"
            )

    @property
    def is_geographic(self) -> bool:
        return self._inv is None

    def inverse(self, x, y):
        """Projected (x, y) -> (lon, lat) in degrees."""
        if self.is_geographic:
            return np.asarray(x, float), np.asarray(y, float)
        p = self.params
        xm = np.asarray(x, float) * p.to_meter - p.x_0
        ym = np.asarray(y, float) * p.to_meter - p.y_0
        lam, phi = self._inv(p, xm, ym)
        return np.degrees(lam), np.degrees(phi)

    def forward(self, lon, lat):
        """(lon, lat) degrees -> projected (x, y) in the CRS units."""
        if self.is_geographic:
            return np.asarray(lon, float), np.asarray(lat, float)
        p = self.params
        x, y = self._fwd(p, np.radians(np.asarray(lon, float)),
                         np.radians(np.asarray(lat, float)))
        return (x + p.x_0) / p.to_meter, (y + p.y_0) / p.to_meter
