"""WGS84 earth-frame conversions (NumPy, host-side; the port's own copy of
fastlivo_tpu/ops/earth.py).

Capability parity with the reference's `Earth` helpers
(reference: include/earth.h:18-134 — ECEF<->geodetic, local ENU frames,
normal gravity, GPS->Unix time). Used by the GNSS fusion front end; the
per-update observation math is in models/gnss.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

GPS_LEAP_SECOND = 18
GPS_EPOCH_UNIX = 315964800.0  # 1980-01-06T00:00:00Z
WGS84_RA = 6378137.0
WGS84_E1 = 0.0066943799901413156


def gravity(blh: np.ndarray) -> float:
    """Normal gravity at geodetic position (somigliana, earth.h:21-27)."""
    s2 = np.sin(blh[0]) ** 2
    return (
        9.7803267715 * (1 + 0.0052790414 * s2 + 0.0000232718 * s2 * s2)
        + blh[2] * (0.0000000043977311 * s2 - 0.0000030876910891)
        + 7.211e-13 * blh[2] * blh[2]
    )


def _rn(lat: float) -> float:
    s = np.sin(lat)
    return WGS84_RA / np.sqrt(1.0 - WGS84_E1 * s * s)


def blh2ecef(blh: np.ndarray) -> np.ndarray:
    lat, lon, h = blh
    cl, sl = np.cos(lat), np.sin(lat)
    co, so = np.cos(lon), np.sin(lon)
    rn = _rn(lat)
    return np.array(
        [(rn + h) * cl * co, (rn + h) * cl * so, (rn * (1 - WGS84_E1) + h) * sl]
    )


def ecef2blh(ecef: np.ndarray, iters: int = 10) -> np.ndarray:
    """ECEF -> geodetic via fixed-point iteration (earth.h:51-80)."""
    x, y, z = ecef
    p = np.hypot(x, y)
    lon = np.arctan2(y, x)
    lat = np.arctan(z / max(p * (1.0 - WGS84_E1), 1e-12))
    h = 0.0
    for _ in range(iters):
        rn = _rn(lat)
        h = p / np.cos(lat) - rn
        lat = np.arctan(z / max(p * (1.0 - WGS84_E1 * rn / (rn + h)), 1e-12))
    return np.array([lat, lon, h])


def cne(blh: np.ndarray) -> np.ndarray:
    """Rotation ECEF->local ENU at anchor blh (rows = E, N, U axes)."""
    lat, lon = blh[0], blh[1]
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ]
    )


def ecef2enu(ecef: np.ndarray, anchor_ecef: np.ndarray) -> np.ndarray:
    """ECEF point -> ENU relative to anchor."""
    blh = ecef2blh(anchor_ecef)
    return cne(blh) @ (ecef - anchor_ecef)


def gps2unix(week: int, sow: float) -> float:
    """GPS week + seconds-of-week -> Unix time (earth.h gps2unix)."""
    return GPS_EPOCH_UNIX + week * 604800.0 + sow - GPS_LEAP_SECOND
