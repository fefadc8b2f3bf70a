"""WGS84 <-> local ENU conversions (host-side, float64 numpy).

Replaces GeographicLib::LocalCartesian as used by the reference's GPS intake
(`mapOptmization.cpp:762-769` gps_trans_.Forward/Reset) and the hand-rolled
`enu_to_wgs84` (:363-428) used by `fusionGps` to publish lat/lon back out.

Geodetic precision needs ~1e-9 rad; this module deliberately stays in numpy
float64 on the host — only the resulting metric ENU coordinates (cm-scale
dynamic range) cross onto the device.
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)


def geodetic_to_ecef(lat_deg, lon_deg, h):
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    h = np.asarray(h, np.float64)
    sl, cl = np.sin(lat), np.cos(lat)
    n = _A / np.sqrt(1.0 - _E2 * sl * sl)
    x = (n + h) * cl * np.cos(lon)
    y = (n + h) * cl * np.sin(lon)
    z = (n * (1.0 - _E2) + h) * sl
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def ecef_to_geodetic(xyz):
    """Bowring's method (iterative, converges in ~3 iterations to mm)."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - _E2))
    for _ in range(5):
        sl = np.sin(lat)
        n = _A / np.sqrt(1.0 - _E2 * sl * sl)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - _E2 * n / (n + h)))
    sl = np.sin(lat)
    n = _A / np.sqrt(1.0 - _E2 * sl * sl)
    h = p / np.cos(lat) - n
    return np.rad2deg(lat), np.rad2deg(lon), h


class LocalCartesian:
    """GeographicLib::LocalCartesian equivalent: a local ENU frame anchored at
    a datum; supports Reset (gps_trans_.Reset, :768) and Forward/Reverse."""

    def __init__(self, lat0=0.0, lon0=0.0, h0=0.0):
        self.reset(lat0, lon0, h0)

    def reset(self, lat0, lon0, h0=0.0):
        self.lat0, self.lon0, self.h0 = float(lat0), float(lon0), float(h0)
        self._origin = geodetic_to_ecef(lat0, lon0, h0)
        lat = np.deg2rad(lat0)
        lon = np.deg2rad(lon0)
        sl, cl = np.sin(lat), np.cos(lat)
        so, co = np.sin(lon), np.cos(lon)
        # rows: east, north, up in ECEF
        self._R = np.array([
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ])

    def forward(self, lat, lon, h=0.0):
        """(lat, lon, h) -> (e, n, u) meters."""
        ecef = geodetic_to_ecef(lat, lon, h)
        d = ecef - self._origin
        enu = d @ self._R.T
        return enu

    def reverse(self, enu):
        """(e, n, u) -> (lat, lon, h)."""
        enu = np.asarray(enu, np.float64)
        ecef = enu @ self._R + self._origin
        return ecef_to_geodetic(ecef)


def heading_from_yaw(yaw_rad: float) -> float:
    """Map-frame yaw (x east, CCW) -> compass heading in degrees
    (0 = north, clockwise), the GpswithHeading convention used by fusionGps
    (mapOptmization.cpp:2407-2414)."""
    hdg = 90.0 - np.rad2deg(yaw_rad)
    return float((hdg + 360.0) % 360.0)
