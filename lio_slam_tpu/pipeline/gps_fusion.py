"""GPS intake, health state machine, and geodetic output — host-side.

Rebuild of the reference's GPS plumbing in `mapOptmization.cpp`:

- `gpsHandler` (:728-839): status gate, first-fix averaging over 5 readings to
  set the ENU datum, LocalCartesian forward projection, inter-fix jump
  accuracy gate (only evaluated in mode 0), `gps_odom` + `gps_reset` outputs.
- `gpsDataHandler` (:616-726): the 3-state positioning-mode machine
  (0 normal / 1 jammed / 3 recovering) keyed on the timestamp gap between the
  raw vehicle GPS stream ("gpsdata") and the corrected GPS stream ("GPSmsg"),
  with converge timers `gpsWaitingTimeThreshold` / `gpsDataWaitingTimeThreshold`,
  selecting which source feeds `sensor_fusion_output`.
- `fusionGps` (:2374-2430): SLAM pose -> WGS84 lat/lon + compass heading
  (`liorf/gpsdata` GpswithHeading output).

All of this is stream/timing logic on scalars — it stays on the host in
float64; only the metric ENU positions are handed to the device step as GPS
factors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from lio_slam_tpu.config import GpsConfig
from lio_slam_tpu.utils import enu as enu_mod



@dataclass
class GpsObservation:
    stamp: float
    enu: np.ndarray            # (3,) meters in the local frame
    accurate: bool             # inter-fix jump gate (gpsAccuracy)
    covariance: np.ndarray     # (3,) variances for the factor


@dataclass
class GpsIntake:
    """gpsHandler equivalent: datum management + ENU projection + gating."""

    cfg: GpsConfig
    transform: enu_mod.LocalCartesian = field(default_factory=enu_mod.LocalCartesian)
    _n_readings: int = 0
    _acc: np.ndarray = field(default_factory=lambda: np.zeros(3))
    _datum_fixed: bool = False
    _last_enu: Optional[np.ndarray] = None
    datum: Optional[np.ndarray] = None     # (lat, lon, alt) — gps_reset output

    def on_fix(self, stamp: float, lat: float, lon: float, alt: float,
               status: int = 0, covariance: Optional[np.ndarray] = None,
               mode_normal: bool = True) -> Optional[GpsObservation]:
        if status != 0:                    # NavSatFix status gate (:734)
            return None
        if not self._datum_fixed:
            if self._n_readings < self.cfg.first_fix_average:
                self._acc += (lat, lon, alt)
                self._n_readings += 1
                self.transform.reset(lat, lon, alt)
                self.datum = np.array([lat, lon, alt])
            if self._n_readings >= self.cfg.first_fix_average:
                avg = self._acc / self._n_readings
                self.transform.reset(*avg)
                self.datum = avg.copy()
                self._datum_fixed = True
        enu = np.asarray(self.transform.forward(lat, lon, alt), np.float64)
        accurate = True
        if self._last_enu is not None and mode_normal:
            jump = float(np.hypot(enu[0] - self._last_enu[0],
                                  enu[1] - self._last_enu[1]))
            accurate = jump <= self.cfg.gps_cov_threshold
        self._last_enu = enu
        cov = (np.asarray(covariance, np.float64) if covariance is not None
               else np.ones(3))
        return GpsObservation(stamp=stamp, enu=enu.astype(np.float64),
                              accurate=accurate, covariance=cov)


# positioning-mode codes (Int8 /positioning_mode)
MODE_NORMAL = 0
MODE_JAMMED = 1
MODE_RECOVERING = 3


@dataclass
class PositioningModeFSM:
    """gpsDataHandler state machine (:625-660).

    `on_gps(t)` is the corrected-GPS stream ("GPSmsg"); `step(t_raw, now)` is
    called per raw vehicle fix ("gpsdata") and returns the mode.  The machine
    flags jamming when the corrected stream lags the raw stream by >2 s,
    enters recovery when the gap closes below 0.3 s, and returns to normal
    after `gps_data_waiting_time` seconds of recovery; `converging` clears
    after `gps_waiting_time` seconds (gpsConverging flag).
    """

    cfg: GpsConfig
    mode: int = MODE_NORMAL
    converging: bool = False
    _last_gps_stamp: float = -1e18
    _recover_start: float = 0.0

    def on_gps(self, stamp: float) -> None:
        """Mark the corrected stream ("GPSmsg") at its DATA timestamp.
        Monotonic: a late scan-paired marking must not regress a fresher
        arrival-time marking (LiveFeed marks on push, the Runner re-marks at
        the delayed scan's stamp)."""
        self._last_gps_stamp = max(self._last_gps_stamp, stamp)

    def step(self, raw_stamp: float, now: float) -> int:
        gap = abs(raw_stamp - self._last_gps_stamp)
        if self.mode == MODE_NORMAL:
            if gap > 2.0:
                self.mode = MODE_JAMMED
        elif self.mode == MODE_JAMMED:
            if gap < 0.3:
                self.mode = MODE_RECOVERING
                self._recover_start = now
                self.converging = True
        elif self.mode == MODE_RECOVERING:
            timer = now - self._recover_start
            if gap > 1.0:
                self.mode = MODE_JAMMED
            elif timer > self.cfg.gps_data_waiting_time:
                self.mode = MODE_NORMAL
            if timer > self.cfg.gps_waiting_time:
                self.converging = False
        return self.mode

    def select_source(self, fused_heading: float, raw_heading: float,
                      switch_gps_data: bool = True) -> str:
        """Which record feeds sensor_fusion_output (:707-724):
        'fusion' or 'raw'."""
        if switch_gps_data:
            return "fusion" if self.mode in (MODE_JAMMED, MODE_RECOVERING) else "raw"
        if abs(fused_heading - raw_heading) < 3.0 or self.mode != MODE_NORMAL:
            return "fusion"
        return "raw"


@dataclass
class FusionOutput:
    """GpswithHeading-equivalent record (liorf/gpsdata)."""

    stamp: float
    latitude: float
    longitude: float
    altitude: float
    heading: float             # compass degrees
    roll: float                # degrees
    pitch: float               # degrees
    mode: int


def fusion_gps_output(pose6, stamp: float, transform: enu_mod.LocalCartesian,
                      mode: int = MODE_NORMAL) -> FusionOutput:
    """fusionGps (:2374-2430): SLAM pose -> geodetic record."""
    p = np.asarray(pose6, np.float64)
    lat, lon, alt = transform.reverse(p[3:6])
    return FusionOutput(
        stamp=stamp, latitude=float(lat), longitude=float(lon),
        altitude=float(alt),
        heading=enu_mod.heading_from_yaw(p[2]),
        roll=float(np.rad2deg(p[0])), pitch=float(np.rad2deg(p[1])),
        mode=mode)
