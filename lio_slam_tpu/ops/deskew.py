"""Scan deskew: IMU rotation-table integration + per-point motion compensation.

Rebuild of `ImageProjection`'s deskew path
(`src/liorf/src/imageProjection.cpp:339-575`):

- `imuDeskewInfo` (:359-418): integrates gyro over the scan window into a
  rotation lookup table (the reference keeps a 2000-slot per-axis Euler cumsum;
  we keep per-sample SO(3)-integrated rotation vectors — same role, correct
  on-manifold composition).
- `findRotation`/`deskewPoint` (:502-575): per-point linear interpolation of
  the table and rotation of the point into the scan-start frame.  The
  reference computes a positional interpolation too but leaves it disabled
  (odomDeskewFlag); we support it behind `pos_increment`.

Everything is fixed-shape: the IMU window is `(T,)` masked samples, the scan is
`(N,)` masked points; interpolation indices come from a vectorized
compare-and-sum instead of binary search (O(N·T) compares, no
data-dependent control flow).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lio_slam_tpu.utils import se3


class RotationTable(NamedTuple):
    """Cumulative rotation since the window start, sampled at IMU times."""

    times: jax.Array     # (T,) seconds, relative to scan start (may be <0)
    rotvec: jax.Array    # (T, 3) rotation vector of R(window_start -> t)
    mask: jax.Array      # (T,) bool valid samples


def build_rotation_table(gyr: jax.Array, times: jax.Array, mask: jax.Array) -> RotationTable:
    """Integrate gyro samples into a cumulative-rotation table.

    gyr:   (T, 3) angular rate (already bias-/extrinsic-corrected)
    times: (T,) sample times relative to scan start, ascending
    mask:  (T,) valid flags (invalid samples integrate as zero rotation)

    Equivalent role to imuDeskewInfo's imuRot{X,Y,Z} table
    (imageProjection.cpp:359-418), but composed on SO(3).
    """
    dt = jnp.diff(times, prepend=times[:1])
    dt = jnp.where(mask, jnp.maximum(dt, 0.0), 0.0)

    def step(R_prev, inp):
        w, d = inp
        R = R_prev @ se3.so3_exp(w * d)
        return R, se3.so3_log(R)

    _, rotvecs = jax.lax.scan(step, jnp.eye(3, dtype=gyr.dtype), (gyr, dt))
    return RotationTable(times=times, rotvec=rotvecs, mask=mask)


def interpolate_rotation(table: RotationTable, t: jax.Array) -> jax.Array:
    """Rotation vector at query times `t` (...,) -> (..., 3) by linear
    interpolation between bracketing table entries (findRotation,
    imageProjection.cpp:502-527: holds the last value past the table end)."""
    valid = table.mask
    tt = jnp.where(valid, table.times, jnp.inf)
    # index of last sample with time <= t  (0 if before table start)
    idx_hi = jnp.sum(t[..., None] >= tt, axis=-1)          # in [0, T]
    T = table.times.shape[0]
    n_valid = jnp.sum(valid.astype(jnp.int32))
    idx_hi = jnp.clip(idx_hi, 1, jnp.maximum(n_valid - 1, 1))
    idx_lo = idx_hi - 1
    t_lo = jnp.take(table.times, idx_lo, axis=0)
    t_hi = jnp.take(table.times, idx_hi, axis=0)
    r_lo = jnp.take(table.rotvec, idx_lo, axis=0)
    r_hi = jnp.take(table.rotvec, idx_hi, axis=0)
    denom = jnp.maximum(t_hi - t_lo, 1e-9)
    alpha = jnp.clip((t - t_lo) / denom, 0.0, 1.0)[..., None]
    return r_lo * (1.0 - alpha) + r_hi * alpha


def deskew(points: jax.Array, point_times: jax.Array, point_mask: jax.Array,
           table: RotationTable,
           pos_increment: Optional[jax.Array] = None,
           scan_duration: Optional[jax.Array] = None) -> jax.Array:
    """Motion-compensate a scan into its start frame.

    points:       (N, 3)
    point_times:  (N,) seconds relative to scan start
    point_mask:   (N,) bool
    pos_increment: optional (3,) translation over the scan (odomDeskewInfo's
        start->end increment; the reference computes but disables it)
    Returns deskewed (N, 3); masked points pass through unchanged.

    Mirrors deskewPoint (imageProjection.cpp:545-575):
    p' = R(t0)^{-1} (R(t) p + t(t)) with t0 = scan start.
    """
    r0 = interpolate_rotation(table, jnp.zeros((), points.dtype))
    R0 = se3.so3_exp(r0)
    rt = interpolate_rotation(table, point_times)            # (N, 3)
    Rt = se3.so3_exp(rt)                                     # (N, 3, 3)
    p = (Rt @ points[..., None])[..., 0]
    if pos_increment is not None and scan_duration is not None:
        ratio = jnp.clip(point_times / jnp.maximum(scan_duration, 1e-6), 0.0, 1.0)
        p = p + ratio[:, None] * pos_increment[None, :]
    p = p @ R0                                               # R0^T @ p, batched
    return jnp.where(point_mask[:, None], p, points)


class DeskewInfo(NamedTuple):
    """Per-scan metadata handed to the mapping stage — the cloud_info record
    (`src/liorf/msg/cloud_info.msg`) minus the ROS plumbing."""

    imu_available: jax.Array      # () bool — rotation table valid
    odom_available: jax.Array     # () bool — initial guess from IMU odometry
    imu_rpy_init: jax.Array       # (3,) IMU attitude at scan start (9-axis)
    initial_guess: jax.Array      # (6,) pose6 initial guess for registration


def make_deskew_info(imu_available, odom_available, imu_rpy_init, initial_guess):
    return DeskewInfo(
        imu_available=jnp.asarray(imu_available, bool),
        odom_available=jnp.asarray(odom_available, bool),
        imu_rpy_init=jnp.asarray(imu_rpy_init, jnp.float32),
        initial_guess=jnp.asarray(initial_guess, jnp.float32),
    )
