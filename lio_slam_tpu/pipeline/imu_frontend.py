"""IMU front-end: preintegration-based state fusion + IMU-rate odometry.

Rebuild of `src/liorf/src/imuPreintegration.cpp` (two classes in one node):

- `IMUPreintegration::odometryHandler` (:271-516): at each lidar odometry
  correction (~10 Hz) the reference adds an ImuFactor + bias BetweenFactor +
  lidar pose prior to a periodically-reset iSAM2 graph.  The
  equivalent here is an error-state update on [dtheta, dv, dp, dbg, dba] (15):
  propagate covariance through the preintegrated window (Forster covariance +
  bias random walk sigma*sqrt(dt), :413), then fuse the lidar pose with noise
  sigma 0.05 rot / 0.1 trans — inflated to 1.0 when the registration flagged
  degeneracy (correctionNoise2, :288/:415).  Bias corrections flow through the
  preintegration bias Jacobians.  This is the information-form equivalent of
  the reference's short-horizon graph (which it resets every 100 keys anyway).
- `failureDetection` (:496-516): |v| > 30 or |bias| > 1 -> reset + the
  /mapping_error contract.
- `imuHandler` (:518-613): IMU-rate prediction from the latest fused state —
  here one `lax.scan` over the sample window producing the whole
  `odometry/imu_incremental` pose train in a single call.
- `TransformFusion` (:25-165): latest lidar map pose composed with the IMU
  increment since that pose -> the final high-rate `odometry/imu` output.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lio_slam_tpu.config import ImuConfig
from lio_slam_tpu.ops import preintegration as pre
from lio_slam_tpu.utils import se3


class ImuFrontendState(NamedTuple):
    nav: pre.NavState          # fused state at the last lidar correction
    bias_gyr: jax.Array        # (3,)
    bias_acc: jax.Array        # (3,)
    cov: jax.Array             # (15,15) error covariance [dth, dv, dp, dbg, dba]
    initialized: jax.Array     # () bool
    failure: jax.Array         # () bool — /mapping_error contract


def init_state(dtype=jnp.float32) -> ImuFrontendState:
    return ImuFrontendState(
        nav=pre.NavState(R=jnp.eye(3, dtype=dtype), p=jnp.zeros(3, dtype),
                         v=jnp.zeros(3, dtype)),
        bias_gyr=jnp.zeros(3, dtype), bias_acc=jnp.zeros(3, dtype),
        cov=jnp.eye(15, dtype=dtype) * 1e-2,
        initialized=jnp.zeros((), bool),
        failure=jnp.zeros((), bool))


def _init_cov(dtype=jnp.float32) -> jax.Array:
    """Prior sigmas at initialization (imuPreintegration.cpp:222-231):
    pose 1e-2, velocity 1e4 (rad/m/s), bias 1e-3."""
    d = jnp.concatenate([
        jnp.full(3, 1e-2 ** 2), jnp.full(3, 1e4 ** 2), jnp.full(3, 1e-2 ** 2),
        jnp.full(6, 1e-3 ** 2)])
    return jnp.diag(d.astype(dtype))


@jax.jit
def reinitialize(state: ImuFrontendState,
                 lidar_pose6: "jax.Array") -> ImuFrontendState:
    """Re-anchor after a correction gap (IMU dropout / stalled stream):
    pose from the mapping result, velocity zeroed, biases kept, fresh
    covariance.  A NORMAL correction after a gap mis-attributes the large
    position innovation to velocity (the filter's propagated time is only
    the visible window, not the real gap) and the inflated velocity then
    feeds registration guesses that confirm it — the runaway the reference
    breaks with resetParams (imuPreintegration.cpp:437-442, 496-516)."""
    Rm, pm = se3.pose6_to_Rt(lidar_pose6)
    return ImuFrontendState(
        nav=pre.NavState(R=Rm, p=pm, v=jnp.zeros(3, pm.dtype)),
        bias_gyr=state.bias_gyr, bias_acc=state.bias_acc,
        cov=_init_cov(pm.dtype),
        initialized=jnp.ones((), bool),
        failure=jnp.zeros((), bool))


def make_frontend(cfg: ImuConfig):
    g = cfg.gravity
    # pileup threshold derived from the rig's nominal rate (half the
    # period, capped at the fork's 10 ms): the fork's fixed 10 ms gate
    # assumes a 50 Hz IMU and silently replaces EVERY genuine sample of a
    # >=200 Hz stream with the stationary placeholder (see
    # ops/preintegration.apply_pileup_gate)
    min_dt = min(0.01, 0.5 / max(cfg.imu_rate, 1.0))

    def _preintegrate(acc, gyr, dt, mask, bg, ba):
        acc, gyr, dt = pre.apply_pileup_gate(acc, gyr, dt, g,
                                             min_dt=min_dt)
        # log-depth associative-scan version (matches the sequential
        # reference, log depth instead of a sequential chain)
        return pre.preintegrate_parallel(acc, gyr, dt, mask, bg, ba,
                                         cfg.acc_noise, cfg.gyr_noise)

    @jax.jit
    def correct(state: ImuFrontendState,
                acc: jax.Array, gyr: jax.Array, dt: jax.Array, mask: jax.Array,
                lidar_pose6: jax.Array, degenerate: jax.Array
                ) -> ImuFrontendState:
        """Fuse the lidar odometry pose with the IMU window since the last
        correction (odometryHandler)."""
        Rm, pm = se3.pose6_to_Rt(lidar_pose6)

        def initialize(_):
            return ImuFrontendState(
                nav=pre.NavState(R=Rm, p=pm, v=jnp.zeros(3, pm.dtype)),
                bias_gyr=jnp.zeros(3, pm.dtype), bias_acc=jnp.zeros(3, pm.dtype),
                cov=_init_cov(pm.dtype),
                initialized=jnp.ones((), bool),
                failure=jnp.zeros((), bool))

        def update(state: ImuFrontendState):
            # the 15x15 covariance algebra below MUST run at full float32:
            # a reduced-precision matmul (bf16 passes, or TF32 on a GPU)
            # has an error floor far above the covariance's small-magnitude
            # bias blocks — measured as a systematic ~8 cm/scan drift on a
            # backend whose default matmul was reduced precision (full
            # float32: 7 mm total).  These matrices are tiny; HIGHEST costs
            # nothing.
            prec = jax.lax.Precision.HIGHEST
            mm = lambda a, b: jnp.matmul(a, b, precision=prec)
            pint = _preintegrate(acc, gyr, dt, mask, state.bias_gyr,
                                 state.bias_acc)
            nav = pre.predict(state.nav, pint, g)

            # covariance propagation: F maps [dth,dv,dp,dbg,dba] across the
            # window; the theta/v/p block comes from the preintegration, the
            # bias-coupling from its bias Jacobians, bias random walk adds
            # sigma^2 * dt
            T = pint.dt
            R0 = state.nav.R
            F = jnp.eye(15, dtype=pm.dtype)
            F = F.at[:3, :3].set(pint.dR.T)
            # attitude error at the window start rotates the accumulated
            # deltas: dv' += -R0 [dv]x dth, dp' += -R0 [dp]x dth
            F = F.at[3:6, :3].set(-R0 @ se3.skew(pint.dv))
            F = F.at[6:9, :3].set(-R0 @ se3.skew(pint.dp))
            F = F.at[6:9, 3:6].set(jnp.eye(3) * T)
            F = F.at[:3, 9:12].set(pint.dR_dbg)
            F = F.at[3:6, 9:12].set(R0 @ pint.dv_dbg)
            F = F.at[3:6, 12:15].set(R0 @ pint.dv_dba)
            F = F.at[6:9, 9:12].set(R0 @ pint.dp_dbg)
            F = F.at[6:9, 12:15].set(R0 @ pint.dp_dba)
            # preintegration covariance is in the delta (body_i) frame;
            # rotate the v/p blocks into world
            Gblk = jax.scipy.linalg.block_diag(jnp.eye(3, dtype=pm.dtype), R0, R0)
            Q = jnp.zeros((15, 15), pm.dtype)
            Q = Q.at[:9, :9].set(Gblk @ pint.cov @ Gblk.T)
            Q = Q.at[9:12, 9:12].set(jnp.eye(3) * cfg.gyr_bias_noise ** 2 * T)
            Q = Q.at[12:15, 12:15].set(jnp.eye(3) * cfg.acc_bias_noise ** 2 * T)
            P = mm(mm(F, state.cov), F.T) + Q

            # measurement: lidar pose (rot + trans); correctionNoise sigma
            # 0.05 rad / 0.1 m, inflated when degenerate (correctionNoise2)
            sr = jnp.where(degenerate, 1.0, 0.05)
            st = jnp.where(degenerate, 1.0, 0.1)
            Rn = jnp.diag(jnp.concatenate([jnp.full(3, sr ** 2),
                                           jnp.full(3, st ** 2)]).astype(pm.dtype))
            H = jnp.zeros((6, 15), pm.dtype)
            H = H.at[:3, :3].set(jnp.eye(3))
            H = H.at[3:6, 6:9].set(jnp.eye(3))
            r = jnp.concatenate([se3.so3_log(nav.R.T @ Rm), pm - nav.p])

            # P must stay symmetric through the propagation before the gain
            # is computed: with many fine-dt samples per window (a >=200 Hz
            # IMU) the float32 F P Fᵀ product loses symmetry/PSD and the
            # velocity rows of K blow up — measured as a one-scan -5 m/s
            # velocity swing from a 3 cm innovation that then poisons the
            # next guess by ~1 m.  Symmetrize + solve (no explicit inverse)
            # + Joseph-form update keep the filter conditioned.
            P = 0.5 * (P + P.T)
            S = mm(mm(H, P), H.T) + Rn
            S = 0.5 * (S + S.T)
            K = jnp.linalg.solve(S, mm(H, P)).T
            dx = mm(K, r)
            IKH = jnp.eye(15, dtype=pm.dtype) - mm(K, H)
            P_new = (mm(mm(IKH, P), IKH.T)
                     + mm(mm(K, Rn), K.T))

            R_new = nav.R @ se3.so3_exp(dx[:3])
            nav_new = pre.NavState(R=R_new, p=nav.p + dx[6:9], v=nav.v + dx[3:6])
            bg = state.bias_gyr + dx[9:12]
            ba = state.bias_acc + dx[12:15]

            fail = pre.failure_detected(nav_new, bg, ba)

            def reset(_):
                # failureDetection -> resetParams + /mapping_error (:437-442)
                return initialize(None)._replace(failure=jnp.ones((), bool))

            def keep(_):
                return ImuFrontendState(nav=nav_new, bias_gyr=bg, bias_acc=ba,
                                        cov=0.5 * (P_new + P_new.T),
                                        initialized=jnp.ones((), bool),
                                        failure=jnp.zeros((), bool))

            return jax.lax.cond(fail, reset, keep, None)

        return jax.lax.cond(state.initialized, update, initialize, state)

    @jax.jit
    def predict_rate(state: ImuFrontendState,
                     acc: jax.Array, gyr: jax.Array, dt: jax.Array,
                     mask: jax.Array):
        """IMU-rate odometry (imuHandler): pose at every sample of the window,
        propagated from the last fused state — the `odometry/imu_incremental`
        stream as one (T, 6) tensor."""
        acc_g, gyr_g, dt_g = pre.apply_pileup_gate(acc, gyr, dt, g,
                                                   min_dt=min_dt)
        return pre.integrate_pose_train(
            state.nav.R, state.nav.p, state.nav.v,
            acc_g - state.bias_acc, gyr_g - state.bias_gyr,
            dt_g, mask, g)                             # (T, 6)

    @jax.jit
    def transform_fusion(lidar_odom6: jax.Array, imu_front6: jax.Array,
                         imu_back6: jax.Array) -> jax.Array:
        """TransformFusion::imuOdometryHandler (:107-129): final high-rate
        pose = lidarOdom ∘ (imuFront^{-1} ∘ imuBack)."""
        inc = se3.pose6_between(imu_front6, imu_back6)
        return se3.pose6_compose(lidar_odom6, inc)

    return correct, predict_rate, transform_fusion
