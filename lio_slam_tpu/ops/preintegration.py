"""IMU preintegration via `lax.scan`.

Replaces `gtsam::PreintegratedImuMeasurements` as used by the reference's
IMU front-end (`src/liorf/src/imuPreintegration.cpp:167-614`): relative
rotation/velocity/position deltas between two lidar corrections, first-order
bias-correction Jacobians, and a 9x9 covariance (Forster et al., "On-Manifold
Preintegration", RSS 2015 — the same formulation gtsam implements).

Reference behaviors preserved:
- anti-pileup gating (`imuPreintegration.cpp:370-405`): samples arriving
  closer than 10 ms (2.0/200) after the previous one are integrated as a
  stationary placeholder instead of their raw values; non-positive dt falls
  back to 1/50 s.  (The reference's literal placeholder passes
  acc=(1e-5,1e-5,1e-5), omega=(1e-5,1e-5,g) — an apparent arg swap; we
  integrate the evidently-intended stationary measurement acc=(0,0,g),
  omega=0.)
- `predict()` (`:545`): NavState propagation under gravity.
- first-order bias update of the deltas (gtsam biasCorrectedDelta).

All math is float32; everything is fixed-shape: an IMU window is
`(N, 3) acc, (N, 3) gyr, (N,) dt, (N,) mask` with masked samples integrated
as dt=0 no-ops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lio_slam_tpu.utils import se3


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurement between two correction times."""

    dR: jax.Array         # (3, 3) rotation delta (body_i <- body_j)
    dv: jax.Array         # (3,)  velocity delta in body_i frame
    dp: jax.Array         # (3,)  position delta in body_i frame
    dt: jax.Array         # ()    total integration time
    # bias-correction Jacobians (d delta / d bias), first order
    dR_dbg: jax.Array     # (3, 3)
    dv_dbg: jax.Array     # (3, 3)
    dv_dba: jax.Array     # (3, 3)
    dp_dbg: jax.Array     # (3, 3)
    dp_dba: jax.Array     # (3, 3)
    cov: jax.Array        # (9, 9) covariance of [dtheta, dv, dp]
    bias_gyr: jax.Array   # (3,) bias the deltas were integrated with
    bias_acc: jax.Array   # (3,)


class NavState(NamedTuple):
    """World-frame navigation state (gtsam::NavState equivalent)."""

    R: jax.Array          # (3, 3) body->world
    p: jax.Array          # (3,)
    v: jax.Array          # (3,)


def identity_preintegrated(dtype=jnp.float32) -> Preintegrated:
    eye = jnp.eye(3, dtype=dtype)
    zero3 = jnp.zeros(3, dtype=dtype)
    zero33 = jnp.zeros((3, 3), dtype=dtype)
    return Preintegrated(dR=eye, dv=zero3, dp=zero3, dt=jnp.zeros((), dtype),
                         dR_dbg=zero33, dv_dbg=zero33, dv_dba=zero33,
                         dp_dbg=zero33, dp_dba=zero33,
                         cov=jnp.zeros((9, 9), dtype),
                         bias_gyr=zero3, bias_acc=zero3)


def apply_pileup_gate(acc: jax.Array, gyr: jax.Array, dt: jax.Array,
                      gravity: float, min_dt: float = 0.01,
                      fallback_dt: float = 1.0 / 50.0):
    """The fork's anti-pileup gating (imuPreintegration.cpp:376-401).

    Samples with dt <= min_dt are replaced by a stationary placeholder
    (acc = (0,0,g) i.e. gravity reaction only, omega = 0); non-positive dt
    becomes `fallback_dt`.

    NOTE the fork's fixed 10 ms threshold assumes its own 50 Hz rig: on a
    genuine >=200 Hz IMU every REAL sample arrives under 10 ms and would be
    gated into the placeholder — the front-end then integrates near-zero
    rotation and the whole pipeline drifts (measured: the 500 Hz presets
    at ATE 1.6-7 m vs 0.08 m at 100 Hz on the same mission; the upstream
    LIO-SAM 500 Hz rigs this fork inherited would break identically).
    `make_frontend` therefore derives min_dt from the configured imu_rate
    (half the nominal period, capped at the fork's 10 ms) — a deliberate
    parity fix, like the plane-fit one.
    """
    # strict comparison with slack: a nominal-100 Hz stream (dt == 0.01) must
    # NOT be gated; only genuinely piled-up samples (dt clearly below the gap)
    piled = dt < min_dt * 0.999
    placeholder_acc = jnp.array([0.0, 0.0, gravity], acc.dtype)
    acc = jnp.where(piled[:, None], placeholder_acc, acc)
    gyr = jnp.where(piled[:, None], jnp.zeros(3, gyr.dtype), gyr)
    dt = jnp.where(dt <= 0.0, fallback_dt, dt)
    return acc, gyr, dt


def preintegrate(acc: jax.Array, gyr: jax.Array, dt: jax.Array,
                 mask: jax.Array, bias_gyr: jax.Array, bias_acc: jax.Array,
                 acc_noise: float, gyr_noise: float,
                 init_cov: float = 1e-8) -> Preintegrated:
    """Integrate an IMU window into a `Preintegrated` delta.

    acc, gyr: (N, 3) specific force / angular rate in body frame
    dt:       (N,)  per-sample integration time
    mask:     (N,)  bool; masked samples are no-ops
    bias_*:   (3,)  biases to subtract during integration
    """
    dtf = jnp.where(mask, dt, 0.0).astype(acc.dtype)
    a = acc - bias_acc
    w = gyr - bias_gyr
    sig_g2 = jnp.asarray(gyr_noise, acc.dtype) ** 2
    sig_a2 = jnp.asarray(acc_noise, acc.dtype) ** 2

    def step(carry, inp):
        st: Preintegrated = carry
        a_k, w_k, dt_k = inp
        theta = w_k * dt_k
        dRk = se3.so3_exp(theta)               # incremental rotation
        Jr = se3.so3_right_jacobian(theta)
        Ra = st.dR @ a_k                       # rotated accel (body_i frame)
        dt2 = dt_k * dt_k

        # delta updates (Forster eq. 35-37)
        dp = st.dp + st.dv * dt_k + 0.5 * Ra * dt2
        dv = st.dv + Ra * dt_k
        dR = st.dR @ dRk

        # bias Jacobian recursions (Forster appendix)
        A_hat = st.dR @ se3.skew(a_k)
        dp_dbg = st.dp_dbg + st.dv_dbg * dt_k - 0.5 * A_hat @ st.dR_dbg * dt2
        dp_dba = st.dp_dba + st.dv_dba * dt_k - 0.5 * st.dR * dt2
        dv_dbg = st.dv_dbg - A_hat @ st.dR_dbg * dt_k
        dv_dba = st.dv_dba - st.dR * dt_k
        dR_dbg = dRk.T @ st.dR_dbg - Jr * dt_k

        # covariance propagation: state [dtheta, dv, dp]
        Z = jnp.zeros((3, 3), a_k.dtype)
        I3 = jnp.eye(3, dtype=a_k.dtype)
        A = jnp.block([
            [dRk.T,            Z,          Z],
            [-A_hat * dt_k,    I3,         Z],
            [-0.5 * A_hat * dt2, I3 * dt_k, I3],
        ])
        Bg = jnp.concatenate([Jr * dt_k, Z, Z], axis=0)          # (9,3)
        Ba = jnp.concatenate([Z, st.dR * dt_k, 0.5 * st.dR * dt2], axis=0)
        # continuous-time noise densities -> discrete: sigma^2 / dt
        inv_dt = jnp.where(dt_k > 0, 1.0 / jnp.maximum(dt_k, 1e-6), 0.0)
        cov = (A @ st.cov @ A.T
               + Bg @ (sig_g2 * inv_dt * I3) @ Bg.T
               + Ba @ (sig_a2 * inv_dt * I3) @ Ba.T)

        new = st._replace(dR=dR, dv=dv, dp=dp, dt=st.dt + dt_k,
                          dR_dbg=dR_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba,
                          dp_dbg=dp_dbg, dp_dba=dp_dba, cov=cov)
        # masked sample (dt == 0): identity update already, but guard exactly
        skip = dt_k <= 0.0
        new = jax.tree.map(lambda n, o: jnp.where(skip, o, n), new, st)
        return new, None

    init = identity_preintegrated(acc.dtype)._replace(
        cov=jnp.eye(9, dtype=acc.dtype) * init_cov,
        bias_gyr=bias_gyr.astype(acc.dtype), bias_acc=bias_acc.astype(acc.dtype))
    out, _ = jax.lax.scan(step, init, (a, w, dtf))
    return out


def preintegrate_parallel(acc: jax.Array, gyr: jax.Array, dt: jax.Array,
                          mask: jax.Array, bias_gyr: jax.Array,
                          bias_acc: jax.Array,
                          acc_noise: float, gyr_noise: float,
                          init_cov: float = 1e-8) -> Preintegrated:
    """Log-depth preintegration via `associative_scan` — same math as
    `preintegrate` (identical results up to f32 reassociation) but all-batched:

    - cumulative rotations  D_i = prod exp(w_j dt_j)      (assoc matmul scan)
    - dv/dp                 cumsums of rotated increments
    - bias Jacobians        J_N = sum_j S_j C_j
    - covariance            P_N = sum_j S_j Q_j S_j^T
      with suffix transition products S_j = A_N ... A_{j+1} from a reverse
      associative scan of the 9x9 per-sample transitions.

    The sequential `preintegrate` is the readable reference; this is the
    production path (log depth instead of a 512-step sequential chain).
    """
    dtype = acc.dtype
    T = acc.shape[0]
    dtf = jnp.where(mask, dt, 0.0).astype(dtype)
    a = acc - bias_acc
    w = gyr - bias_gyr
    sig_g2 = jnp.asarray(gyr_noise, dtype) ** 2
    sig_a2 = jnp.asarray(acc_noise, dtype) ** 2

    theta = w * dtf[:, None]
    dRk = se3.so3_exp(theta)                               # (T,3,3)
    Jr = se3.so3_right_jacobian(theta)

    # cumulative rotations D_i = dRk_1 ... dRk_i ; D_prev_i = D_{i-1}
    D = jax.lax.associative_scan(lambda x, y: jnp.einsum("...ij,...jk->...ik", x, y), dRk)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (1, 3, 3))
    D_prev = jnp.concatenate([eye, D[:-1]], axis=0)

    Ra = jnp.einsum("tij,tj->ti", D_prev, a)               # (T,3)
    dt2 = dtf * dtf
    dv_steps = Ra * dtf[:, None]
    dv_cum = jnp.cumsum(dv_steps, axis=0)
    dv_prev = jnp.concatenate([jnp.zeros((1, 3), dtype), dv_cum[:-1]], axis=0)
    dp_steps = dv_prev * dtf[:, None] + 0.5 * Ra * dt2[:, None]
    dp = jnp.sum(dp_steps, axis=0)
    dv = dv_cum[-1]
    dR = D[-1]
    t_total = jnp.sum(dtf)

    # per-sample 9x9 transitions A_j and noise Q_j
    Ahat = jnp.einsum("tij,tjk->tik", D_prev, se3.skew(a))  # D_{j-1} [a]x
    Z = jnp.zeros((T, 3, 3), dtype)
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (T, 3, 3))
    dRkT = jnp.swapaxes(dRk, -1, -2)
    A = jnp.concatenate([
        jnp.concatenate([dRkT, Z, Z], axis=-1),
        jnp.concatenate([-Ahat * dtf[:, None, None], I3, Z], axis=-1),
        jnp.concatenate([-0.5 * Ahat * dt2[:, None, None],
                         I3 * dtf[:, None, None], I3], axis=-1),
    ], axis=-2)                                             # (T,9,9)

    Bg = jnp.concatenate([Jr * dtf[:, None, None], Z, Z], axis=-2)      # (T,9,3)
    Ba = jnp.concatenate([Z, D_prev * dtf[:, None, None],
                          0.5 * D_prev * dt2[:, None, None]], axis=-2)
    inv_dt = jnp.where(dtf > 0, 1.0 / jnp.maximum(dtf, 1e-6), 0.0)
    Q = (jnp.einsum("tik,tjk->tij", Bg, Bg) * (sig_g2 * inv_dt)[:, None, None]
         + jnp.einsum("tik,tjk->tij", Ba, Ba) * (sig_a2 * inv_dt)[:, None, None])

    # suffix products S_j = A_T ... A_{j+1}: reverse assoc scan of A
    S = jax.lax.associative_scan(
        lambda x, y: jnp.einsum("...ij,...jk->...ik", x, y), A, reverse=True)
    # S[j] = A_T ... A_j ; we need A_T ... A_{j+1}:
    eye9 = jnp.broadcast_to(jnp.eye(9, dtype=dtype), (1, 9, 9))
    S_excl = jnp.concatenate([S[1:], eye9], axis=0)         # (T,9,9)

    P0 = jnp.eye(9, dtype=dtype) * init_cov
    S0 = S[0]                                               # A_T ... A_1
    cov = S0 @ P0 @ S0.T + jnp.einsum("tij,tjk,tlk->il", S_excl, Q, S_excl)

    # bias Jacobians: J = sum_j S_excl_j C_j  (J recursion with zero init)
    Cg = jnp.concatenate([-Jr * dtf[:, None, None], Z, Z], axis=-2)      # (T,9,3)
    Ca = jnp.concatenate([Z, -D_prev * dtf[:, None, None],
                          -0.5 * D_prev * dt2[:, None, None]], axis=-2)
    Jg = jnp.einsum("tij,tjk->ik", S_excl, Cg)              # (9,3)
    Ja = jnp.einsum("tij,tjk->ik", S_excl, Ca)

    return Preintegrated(
        dR=dR, dv=dv, dp=dp, dt=t_total,
        dR_dbg=Jg[:3], dv_dbg=Jg[3:6], dv_dba=Ja[3:6],
        dp_dbg=Jg[6:9], dp_dba=Ja[6:9],
        cov=cov,
        bias_gyr=bias_gyr.astype(dtype), bias_acc=bias_acc.astype(dtype))


def integrate_pose_train(R0: jax.Array, p0: jax.Array, v0: jax.Array,
                         acc: jax.Array, gyr: jax.Array, dt: jax.Array,
                         mask: jax.Array, gravity: float) -> jax.Array:
    """Pose at every IMU sample (the odometry/imu_incremental stream) in
    log-depth — the batched replacement for a sequential per-sample scan."""
    dtype = acc.dtype
    dtf = jnp.where(mask, dt, 0.0).astype(dtype)
    theta = gyr * dtf[:, None]
    dRk = se3.so3_exp(theta)
    D = jax.lax.associative_scan(
        lambda x, y: jnp.einsum("...ij,...jk->...ik", x, y), dRk)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (1, 3, 3))
    D_prev = jnp.concatenate([eye, D[:-1]], axis=0)
    R = jnp.einsum("ij,tjk->tik", R0, D)
    R_prev = jnp.einsum("ij,tjk->tik", R0, D_prev)
    g = jnp.array([0.0, 0.0, -gravity], dtype)
    acc_w = jnp.einsum("tij,tj->ti", R_prev, acc) + g[None, :]
    v = v0[None, :] + jnp.cumsum(acc_w * dtf[:, None], axis=0)
    v_prev = jnp.concatenate([v0[None, :], v[:-1]], axis=0)
    p_steps = v_prev * dtf[:, None] + 0.5 * acc_w * dtf[:, None] * dtf[:, None]
    p = p0[None, :] + jnp.cumsum(p_steps, axis=0)
    return jax.vmap(se3.Rt_to_pose6)(R, p)


def bias_corrected(pre: Preintegrated, bias_gyr: jax.Array,
                   bias_acc: jax.Array) -> Preintegrated:
    """First-order update of the deltas to a new bias estimate
    (gtsam biasCorrectedDelta equivalent)."""
    dbg = bias_gyr - pre.bias_gyr
    dba = bias_acc - pre.bias_acc
    dR = pre.dR @ se3.so3_exp(pre.dR_dbg @ dbg)
    dv = pre.dv + pre.dv_dbg @ dbg + pre.dv_dba @ dba
    dp = pre.dp + pre.dp_dbg @ dbg + pre.dp_dba @ dba
    return pre._replace(dR=dR, dv=dv, dp=dp,
                        bias_gyr=bias_gyr, bias_acc=bias_acc)


def predict(state: NavState, pre: Preintegrated, gravity: float) -> NavState:
    """NavState propagation (gtsam NavState::predict / imuPreintegration:545).

    gravity: positive scalar magnitude; world gravity vector is (0,0,-g).
    """
    g = jnp.array([0.0, 0.0, -gravity], pre.dv.dtype)
    t = pre.dt
    R = state.R @ pre.dR
    v = state.v + g * t + state.R @ pre.dv
    p = state.p + state.v * t + 0.5 * g * t * t + state.R @ pre.dp
    return NavState(R=R, p=p, v=v)


def failure_detected(state: NavState, bias_gyr: jax.Array, bias_acc: jax.Array,
                     vel_limit: float = 30.0, bias_limit: float = 1.0):
    """Divergence check (imuPreintegration.cpp:496-516): velocity > 30 m/s or
    bias norm > 1.0 -> caller should reset the front-end and raise
    /mapping_error."""
    return ((jnp.linalg.norm(state.v) > vel_limit)
            | (jnp.linalg.norm(bias_acc) > bias_limit)
            | (jnp.linalg.norm(bias_gyr) > bias_limit))
