"""SO(3)/SE(3) math, float32-safe, jit/vmap friendly.

Replaces the reference's scattered Eigen/tf geometry:
- `pcl::getTransformation` Euler (roll,pitch,yaw) poses used throughout
  `mapOptmization.cpp` (transformTobeMapped is [roll,pitch,yaw,x,y,z])
- tf quaternion conversions in `utility.h:333-366` (imuConverter)
- gtsam::Pose3 composition in the factor graph

Conventions:
- Euler angles are intrinsic X-Y-Z (roll about x, then pitch about y, then yaw
  about z) applied as R = Rz(yaw) @ Ry(pitch) @ Rx(roll) — matches
  pcl::getTransformation / tf::Matrix3x3::getRPY used by the reference.
- Quaternions are (w, x, y, z).
- Small-angle branches use 2nd/4th-order Taylor series so everything is stable
  in float32 (the accelerator's fast dtype) without float64 emulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


# ---------------------------------------------------------------------------
# basic helpers
# ---------------------------------------------------------------------------

def skew(v: jax.Array) -> jax.Array:
    """Cross-product (hat) matrix. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)


def _sinc(theta):
    """sin(x)/x with Taylor fallback."""
    small = theta * theta < _EPS
    return jnp.where(small, 1.0 - theta * theta / 6.0,
                     jnp.sin(theta) / jnp.where(small, 1.0, theta))


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Uses the double-where pattern so `jacfwd`/`grad` through the small-angle
    branch stays finite (sqrt'(0) = inf would otherwise poison the gradient).
    """
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]   # (...,1,1)
    small = theta2 < _EPS
    theta2_safe = jnp.where(small, 1.0, theta2)   # keep sqrt grad finite
    theta = jnp.sqrt(theta2_safe)
    W = skew(w)
    W2 = W @ W
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Differentiation-safe at theta -> 0 (double-where: arccos/sqrt are only
    evaluated on inputs bounded away from their singular points)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    # thresholds must be representable in float32 (1 - 1e-8 rounds to 1.0!)
    near_zero = cos_theta > 1.0 - 1e-6
    near_pi_c = cos_theta < -1.0 + 1e-6
    cos_safe = jnp.where(near_zero | near_pi_c,
                         jnp.zeros_like(cos_theta), cos_theta)
    theta = jnp.where(near_zero, 0.0,
                      jnp.where(near_pi_c, jnp.pi, jnp.arccos(cos_safe)))
    # antisymmetric part
    v = jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    sin_theta = jnp.sin(theta)
    near_pi = jnp.pi - theta < 1e-3
    # generic: w = theta / (2 sin theta) * v; near zero use the Taylor series
    # in theta^2 ~= |v|^2/4 (grad-safe, no arccos/sqrt involved)
    t2_small = jnp.sum(v * v, axis=-1) / 4.0
    sin_safe = jnp.where(near_zero | near_pi, 1.0, 2.0 * sin_theta)
    scale = jnp.where(near_zero, 0.5 + t2_small / 12.0, theta / sin_safe)
    w_generic = scale[..., None] * v
    # near pi: use diagonal formula
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag - cos_theta[..., None]) /
                        jnp.maximum(1.0 - cos_theta[..., None], _EPS), 0.0)
    axis = jnp.sqrt(jnp.where(near_pi[..., None], jnp.maximum(axis2, _EPS), 1.0))
    # fix signs from off-diagonals
    sign = jnp.sign(jnp.where(jnp.abs(v) > 1e-6, v, jnp.stack([
        R[..., 1, 0] + R[..., 0, 1],
        R[..., 2, 1] + R[..., 1, 2],
        R[..., 0, 2] + R[..., 2, 0],
    ], axis=-1)))
    sign = jnp.where(sign == 0, 1.0, sign)
    w_pi = theta[..., None] * axis * sign
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: jax.Array) -> jax.Array:
    """Left Jacobian J_l of SO(3): exp((w+dw)^) ≈ exp(J_l dw) exp(w^)."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    small = theta2 < _EPS
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    W = skew(w)
    W2 = W @ W
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / theta2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / (theta2_safe * theta))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b * W + c * W2


def so3_right_jacobian(w: jax.Array) -> jax.Array:
    """Right Jacobian J_r(w) = J_l(-w)."""
    return so3_left_jacobian(-w)


# ---------------------------------------------------------------------------
# Euler (roll, pitch, yaw) — pcl::getTransformation convention
# ---------------------------------------------------------------------------

def rpy_to_matrix(rpy: jax.Array) -> jax.Array:
    """(roll, pitch, yaw) (..., 3) -> R = Rz(y) Ry(p) Rx(r) (..., 3, 3)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    R = jnp.stack([
        jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
        jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
        jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
    ], axis=-2)
    return R


def matrix_to_rpy(R: jax.Array) -> jax.Array:
    """Rotation matrix -> (roll, pitch, yaw), tf::Matrix3x3::getRPY convention."""
    sp = -R[..., 2, 0]
    sp = jnp.clip(sp, -1.0, 1.0)
    pitch = jnp.arcsin(sp)
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_to_matrix(q: jax.Array) -> jax.Array:
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)
    return R


def matrix_to_quat(R: jax.Array) -> jax.Array:
    """Shepperd's method, branch-free via where selection."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def case0():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, _EPS)) * 2
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], axis=-1)

    def case1():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 2
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], axis=-1)

    def case2():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, _EPS)) * 2
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], axis=-1)

    def case3():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, _EPS)) * 2
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], axis=-1)

    q0, q1, q2, q3 = case0(), case1(), case2(), case3()
    use0 = tr > 0
    use1 = (m00 >= m11) & (m00 >= m22)
    use2 = m11 >= m22
    q = jnp.where(use0[..., None], q0,
                  jnp.where(use1[..., None], q1,
                            jnp.where(use2[..., None], q2, q3)))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def slerp(q0: jax.Array, q1: jax.Array, t) -> jax.Array:
    """Spherical interpolation (used by transformUpdate's roll/pitch blend)."""
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_theta = jnp.sin(theta)
    small = sin_theta < 1e-5
    w0 = jnp.where(small, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.where(small, 1.0, sin_theta))
    w1 = jnp.where(small, t, jnp.sin(t * theta) / jnp.where(small, 1.0, sin_theta))
    q = w0 * q0 + w1 * q1
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# SE(3) as (R, t) pairs and as 6-vectors [rx, ry, rz, tx, ty, tz]
# ---------------------------------------------------------------------------

def se3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Twist (..., 6) [w, v] -> (R, t)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (so3_left_jacobian(w) @ v[..., None])[..., 0]
    return R, t


def se3_log(R: jax.Array, t: jax.Array) -> jax.Array:
    w = so3_log(R)
    Jinv = jnp.linalg.inv(so3_left_jacobian(w))
    v = (Jinv @ t[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform_points(R: jax.Array, t: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (R, t) to points (..., N, 3)."""
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


# pose6: the reference's transformTobeMapped layout [roll, pitch, yaw, x, y, z]
def pose6_to_Rt(pose6: jax.Array):
    return rpy_to_matrix(pose6[..., :3]), pose6[..., 3:]


def Rt_to_pose6(R: jax.Array, t: jax.Array):
    return jnp.concatenate([matrix_to_rpy(R), t], axis=-1)


def pose6_compose(a: jax.Array, b: jax.Array) -> jax.Array:
    Ra, ta = pose6_to_Rt(a)
    Rb, tb = pose6_to_Rt(b)
    R, t = compose(Ra, ta, Rb, tb)
    return Rt_to_pose6(R, t)


def pose6_inverse(a: jax.Array) -> jax.Array:
    R, t = pose6_to_Rt(a)
    Ri, ti = inverse(R, t)
    return Rt_to_pose6(Ri, ti)


def pose6_between(a: jax.Array, b: jax.Array) -> jax.Array:
    """a^{-1} ∘ b (gtsam `between`)."""
    return pose6_compose(pose6_inverse(a), b)
