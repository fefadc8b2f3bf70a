"""Factor definitions for the keyframe pose graph.

Replacement for the GTSAM factor types the reference uses
(`src/liorf/src/mapOptmization.cpp:1930-2062`):

- `PriorFactor<Pose3>` on the first keyframe (:1933, variances
  [1e-2, 1e-2, pi^2, 1e8, 1e8, 1e8] in (rot, trans) tangent order)
- `BetweenFactor<Pose3>` odometry chain (:1939, variances [1e-6 x3, 1e-4 x3])
- `GPSFactor` position measurement (:2019)
- loop-closure `BetweenFactor`s with ICP-fitness or Cauchy-robust noise
  (:1144-1159, :1250-1264)

All factors live in fixed-capacity masked arrays so the whole graph is one
pytree of static shapes.  Errors follow gtsam conventions: tangent order is
(rotation, translation); between error = Log(M^{-1} X_i^{-1} X_j); poses are
retracted on the right: X <- X · Exp(delta).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lio_slam_tpu.utils import se3


class PoseGraph(NamedTuple):
    """Fixed-capacity factor graph over keyframe poses.

    K  = max keyframes, B = max between factors (odometry+loop), G = max GPS.
    """

    # variables
    poses: jax.Array        # (K, 6) pose6 [roll,pitch,yaw,x,y,z]
    pose_mask: jax.Array    # (K,) bool — keyframe exists

    # prior on keyframe 0
    prior_pose: jax.Array   # (6,) pose6 measurement
    prior_info: jax.Array   # (6,) information diag (1/sigma^2), (rot,trans)

    # between factors (odometry chain + accepted loops)
    bt_i: jax.Array         # (B,) int32 from-index
    bt_j: jax.Array         # (B,) int32 to-index
    bt_meas: jax.Array      # (B, 6) pose6 measurement (X_i^{-1} X_j)
    bt_info: jax.Array      # (B, 6) information diag (rot,trans)
    bt_mask: jax.Array      # (B,) bool

    # GPS (position) factors
    gps_i: jax.Array        # (G,) int32 keyframe index
    gps_meas: jax.Array     # (G, 3) ENU position
    gps_info: jax.Array     # (G, 3) information diag
    gps_mask: jax.Array     # (G,) bool


def empty_graph(max_keyframes: int, max_between: int, max_gps: int) -> PoseGraph:
    K, B, G = max_keyframes, max_between, max_gps
    return PoseGraph(
        poses=jnp.zeros((K, 6), jnp.float32),
        pose_mask=jnp.zeros(K, bool),
        prior_pose=jnp.zeros(6, jnp.float32),
        prior_info=jnp.zeros(6, jnp.float32),
        bt_i=jnp.zeros(B, jnp.int32), bt_j=jnp.zeros(B, jnp.int32),
        bt_meas=jnp.zeros((B, 6), jnp.float32),
        bt_info=jnp.zeros((B, 6), jnp.float32),
        bt_mask=jnp.zeros(B, bool),
        gps_i=jnp.zeros(G, jnp.int32),
        gps_meas=jnp.zeros((G, 3), jnp.float32),
        gps_info=jnp.zeros((G, 3), jnp.float32),
        gps_mask=jnp.zeros(G, bool),
    )


# ---------------------------------------------------------------------------
# error functions (gtsam conventions, tangent = [w, v])
# ---------------------------------------------------------------------------

def _retract(pose6: jax.Array, delta: jax.Array):
    """Right retraction: X · Exp(delta)."""
    R, t = se3.pose6_to_Rt(pose6)
    dR, dt = se3.se3_exp(delta)
    return se3.compose(R, t, dR, dt)


def prior_error(pose6: jax.Array, delta: jax.Array, meas6: jax.Array) -> jax.Array:
    """Log(M^{-1} · X·Exp(d)) in (rot, trans) order."""
    R, t = _retract(pose6, delta)
    Rm, tm = se3.pose6_to_Rt(meas6)
    Rmi, tmi = se3.inverse(Rm, tm)
    Re, te = se3.compose(Rmi, tmi, R, t)
    return se3.se3_log(Re, te)


def between_error(pose_i: jax.Array, pose_j: jax.Array,
                  delta_i: jax.Array, delta_j: jax.Array,
                  meas6: jax.Array) -> jax.Array:
    """Log(M^{-1} · (X_i Exp(d_i))^{-1} (X_j Exp(d_j)))."""
    Ri, ti = _retract(pose_i, delta_i)
    Rj, tj = _retract(pose_j, delta_j)
    Rii, tii = se3.inverse(Ri, ti)
    Rij, tij = se3.compose(Rii, tii, Rj, tj)
    Rm, tm = se3.pose6_to_Rt(meas6)
    Rmi, tmi = se3.inverse(Rm, tm)
    Re, te = se3.compose(Rmi, tmi, Rij, tij)
    return se3.se3_log(Re, te)


def gps_error(pose_i: jax.Array, delta_i: jax.Array, meas3: jax.Array) -> jax.Array:
    """Translation of the retracted pose minus the GPS ENU position."""
    _, t = _retract(pose_i, delta_i)
    return t - meas3


# Jacobians at delta = 0, batched over factors.
_prior_jac = jax.jacfwd(prior_error, argnums=1)
_between_jac_i = jax.jacfwd(between_error, argnums=2)
_between_jac_j = jax.jacfwd(between_error, argnums=3)
_gps_jac = jax.jacfwd(gps_error, argnums=1)

Z6 = lambda dtype=jnp.float32: jnp.zeros(6, dtype)


def linearize_prior(graph: PoseGraph):
    e = prior_error(graph.poses[0], Z6(), graph.prior_pose)
    J = _prior_jac(graph.poses[0], Z6(), graph.prior_pose)
    return e, J


def linearize_between(graph: PoseGraph):
    pi = graph.poses[graph.bt_i]
    pj = graph.poses[graph.bt_j]

    def one(pose_i, pose_j, meas):
        e = between_error(pose_i, pose_j, Z6(), Z6(), meas)
        Ji = _between_jac_i(pose_i, pose_j, Z6(), Z6(), meas)
        Jj = _between_jac_j(pose_i, pose_j, Z6(), Z6(), meas)
        return e, Ji, Jj

    return jax.vmap(one)(pi, pj, graph.bt_meas)


def linearize_gps(graph: PoseGraph):
    pi = graph.poses[graph.gps_i]

    def one(pose_i, meas):
        e = gps_error(pose_i, Z6(), meas)
        J = _gps_jac(pose_i, Z6(), meas)
        return e, J

    return jax.vmap(one)(pi, graph.gps_meas)


def graph_chi2(graph: PoseGraph, poses: jax.Array = None) -> jax.Array:
    """Total weighted squared error of all active factors at `poses`
    (default: the graph's own) — errors only, no Jacobians.  Used by the
    solvers' backtracking step control (a GN candidate step is only accepted
    if it REDUCES this cost; see graph/sparse.solve_sparse)."""
    if poses is None:
        poses = graph.poses
    z = Z6(poses.dtype)
    e0 = prior_error(poses[0], z, graph.prior_pose)
    chi2 = jnp.sum(graph.prior_info * e0 * e0)
    eb = jax.vmap(lambda pi, pj, m: between_error(pi, pj, z, z, m))(
        poses[graph.bt_i], poses[graph.bt_j], graph.bt_meas)
    wb = graph.bt_info * graph.bt_mask[:, None]
    chi2 = chi2 + jnp.sum(wb * eb * eb)
    eg = jax.vmap(lambda pi, m: gps_error(pi, z, m))(
        poses[graph.gps_i], graph.gps_meas)
    wg = graph.gps_info * graph.gps_mask[:, None]
    return chi2 + jnp.sum(wg * eg * eg)


# ---------------------------------------------------------------------------
# reference noise models (mapOptmization.cpp)
# ---------------------------------------------------------------------------

def info_from_variances(variances) -> jax.Array:
    """gtsam noiseModel::Diagonal::Variances -> information diagonal."""
    v = jnp.asarray(variances, jnp.float32)
    return 1.0 / jnp.maximum(v, 1e-12)


def cauchy_weight(e_norm2: jax.Array, k: float = 0.5) -> jax.Array:
    """gtsam mEstimator::Cauchy(k) weight for the SC loop factors (:1250)."""
    return 1.0 / (1.0 + e_norm2 / (k * k))
