"""Batched Gauss-Newton pose-graph solver.

Replacement for GTSAM iSAM2 as the reference uses it
(`src/liorf/src/mapOptmization.cpp:247-251, 2082-2092` and
`imuPreintegration.cpp`): dense block assembly of the normal equations as
matrix products + Cholesky solve, instead of incremental Bayes-tree updates (pointer
chasing, hostile to XLA).  Incremental-smoothing behavior is reproduced at the
call policy level: 2 GN iterations per new keyframe, extra iterations after
loop/GPS factors (the reference's `update()` x2 + x5 pattern), and marginal
covariances read from the same factorization (used for GPS gating via
poseCovariance(3,3)/(4,4), :2128-2133).

The solver is generic over which poses are free: `active_mask` selects the
sliding window (cheap per-scan solve) or the full graph (loop correction =
`correctPoses`, :2173-2204).

On Schur complements: classic visual/landmark BA reduces out landmark blocks
via the Schur complement before solving the camera system.  This graph has
no landmark variables — scan-to-map correspondences are folded into each
pose's 6x6 normal-equation block inside registration (`ops/registration.py`),
which IS the Schur trick applied at the measurement level: points never
become graph variables.  What remains is a pure pose chain + sparse
loop/GPS factors, for which the equilibrated dense/window Cholesky is the
right shape for a compiled batched program.  The distributed solve (`parallel/graph.py`) reduces
per-shard normal-equation blocks with psum — the Schur-style reduction
described in SURVEY.md §2.4.
"""

from __future__ import annotations

from functools import partial, wraps
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lio_slam_tpu.graph import factors as F
from lio_slam_tpu.utils import se3


class SolveResult(NamedTuple):
    graph: F.PoseGraph
    delta_norm: jax.Array   # () last-iteration update norm
    chi2: jax.Array         # () weighted squared error after solve


def _weighted_block(J: jax.Array, info: jax.Array) -> jax.Array:
    """J^T diag(info) J for a batch of factor Jacobians."""
    return jnp.einsum("...ri,...r,...rj->...ij", J, info, J)


def linearize_full(graph: F.PoseGraph, active_mask: jax.Array):
    """Assemble dense normal equations H (K6,K6), b (K6,) over active poses."""
    K = graph.poses.shape[0]
    dtype = graph.poses.dtype
    H = jnp.zeros((K, K, 6, 6), dtype)
    b = jnp.zeros((K, 6), dtype)

    # prior on pose 0
    e0, J0 = F.linearize_prior(graph)
    w0 = graph.prior_info
    H = H.at[0, 0].add(_weighted_block(J0, w0))
    b = b.at[0].add(-J0.T @ (w0 * e0))

    # between factors
    eb, Ji, Jj = F.linearize_between(graph)
    wb = graph.bt_info * graph.bt_mask[:, None]
    bi, bj = graph.bt_i, graph.bt_j
    H = H.at[bi, bi].add(_weighted_block(Ji, wb))
    H = H.at[bj, bj].add(_weighted_block(Jj, wb))
    Hij = jnp.einsum("bri,br,brj->bij", Ji, wb, Jj)
    H = H.at[bi, bj].add(Hij)
    H = H.at[bj, bi].add(jnp.swapaxes(Hij, -1, -2))
    b = b.at[bi].add(-jnp.einsum("bri,br,br->bi", Ji, wb, eb))
    b = b.at[bj].add(-jnp.einsum("bri,br,br->bi", Jj, wb, eb))

    # gps factors
    eg, Jg = F.linearize_gps(graph)
    wg = graph.gps_info * graph.gps_mask[:, None]
    gi = graph.gps_i
    H = H.at[gi, gi].add(_weighted_block(Jg, wg))
    b = b.at[gi].add(-jnp.einsum("gri,gr,gr->gi", Jg, wg, eg))

    # mask: zero rows/cols of inactive poses, identity diag so H stays SPD
    act = (active_mask & graph.pose_mask).astype(dtype)
    H = H * act[:, None, None, None] * act[None, :, None, None]
    eye6 = jnp.eye(6, dtype=dtype)
    H = H + jnp.einsum("k,ij->kij", 1.0 - act, eye6)[:, None] * \
        jnp.eye(K, dtype=dtype)[:, :, None, None]
    # damping for SPD robustness
    H = H + (jnp.eye(K, dtype=dtype)[:, :, None, None] * eye6) * 1e-5
    b = b * act[:, None]

    Hd = H.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
    bd = b.reshape(K * 6)

    chi2 = (jnp.sum(wb * eb * eb) + jnp.sum(wg * eg * eg)
            + jnp.sum(w0 * e0 * e0))
    return Hd, bd, chi2


def _equilibrated_cholesky_solve(H: jax.Array, b: jax.Array) -> jax.Array:
    """Solve H x = b robustly in float32.

    The reference's gtsam noise models span ~14 orders of magnitude
    (variances 1e-6 .. 1e8), which gtsam absorbs in float64; in float32 the
    raw normal equations come out slightly asymmetric and indefinite.  We
    symmetrize, Jacobi-equilibrate (D H D with D = diag(H)^{-1/2}, bringing
    the diagonal to ~1), add relative damping, and Cholesky-solve the scaled
    system."""
    H = 0.5 * (H + H.T)
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(H), 1e-12))
    Dinv = 1.0 / d
    Hs = H * Dinv[:, None] * Dinv[None, :]
    Hs = Hs + jnp.eye(H.shape[0], dtype=H.dtype) * 1e-5
    c = jax.scipy.linalg.cho_factor(Hs, lower=True)
    y = jax.scipy.linalg.cho_solve(c, b * Dinv)
    return y * Dinv


def _retract_all(graph: F.PoseGraph, delta: jax.Array,
                 active_mask: jax.Array) -> F.PoseGraph:
    K = graph.poses.shape[0]
    d = delta.reshape(K, 6)
    d = jnp.where((active_mask & graph.pose_mask)[:, None], d, 0.0)
    R, t = se3.pose6_to_Rt(graph.poses)
    dR, dt = se3.se3_exp(d)
    Rn, tn = se3.compose(R, t, dR, dt)
    return graph._replace(poses=se3.Rt_to_pose6(Rn, tn))


@partial(jax.jit, static_argnames=("iterations",))
def solve(graph: F.PoseGraph, active_mask: jax.Array,
          iterations: int = 2) -> SolveResult:
    """Run `iterations` GN steps over the active poses."""

    def step(_, carry):
        g, _, _ = carry
        H, b, chi2 = linearize_full(g, active_mask)
        delta = _equilibrated_cholesky_solve(H, b)
        # backtracking step control — same monotone-descent guard as
        # sparse.backtrack_step (a raw GN step on loop graphs with long
        # lever arms can overshoot and diverge with more iterations)
        from lio_slam_tpu.graph import sparse as _sp
        dmat = delta.reshape(g.poses.shape[0], 6)
        dmat = jnp.where((active_mask & g.pose_mask)[:, None], dmat, 0.0)
        new_poses, scale = _sp.backtrack_step(g, dmat, chi2)
        g2 = g._replace(poses=new_poses)
        return (g2, jnp.linalg.norm(delta) * scale, chi2)

    g, dn, chi2 = jax.lax.fori_loop(
        0, iterations, step,
        (graph, jnp.zeros((), graph.poses.dtype), jnp.zeros((), graph.poses.dtype)))
    return SolveResult(graph=g, delta_norm=dn, chi2=chi2)


def damping(dtype) -> float:
    """Relative diagonal damping of an equilibrated factorization: 1e-5
    keeps a float32 one positive definite; float64 needs only 1e-12."""
    return 1e-12 if dtype == jnp.float64 else 1e-5


def in_float64(marginal):
    """Run `marginal(graph, idx)` in float64, returning the graph's dtype.

    The GPS gate compares against poseCovThreshold (25 m²) a variance that
    the first pose's 1e8 m² translation prior dominates until a GPS factor
    lands.  A float32 factorization's 1e-5 relative damping caps every
    marginal near a few m² (odometry information 1e4 per keyframe), so the
    gate would never open."""

    @wraps(marginal)
    def wrapped(graph: F.PoseGraph, idx: jax.Array) -> jax.Array:
        with jax.enable_x64(True):
            g64 = jax.tree.map(
                lambda a: a.astype(jnp.float64)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, graph)
            return marginal(g64, idx).astype(graph.poses.dtype)

    return wrapped


@jax.jit
@in_float64
def marginal_covariance(graph: F.PoseGraph, idx: jax.Array) -> jax.Array:
    """(6,6) marginal covariance of pose `idx` — inv(H) block, like
    isam->marginalCovariance (mapOptmization.cpp:2128)."""
    K = graph.poses.shape[0]
    H, _, _ = linearize_full(graph, graph.pose_mask)
    H = 0.5 * (H + H.T)
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(H), 1e-12))
    Dinv = 1.0 / d
    Hs = H * Dinv[:, None] * Dinv[None, :]
    Hs = Hs + jnp.eye(H.shape[0], dtype=H.dtype) * damping(H.dtype)
    c = jax.scipy.linalg.cho_factor(Hs, lower=True)
    basis = jnp.zeros((K * 6, 6), H.dtype)
    rows = idx * 6 + jnp.arange(6)
    basis = basis.at[rows, jnp.arange(6)].set(1.0)
    cols = Dinv[:, None] * jax.scipy.linalg.cho_solve(c, basis * Dinv[:, None])
    return cols[rows.astype(jnp.int32), :]


@partial(jax.jit, static_argnames=("window", "iterations"))
def solve_window_compact(graph: F.PoseGraph, count: jax.Array,
                         window: int, iterations: int = 2) -> F.PoseGraph:
    """Sliding-window GN whose cost is independent of graph capacity.

    Extracts the last `window` keyframes and every factor touching them into
    a compact (window*6)^2 dense system; poses outside the window are held
    fixed (their side of a factor contributes error but no Jacobian block) —
    the standard fixed-lag approximation of iSAM2's incremental update.
    The full-graph `solve()` handles loop corrections.
    """
    K = graph.poses.shape[0]
    W = window
    start = jnp.maximum(count - W, 0)
    g_idx = start + jnp.arange(W)                 # global index per local slot
    local_of = lambda g: g - start                # global -> local
    slot_ok = g_idx < count

    def one_between(pi, pj, meas):
        e = F.between_error(pi, pj, F.Z6(), F.Z6(), meas)
        Ji = F._between_jac_i(pi, pj, F.Z6(), F.Z6(), meas)
        Jj = F._between_jac_j(pi, pj, F.Z6(), F.Z6(), meas)
        return e, Ji, Jj

    def gn_iter(_, g: F.PoseGraph) -> F.PoseGraph:
        dtype = g.poses.dtype
        H = jnp.zeros((W + 1, W + 1, 6, 6), dtype)   # +1 dump slot
        b = jnp.zeros((W + 1, 6), dtype)

        # prior on keyframe 0 (only in-window while count <= W)
        e0, J0 = F.linearize_prior(g)
        l0 = jnp.clip(local_of(0), -1, W)
        l0 = jnp.where((l0 >= 0) & (l0 < W), l0, W)
        w0 = g.prior_info
        H = H.at[l0, l0].add(_weighted_block(J0, w0))
        b = b.at[l0].add(-J0.T @ (w0 * e0))

        # between factors (odometry + loops)
        eb, Ji, Jj = jax.vmap(one_between)(g.poses[g.bt_i], g.poses[g.bt_j],
                                           g.bt_meas)
        li = local_of(g.bt_i)
        lj = local_of(g.bt_j)
        in_i = (li >= 0) & (li < W) & g.bt_mask
        in_j = (lj >= 0) & (lj < W) & g.bt_mask
        li = jnp.where(in_i, li, W)
        lj = jnp.where(in_j, lj, W)
        wb = g.bt_info * g.bt_mask[:, None]
        wb_i = wb * in_i[:, None]
        wb_j = wb * in_j[:, None]
        H = H.at[li, li].add(_weighted_block(Ji, wb_i))
        H = H.at[lj, lj].add(_weighted_block(Jj, wb_j))
        Hij = jnp.einsum("bri,br,brj->bij", Ji, wb * (in_i & in_j)[:, None], Jj)
        H = H.at[li, lj].add(Hij)
        H = H.at[lj, li].add(jnp.swapaxes(Hij, -1, -2))
        b = b.at[li].add(-jnp.einsum("bri,br,br->bi", Ji, wb_i, eb))
        b = b.at[lj].add(-jnp.einsum("bri,br,br->bi", Jj, wb_j, eb))

        # gps factors
        eg, Jg = F.linearize_gps(g)
        lg = local_of(g.gps_i)
        in_g = (lg >= 0) & (lg < W) & g.gps_mask
        lg = jnp.where(in_g, lg, W)
        wg = g.gps_info * in_g[:, None]
        H = H.at[lg, lg].add(_weighted_block(Jg, wg))
        b = b.at[lg].add(-jnp.einsum("gri,gr,gr->gi", Jg, wg, eg))

        H = H[:W, :W]
        b = b[:W]
        act = slot_ok.astype(dtype)
        H = H * act[:, None, None, None] * act[None, :, None, None]
        eye6 = jnp.eye(6, dtype=dtype)
        H = H + jnp.einsum("k,ij->kij", 1.0 - act, eye6)[:, None] * \
            jnp.eye(W, dtype=dtype)[:, :, None, None]
        Hd = H.transpose(0, 2, 1, 3).reshape(W * 6, W * 6)
        bd = (b * act[:, None]).reshape(W * 6)

        delta = _equilibrated_cholesky_solve(Hd, bd).reshape(W, 6)
        delta = jnp.where(slot_ok[:, None], delta, 0.0)

        # retract window poses back into the full array
        R, t = se3.pose6_to_Rt(g.poses[g_idx])
        dR, dt = se3.se3_exp(delta)
        Rn, tn = se3.compose(R, t, dR, dt)
        new_poses = g.poses.at[g_idx].set(
            jnp.where(slot_ok[:, None], se3.Rt_to_pose6(Rn, tn),
                      g.poses[g_idx]))
        return g._replace(poses=new_poses)

    return jax.lax.fori_loop(0, iterations, gn_iter, graph)


def window_mask(pose_mask: jax.Array, num_keyframes: jax.Array,
                window: int) -> jax.Array:
    """Mask of the last `window` active keyframes (sliding-window solve)."""
    K = pose_mask.shape[0]
    idx = jnp.arange(K)
    return pose_mask & (idx >= jnp.maximum(num_keyframes - window, 0))
