"""Scan-to-map point-to-plane registration (Gauss-Newton with degeneracy gate).

Rebuild of the reference's hot loop
(`src/liorf/src/mapOptmization.cpp:1618-1897`):

- `surfOptimization` (:1618-1687): per scan point, 5-NN into the local map,
  plane fit by least squares (A·n = -1), plane validity (all 5 within 0.2 m),
  robust weight s = 1 − 0.9·|pd2| / sqrt(sqrt(range)), keep if s > 0.1.
- `LMOptimization` (:1702-1837): 6-dof GN step in [roll,pitch,yaw,x,y,z];
  normal equations JᵀWJ dx = −JᵀWf with W = s²; on the first iteration an
  eigendecomposition of JᵀWJ gates degenerate directions (eigenvalue < 100)
  and later updates are projected through P = V·diag(keep)·Vᵀ; convergence at
  |Δrot| < 0.05 deg and |Δtrans| < 0.05 cm; max 30 iterations.
- `transformUpdate` (:1867-1897): slerp roll/pitch toward the IMU attitude
  with weight imuRPYWeight, then clamp roll/pitch/z to tolerances.

Instead of the reference's per-point OpenMP loop + transcribed Euler-derivative
expressions, the whole scan is one batched pipeline: hash-grid or matmul
k-NN (`ops/voxel_grid.py`, `ops/knn.py`), batched 3x3 plane solves, rotation Jacobian via `jax.jacfwd`
of the Euler parameterization (exact, no hand-derived trig), masked
reductions into the 6x6 normal equations, and a `lax.while_loop` over GN
iterations so early convergence skips work under jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lio_slam_tpu.config import RegistrationConfig
from lio_slam_tpu.ops import knn as knn_mod
from lio_slam_tpu.ops import voxel_grid as vg
from lio_slam_tpu.utils import se3
from lio_slam_tpu.utils import smallmat


class Correspondences(NamedTuple):
    normal: jax.Array    # (N, 3) plane normals (map frame, unit)
    offset: jax.Array    # (N,)   plane offsets d (n·x + d = 0)
    residual: jax.Array  # (N,)   signed point-to-plane distance pd2
    weight: jax.Array    # (N,)   robust weight s
    valid: jax.Array     # (N,)   bool — survived all gates


class RegistrationResult(NamedTuple):
    pose: jax.Array        # (6,) refined [roll,pitch,yaw,x,y,z]
    degenerate: jax.Array  # () bool — eigenvalue gate fired
    converged: jax.Array   # () bool
    iterations: jax.Array  # () int32
    num_inliers: jax.Array # () int32 — correspondences in last iteration
    mean_residual: jax.Array  # () weighted mean |pd2| of last iteration


def _eigpair_3x3(A: jax.Array, which: str):
    """Closed-form eigenpair of batched symmetric 3x3 matrices (Smith's
    trigonometric method + row-cross eigenvector).  XLA's batched `eigh` runs
    an iterative solver per matrix; this is pure element-wise work that XLA
    fuses into the surrounding correspondence pass.

    which: "min" or "max" — returns (lam_which (...), lam_mid (...), v (..., 3)).
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2, 1e-20) / 6.0)
    inv_p = 1.0 / p
    # det(B)/2 with B = (A - qI)/p
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02)) * inv_p * inv_p * inv_p
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_max = q + 2.0 * p * jnp.cos(phi)
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    lam = lam_min if which == "min" else lam_max
    # eigenvector: cross of two rows of (A - lam I); pick the most
    # independent pair for stability
    m = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.stack([n01, n02, n12], axis=-1)
    pick = jnp.argmax(best, axis=-1)
    cands = jnp.stack([c01, c02, c12], axis=-2)            # (..., 3, 3)
    v = jnp.take_along_axis(cands, pick[..., None, None].repeat(3, -1),
                            axis=-2)[..., 0, :]
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    v = v / jnp.maximum(norm, 1e-12)
    # isotropic/degenerate neighbourhoods: p2 ~ 0 — any direction; callers
    # gate on lam_mid, so just return a unit z
    iso = p2 < 1e-12
    v = jnp.where(iso[..., None], jnp.array([0.0, 0.0, 1.0], A.dtype), v)
    return lam, lam_mid, v


def _smallest_eigpair_3x3(A: jax.Array):
    return _eigpair_3x3(A, "min")


def fit_planes(neighbors: jax.Array, neighbor_valid: jax.Array,
               plane_dist_thresh: float):
    """Least-squares plane through k neighbours: solve A·n = -1.

    neighbors: (N, k, 3); returns unit normals (N,3), offsets (N,), valid (N,).
    Mirrors surfOptimization's matA0/matB0 solve + 0.2 m validity gate.
    """
    k = neighbors.shape[1]
    A = neighbors                                       # (N, k, 3)
    # Centroid + covariance smallest-eigenvector fit.  (The reference solves
    # A·n = -1, a parameterization that cannot represent planes through the
    # origin and biases normals when |d| is small; the eigen fit is exact for
    # every plane and equally cheap batched.)
    centroid = jnp.mean(A, axis=1, keepdims=True)       # (N, 1, 3)
    centered = A - centroid
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / k
    _, lam_mid, normal = _smallest_eigpair_3x3(cov)
    offset = -jnp.einsum("ni,ni->n", normal, centroid[:, 0, :])
    # well-conditioned plane: require genuine in-plane spread (middle
    # eigenvalue = in-plane variance).  Near-collinear neighbourhoods would
    # otherwise yield arbitrary normals that still pass the distance gate.
    safe = lam_mid > 1e-3
    # plane validity: every neighbour within thresh of the plane
    dist = jnp.abs(jnp.einsum("nki,ni->nk", A, normal) + offset[:, None])
    plane_ok = jnp.all(jnp.where(neighbor_valid, dist, 0.0) <= plane_dist_thresh, axis=1)
    all_neighbors = jnp.all(neighbor_valid, axis=1) & (jnp.sum(neighbor_valid, axis=1) == k)
    valid = safe & plane_ok & all_neighbors
    return normal, offset, valid


def _largest_eigpair_3x3(A: jax.Array):
    return _eigpair_3x3(A, "max")


def fit_lines(neighbors: jax.Array, neighbor_valid: jax.Array,
              line_ratio: float = 3.0):
    """Edge-line fit through k neighbours: centroid + principal covariance
    direction, valid when the spread is genuinely 1D (lam_max > 3*lam_mid —
    upstream LOAM's cornerOptimization criterion; the liorf fork dropped the
    corner path, SURVEY.md §2.1 #4, but ships its feature extractor,
    `src/liorf/src/featureExtraction.cpp:141-237`).

    neighbors: (N, k, 3); returns (centroid (N,3), direction (N,3), valid (N,)).
    """
    k = neighbors.shape[1]
    centroid = jnp.mean(neighbors, axis=1, keepdims=True)
    centered = neighbors - centroid
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / k
    lam_max, lam_mid, direction = _largest_eigpair_3x3(cov)
    all_neighbors = jnp.all(neighbor_valid, axis=1)
    valid = (lam_max > line_ratio * jnp.maximum(lam_mid, 1e-9)) & all_neighbors
    return centroid[:, 0, :], direction, valid


def find_line_correspondences(scan: jax.Array, scan_mask: jax.Array,
                              map_pts: jax.Array, map_mask: jax.Array,
                              pose6: jax.Array, cfg: RegistrationConfig,
                              k: int = 5) -> Correspondences:
    """One cornerOptimization pass (upstream LOAM point-to-line): 5-NN among
    map edge points, principal-direction line fit, residual = distance to the
    line, gradient direction doubles as the Jacobian 'normal' so
    `_normal_equations` applies unchanged.

    Corner sets are small (<=20 edges/ring-sector, featureExtraction.cpp:141-
    237), so the exact brute-force matmul k-NN is the right backend here."""
    R, t = se3.pose6_to_Rt(pose6)
    scan_w = se3.transform_points(R, t, scan)
    res = knn_mod.knn(scan_w, scan_mask, map_pts, map_mask, k=k)
    neighbors = map_pts[res.idx]                        # (N, k, 3)
    nn_ok = res.valid[:, k - 1] & (res.dist2[:, k - 1] < cfg.nn_radius ** 2)
    center, direction, line_ok = fit_lines(neighbors, res.valid)
    rel = scan_w - center
    along = jnp.einsum("ni,ni->n", rel, direction)
    perp = rel - along[:, None] * direction             # residual vector
    ld2 = jnp.linalg.norm(perp, axis=-1)
    n = perp / jnp.maximum(ld2, 1e-9)[:, None]          # d(ld2)/d(p_w)
    s = 1.0 - 0.9 * jnp.abs(ld2)                        # LOAM corner weight
    valid = scan_mask & nn_ok & line_ok & (s > cfg.robust_weight_floor)
    return Correspondences(normal=n,
                           offset=-jnp.einsum("ni,ni->n", n, center),
                           residual=ld2,
                           weight=jnp.where(valid, s, 0.0), valid=valid)


def find_correspondences(scan: jax.Array, scan_mask: jax.Array,
                         map_pts: jax.Array, map_mask: jax.Array,
                         pose6: jax.Array, cfg: RegistrationConfig,
                         k: int = 5, grid=None) -> Correspondences:
    """One surfOptimization pass at the given pose.

    `grid`: optional prebuilt `voxel_grid.HashGrid` over the map — the
    production path (the map is static across GN iterations, so the grid is
    built once per scan instead of a kd-tree per scan like the reference)."""
    R, t = se3.pose6_to_Rt(pose6)
    scan_w = se3.transform_points(R, t, scan)           # pointAssociateToMap
    if grid is not None:
        nn = vg.query_knn(grid, scan_w, scan_mask, k=k,
                          halo=cfg.grid_halo)
        neighbors = nn.neighbors                         # (N, k, 3) coords
        nn_valid = nn.valid
    else:
        res = knn_mod.knn(scan_w, scan_mask, map_pts, map_mask, k=k)
        neighbors = map_pts[res.idx]                     # (N, k, 3)
        nn_valid = res.valid
        nn = res
    # kd-tree gate: 5th neighbour within nn_radius (pointSearchSqDis[4] < 1.0)
    nn_ok = nn_valid[:, k - 1] & (nn.dist2[:, k - 1] < cfg.nn_radius ** 2)
    normal, offset, plane_ok = fit_planes(neighbors, nn_valid, cfg.plane_dist_thresh)
    pd2 = jnp.einsum("ni,ni->n", normal, scan_w) + offset
    rng = jnp.linalg.norm(scan, axis=-1)
    s = 1.0 - 0.9 * jnp.abs(pd2) / jnp.sqrt(jnp.sqrt(jnp.maximum(rng, 1e-6)))
    valid = scan_mask & nn_ok & plane_ok & (s > cfg.robust_weight_floor)
    return Correspondences(normal=normal, offset=offset, residual=pd2,
                           weight=jnp.where(valid, s, 0.0), valid=valid)


def _normal_equations(scan: jax.Array, corr: Correspondences, pose6: jax.Array):
    """Build the 6x6 GN system in [roll,pitch,yaw,x,y,z] order.

    Row i: s_i · [ n·(∂R/∂θ_k p), n ],  rhs: −s_i · pd2_i  (LMOptimization's
    matA/matB with coeff = s·n already folded in)."""
    rpy = pose6[:3]
    dR = jax.jacfwd(se3.rpy_to_matrix)(rpy)             # (3, 3, 3): [i,j,k]=dR_ij/dθ_k
    # J_rot[n, k] = normal_n · (dR[:,:,k] @ p_n)
    Jrot = jnp.einsum("ni,ijk,nj->nk", corr.normal, dR, scan)
    J = jnp.concatenate([Jrot, corr.normal], axis=1)    # (N, 6)
    w = corr.weight * corr.weight
    AtA = jnp.einsum("ni,n,nj->ij", J, w, J)
    Atb = -jnp.einsum("ni,n,n->i", J, w, corr.residual)
    return AtA, Atb


def _degeneracy_projection(AtA: jax.Array, eig_thresh: float):
    """matP from LMOptimization (:1786-1814): zero the eigen-directions with
    eigenvalue < thresh; P = V diag(keep) Vᵀ."""
    eigval, eigvec = smallmat.eigh_jacobi(AtA)          # ascending
    keep = (eigval >= eig_thresh).astype(AtA.dtype)
    P = (eigvec * keep[None, :]) @ eigvec.T
    degenerate = jnp.any(eigval < eig_thresh)
    return P, degenerate


def _cell_sorted(scan: jax.Array, scan_mask: jax.Array, cell_size: float):
    """Sort scan points by voxel cell id (masked points last).

    The registration result is permutation-invariant (the 6x6 normal
    equations are a sum over points); sorting only changes the order in
    which the candidate buckets are read, so that spatially adjacent
    queries read the same buckets one after another.  Body-frame cells are
    used — rigid transforms preserve adjacency, so the world-frame gather
    inherits the locality."""
    c = jnp.clip(jnp.floor(scan / cell_size).astype(jnp.int32) + 512,
                 0, 1023)
    key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    key = jnp.where(scan_mask, key, jnp.int32(1 << 30))
    order = jnp.argsort(key)
    return scan[order], scan_mask[order]


class _LoopState(NamedTuple):
    pose: jax.Array
    P: jax.Array
    degenerate: jax.Array
    it: jax.Array
    converged: jax.Array
    num_inliers: jax.Array
    mean_residual: jax.Array


def _gn_loop(scan, scan_mask, corr_fn, init_pose6, cfg: RegistrationConfig,
             runnable, min_correspondences: int,
             ne_fn=None) -> RegistrationResult:
    """Shared GN iteration loop.

    `corr_fn(pose) -> Correspondences` feeds the normal-equation assembly;
    when `ne_fn` is given (`ne_fn(pose) -> (AtA, Atb, n_inliers, weight_sum,
    wres_sum)`, e.g. the summed surf + corner terms of `register_loam`) it
    replaces correspondence + normal-equation assembly wholesale."""

    def cond(st: _LoopState):
        return (st.it < cfg.max_iterations) & ~st.converged

    def body(st: _LoopState):
        if ne_fn is not None:
            AtA, Atb, n_inl, w_sum, wres_sum = ne_fn(st.pose)
        else:
            corr = corr_fn(st.pose)
            n_inl = jnp.sum(corr.valid.astype(jnp.int32))
            AtA, Atb = _normal_equations(scan, corr, st.pose)
            w_sum = jnp.sum(corr.weight)
            wres_sum = jnp.sum(corr.weight * jnp.abs(corr.residual))
        # Levenberg damping epsilon keeps the solve finite when rank-deficient;
        # the degeneracy projection handles the semantics.  Unrolled Cholesky
        # instead of a general 6x6 linalg.solve.
        dx = smallmat.cholesky_solve(AtA, Atb, eps=1e-6)

        # eigendecomposition only on the first iteration (iterCount == 0 in
        # the reference); later iterations skip the 6x6 eigh via cond
        P, degen = jax.lax.cond(
            st.it == 0,
            lambda _: _degeneracy_projection(AtA, cfg.degeneracy_eig_thresh),
            lambda _: (st.P, st.degenerate), None)
        dx = jnp.where(degen, P @ dx, dx)

        enough = n_inl >= min_correspondences
        dx = jnp.where(enough, dx, jnp.zeros_like(dx))
        pose = st.pose + dx

        delta_r_deg = jnp.linalg.norm(dx[:3]) * (180.0 / jnp.pi)
        delta_t_cm = jnp.linalg.norm(dx[3:]) * 100.0
        conv = ((delta_r_deg < cfg.rot_converge) & (delta_t_cm < cfg.trans_converge)) | ~enough
        mean_res = wres_sum / jnp.maximum(w_sum, 1e-6)
        return _LoopState(pose=pose, P=P, degenerate=degen, it=st.it + 1,
                          converged=conv, num_inliers=n_inl,
                          mean_residual=mean_res)

    init = _LoopState(pose=init_pose6.astype(jnp.float32),
                      P=jnp.eye(6, dtype=jnp.float32),
                      degenerate=jnp.zeros((), bool),
                      it=jnp.zeros((), jnp.int32),
                      converged=~runnable,
                      num_inliers=jnp.zeros((), jnp.int32),
                      mean_residual=jnp.zeros(()))
    st = jax.lax.while_loop(cond, body, init)
    return RegistrationResult(pose=st.pose, degenerate=st.degenerate,
                              converged=st.converged, iterations=st.it,
                              num_inliers=st.num_inliers,
                              mean_residual=st.mean_residual)


@partial(jax.jit, static_argnames=("cfg", "min_correspondences"))
def register(scan: jax.Array, scan_mask: jax.Array,
             map_pts: jax.Array, map_mask: jax.Array,
             init_pose6: jax.Array, cfg: RegistrationConfig,
             min_correspondences: int = 50) -> RegistrationResult:
    """Full scan2MapOptimization: iterate correspondence + GN to convergence.

    Skips (returns the initial pose) when the scan or map is too small, like
    the reference's `laserCloudSurfLastDSNum > 30` gate (:1841) and
    `laserCloudSelNum < 50` gate (:1724).
    """
    scan = scan.astype(jnp.float32)
    map_pts = map_pts.astype(jnp.float32)
    if cfg.sort_scan_by_cell:
        scan, scan_mask = _cell_sorted(scan, scan_mask, cfg.nn_radius)

    if cfg.knn_backend == "grid":
        # cell size = nn_radius so the 27-cell neighbourhood covers the gate
        grid = vg.build_grid(map_pts, map_mask, cfg.nn_radius,
                             cfg.grid_table_size, cfg.grid_max_per_cell,
                             halo=cfg.grid_halo)
    else:
        grid = None

    def corr_fn(pose):
        return find_correspondences(scan, scan_mask, map_pts, map_mask,
                                    pose, cfg, grid=grid)

    n_scan = jnp.sum(scan_mask.astype(jnp.int32))
    n_map = jnp.sum(map_mask.astype(jnp.int32))
    runnable = (n_scan > 30) & (n_map > 50)
    return _gn_loop(scan, scan_mask, corr_fn, init_pose6, cfg, runnable,
                    min_correspondences)


@partial(jax.jit, static_argnames=("cfg", "min_correspondences"))
def register_loam(scan_surf: jax.Array, surf_mask: jax.Array,
                  map_surf: jax.Array, map_surf_mask: jax.Array,
                  scan_corner: jax.Array, corner_mask: jax.Array,
                  map_corner: jax.Array, map_corner_mask: jax.Array,
                  init_pose6: jax.Array, cfg: RegistrationConfig,
                  min_correspondences: int = 50) -> RegistrationResult:
    """Full LOAM registration: point-to-plane (surf) + point-to-line (corner)
    terms summed into one 6x6 GN system per iteration.

    Exceeds the reference, which extracts features (featureExtraction.cpp)
    but runs surf-only (SURVEY.md §2.1 #4 — mapOptimization subscribes to
    `deskew/cloud_info`, not `feature/cloud_info`).  The corner term mirrors
    upstream LOAM / LIO-SAM cornerOptimization semantics: line fit via
    principal covariance direction, lam_max > 3*lam_mid validity, robust
    weight s = 1 - 0.9*|ld2|."""
    scan_surf = scan_surf.astype(jnp.float32)
    map_surf = map_surf.astype(jnp.float32)
    scan_corner = scan_corner.astype(jnp.float32)
    map_corner = map_corner.astype(jnp.float32)

    if cfg.knn_backend == "grid":
        grid = vg.build_grid(map_surf, map_surf_mask, cfg.nn_radius,
                             cfg.grid_table_size, cfg.grid_max_per_cell,
                             halo=cfg.grid_halo)
    else:
        grid = None

    ne_fn = _loam_combined_ne(scan_surf, surf_mask, grid,
                              map_surf, map_surf_mask,
                              scan_corner, corner_mask,
                              map_corner, map_corner_mask, cfg)
    n_scan = (jnp.sum(surf_mask.astype(jnp.int32))
              + jnp.sum(corner_mask.astype(jnp.int32)))
    n_map = (jnp.sum(map_surf_mask.astype(jnp.int32))
             + jnp.sum(map_corner_mask.astype(jnp.int32)))
    runnable = (n_scan > 30) & (n_map > 50)
    return _gn_loop(scan_surf, surf_mask, None, init_pose6, cfg, runnable,
                    min_correspondences, ne_fn=ne_fn)


def _loam_combined_ne(scan_surf, surf_mask, grid, map_surf, map_surf_mask,
                      scan_corner, corner_mask, map_corner, map_corner_mask,
                      cfg: RegistrationConfig):
    """Build the ne_fn summing the surf (point-to-plane) and corner
    (point-to-line) terms into one 6x6 GN system per iteration — shared by
    `register_loam` (rebuild-mode map arrays) and `register_loam_with_grid`
    (persistent incremental grid)."""

    def corner_term(pose):
        corr_c = find_line_correspondences(scan_corner, corner_mask,
                                           map_corner, map_corner_mask,
                                           pose, cfg)
        AtA_c, Atb_c = _normal_equations(scan_corner, corr_c, pose)
        return (AtA_c, Atb_c, jnp.sum(corr_c.valid.astype(jnp.int32)),
                jnp.sum(corr_c.weight),
                jnp.sum(corr_c.weight * jnp.abs(corr_c.residual)))

    def combine(surf_out, pose):
        corner_out = corner_term(pose)
        return tuple(a + b for a, b in zip(surf_out, corner_out))

    def surf_term(pose):
        corr_s = find_correspondences(scan_surf, surf_mask, map_surf,
                                      map_surf_mask, pose, cfg, grid=grid)
        AtA_s, Atb_s = _normal_equations(scan_surf, corr_s, pose)
        return (AtA_s, Atb_s, jnp.sum(corr_s.valid.astype(jnp.int32)),
                jnp.sum(corr_s.weight),
                jnp.sum(corr_s.weight * jnp.abs(corr_s.residual)))

    return lambda pose: combine(surf_term(pose), pose)


@partial(jax.jit, static_argnames=("cfg", "min_correspondences"))
def register_loam_with_grid(scan_surf: jax.Array, surf_mask: jax.Array,
                            grid,
                            scan_corner: jax.Array, corner_mask: jax.Array,
                            map_corner: jax.Array, map_corner_mask: jax.Array,
                            init_pose6: jax.Array, cfg: RegistrationConfig,
                            min_correspondences: int = 50) -> RegistrationResult:
    """LOAM surf+corner registration against the persistent incremental surf
    voxel map (the production path) + a flat corner map cloud.  Corner maps
    stay flat (no grid): corner counts are small enough that the exact brute
    matmul k-NN wins over a second hash grid's build cost per scan."""
    scan_surf = scan_surf.astype(jnp.float32)
    scan_corner = scan_corner.astype(jnp.float32)
    map_corner = map_corner.astype(jnp.float32)

    ne_fn = _loam_combined_ne(scan_surf, surf_mask, grid, None, None,
                              scan_corner, corner_mask,
                              map_corner, map_corner_mask, cfg)
    n_scan = (jnp.sum(surf_mask.astype(jnp.int32))
              + jnp.sum(corner_mask.astype(jnp.int32)))
    n_map = jnp.sum(grid.counts)
    runnable = (n_scan > 30) & (n_map > 50)
    return _gn_loop(scan_surf, surf_mask, None, init_pose6, cfg, runnable,
                    min_correspondences, ne_fn=ne_fn)


@partial(jax.jit, static_argnames=("cfg", "min_correspondences"))
def register_with_grid(scan: jax.Array, scan_mask: jax.Array,
                       grid, init_pose6: jax.Array, cfg: RegistrationConfig,
                       min_correspondences: int = 50) -> RegistrationResult:
    """scan2MapOptimization against a persistent (incremental) voxel map —
    the production path: no per-scan map assembly or grid build."""
    scan = scan.astype(jnp.float32)
    if cfg.sort_scan_by_cell:
        scan, scan_mask = _cell_sorted(scan, scan_mask, cfg.nn_radius)

    def corr_fn(pose):
        return find_correspondences(scan, scan_mask, None, None, pose, cfg,
                                    grid=grid)

    n_scan = jnp.sum(scan_mask.astype(jnp.int32))
    n_map = jnp.sum(grid.counts)
    runnable = (n_scan > 30) & (n_map > 50)
    return _gn_loop(scan, scan_mask, corr_fn, init_pose6, cfg, runnable,
                    min_correspondences)


def transform_update(pose6: jax.Array, imu_rpy: jax.Array,
                     imu_available: jax.Array, imu_rpy_weight: float,
                     rotation_tolerance: float = 1000.0,
                     z_tolerance: float = 1000.0) -> jax.Array:
    """Blend roll/pitch toward the IMU attitude and clamp (transformUpdate,
    mapOptmization.cpp:1867-1897).  Uses the same per-angle quaternion slerp
    the reference performs via tf::Quaternion."""
    def blend(angle, target):
        q0 = se3.matrix_to_quat(se3.rpy_to_matrix(jnp.array([angle, 0.0, 0.0])))
        q1 = se3.matrix_to_quat(se3.rpy_to_matrix(jnp.array([target, 0.0, 0.0])))
        q = se3.slerp(q0, q1, imu_rpy_weight)
        return se3.matrix_to_rpy(se3.quat_to_matrix(q))[0]

    roll = jnp.where(imu_available, blend(pose6[0], imu_rpy[0]), pose6[0])
    pitch = jnp.where(imu_available, blend(pose6[1], imu_rpy[1]), pose6[1])
    roll = jnp.clip(roll, -rotation_tolerance, rotation_tolerance)
    pitch = jnp.clip(pitch, -rotation_tolerance, rotation_tolerance)
    z = jnp.clip(pose6[5], -z_tolerance, z_tolerance)
    return pose6.at[0].set(roll).at[1].set(pitch).at[5].set(z)
