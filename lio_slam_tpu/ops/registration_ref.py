"""Float64 NumPy reference of one scan-to-map normal-equation pass.

The plain reference for `registration.find_correspondences` +
`registration._normal_equations` on the hash-grid path, written from the
reference's semantics (`mapOptmization.cpp:1618-1784`, with this repo's
covariance plane fit) and sharing no code with it:

- exact 5-NN in float64 over the occupied slots of the same candidate cells
  (the query's halo cells of the grid table, a bucket scanned once when two
  cells hash to it);
- 5th neighbour within `nn_radius`;
- covariance plane fit (`np.linalg.eigh`), middle eigenvalue above 1e-3,
  every neighbour within `plane_dist_thresh` of the plane;
- robust weight s = 1 - 0.9 |pd2| / sqrt(sqrt(range)), kept when s > floor;
- Jacobian rows [n . (dR/dtheta_k p), n] from the analytic derivative of
  R = Rz(yaw) Ry(pitch) Rx(roll), weights s^2.

It also flags the points whose outcome float32 rounding can flip
(`ReferenceResult.borderline`): within `margin` of a gate, of a cell
boundary, or with a 5th/6th neighbour tie.  A float32 implementation may
legitimately decide those either way, so comparisons leave them out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_HASH = (73856093, 19349663, 83492791)


class ReferenceResult(NamedTuple):
    AtA: np.ndarray          # (6, 6)
    Atb: np.ndarray          # (6,)
    n_inliers: int
    weight_sum: float
    wres_sum: float
    wres2_sum: float         # sum s^2 pd2^2 (scale for comparing Atb)
    valid: np.ndarray        # (N,) bool
    borderline: np.ndarray   # (N,) bool


def query_offsets(halo: str) -> np.ndarray:
    """Cells a query scans for each insert layout (see ops/voxel_grid.py)."""
    r = np.arange(-1, 2)
    if halo == "none":
        g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
    elif halo == "z":
        g = np.stack(np.meshgrid(r, r, [0], indexing="ij"), -1)
    elif halo == "xy":
        g = np.array([[0, 0, 0], [0, 0, -1], [0, 0, 1]])
    elif halo == "full":
        g = np.zeros((1, 3))
    else:
        raise ValueError(f"unknown halo {halo!r}")
    return g.reshape(-1, 3).astype(np.int64)


def insert_offsets(halo: str) -> np.ndarray:
    """Cells each map point is inserted under for each layout: the insert
    and query sides of a layout together cover the 27-cell neighbourhood."""
    return query_offsets({"none": "full", "z": "xy", "xy": "z",
                          "full": "none"}[halo])


def _row_keys(bucket: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    """One opaque 16-byte key per (bucket, float32 point) row."""
    bits = np.ascontiguousarray(xyz, np.float32).view(np.uint32).astype(np.uint64)
    k = np.stack([(bucket.astype(np.uint64) << np.uint64(32)) | bits[:, 0],
                  (bits[:, 1] << np.uint64(32)) | bits[:, 2]], axis=1)
    return np.ascontiguousarray(k).view(np.dtype((np.void, 16))).ravel()


def grid_table_errors(table, counts, points, cell_size: float,
                      halo: str = "z", empty: float = 1e6) -> dict:
    """Check a grid built from an empty table over `points` (one insert)
    against the points themselves.

    Each point goes to the buckets of its insert cells (a bucket once when
    two of them hash to it), so bucket b receives n_b rows and keeps
    min(n_b, C) of them; which ones survive an overflow is not specified.
    Returns the number of buckets whose count is not min(n_b, C)
    (`count_errors`), of slots whose occupancy disagrees with the count
    (`slot_errors`), and of occupied slots holding no point that hashes to
    that bucket, or holding one more often than it hashes there
    (`stray_rows`)."""
    table = np.asarray(table, np.float32)
    counts = np.asarray(counts, np.int64)
    pts = np.asarray(points, np.float32)
    T, C, _ = table.shape
    offs = insert_offsets(halo)
    cells = np.floor(pts / np.float32(cell_size)).astype(np.int64)
    hb = _bucket_ids(cells[:, None, :] + offs[None], T)            # (M, K)
    first = np.ones_like(hb, bool)
    for o in range(1, offs.shape[0]):
        first[:, o] = ~np.any(hb[:, :o] == hb[:, o:o + 1], axis=1)
    rows_b = hb[first]
    rows_p = np.broadcast_to(pts[:, None, :], hb.shape + (3,))[first]
    n_b = np.bincount(rows_b, minlength=T)
    occupied = np.all(table != np.float32(empty), axis=-1)         # (T, C)
    should = np.arange(C)[None, :] < counts[:, None]
    b_idx, s_idx = np.nonzero(occupied)
    exp_u, exp_n = np.unique(_row_keys(rows_b, rows_p), return_counts=True)
    occ_u, occ_n = np.unique(_row_keys(b_idx, table[b_idx, s_idx]),
                             return_counts=True)
    at = np.minimum(np.searchsorted(exp_u, occ_u), len(exp_u) - 1)
    known = exp_u[at] == occ_u
    stray = np.where(known, np.maximum(occ_n - exp_n[at], 0), occ_n)
    return {"count_errors": int(np.sum(counts != np.minimum(n_b, C))),
            "slot_errors": int(np.sum(occupied != should)),
            "stray_rows": int(stray.sum())}


def rpy_to_matrix(rpy) -> np.ndarray:
    r, p, y = (float(v) for v in rpy)
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    dRx = np.array([[0, 0, 0], [0, -sr, -cr], [0, cr, -sr]])
    dRy = np.array([[-sp, 0, cp], [0, 0, 0], [-cp, 0, -sp]])
    dRz = np.array([[-sy, -cy, 0], [cy, -sy, 0], [0, 0, 0]])
    R = Rz @ Ry @ Rx
    dR = np.stack([Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx], axis=-1)
    return R, dR                                   # dR[i, j, k] = dR_ij/dθ_k


def _bucket_ids(cells: np.ndarray, T: int) -> np.ndarray:
    c = cells.astype(np.int32)
    h = ((c[..., 0] * np.int32(_HASH[0])) ^ (c[..., 1] * np.int32(_HASH[1]))
         ^ (c[..., 2] * np.int32(_HASH[2])))
    return np.abs(h.astype(np.int64)) % T


def normal_equations(table, cell_size: float, scan, scan_mask, pose6,
                     halo: str = "z", k: int = 5, nn_radius: float = 1.0,
                     plane_dist_thresh: float = 0.2,
                     robust_weight_floor: float = 0.1,
                     empty: float = 1e6, margin: float = 1e-4,
                     ) -> ReferenceResult:
    """The 6x6 system of one surfOptimization pass at `pose6`.

    table: (T, C, 3) grid table (slots holding `empty` are unoccupied);
    scan: (N, 3) body-frame points; pose6: [roll, pitch, yaw, x, y, z]."""
    table = np.asarray(table, np.float64)
    scan = np.asarray(scan, np.float64)
    mask = np.asarray(scan_mask, bool)
    T, C, _ = table.shape
    N = scan.shape[0]
    R, dR = rpy_to_matrix(np.asarray(pose6, np.float64)[:3])
    q = scan @ R.T + np.asarray(pose6, np.float64)[3:]

    # candidate slots of the halo cells, each bucket scanned once
    u = q / float(cell_size)
    cell = np.floor(u).astype(np.int64)
    frac = u - cell
    near_edge = np.any((frac < margin) | (frac > 1.0 - margin), axis=1)
    offs = query_offsets(halo)
    hh = _bucket_ids(cell[:, None, :] + offs[None], T)           # (N, O)
    O = offs.shape[0]
    dup = np.zeros_like(hh, bool)
    for o in range(1, O):
        dup[:, o] = np.any(hh[:, :o] == hh[:, o:o + 1], axis=1)
    cand = table[hh].reshape(N, O * C, 3)
    occupied = (np.repeat(~dup, C, axis=1)
                & np.all(cand != empty, axis=-1))
    d2 = np.where(occupied, np.sum((cand - q[:, None, :]) ** 2, -1), np.inf)

    order = np.argsort(d2, axis=1, kind="stable")[:, :k + 1]
    dk = np.take_along_axis(d2, order, 1)
    nbr = np.take_along_axis(cand, order[:, :k, None], 1)           # (N, k, 3)
    have_k = np.isfinite(dk[:, k - 1])
    with np.errstate(invalid="ignore"):          # inf - inf past the last slot
        tie = np.isfinite(dk[:, k]) & (np.abs(dk[:, k] - dk[:, k - 1]) < margin)
    nn_ok = have_k & (dk[:, k - 1] < nn_radius ** 2)
    nn_edge = have_k & (np.abs(dk[:, k - 1] - nn_radius ** 2) < margin)

    nbr = np.where(have_k[:, None, None], nbr, 0.0)
    centroid = nbr.mean(axis=1)
    cen = nbr - centroid[:, None, :]
    cov = np.einsum("nki,nkj->nij", cen, cen) / k
    lam, vec = np.linalg.eigh(cov)
    normal = vec[:, :, 0]
    offset = -np.einsum("ni,ni->n", normal, centroid)
    lam_mid = lam[:, 1]
    dist = np.abs(np.einsum("nki,ni->nk", nbr, normal) + offset[:, None])
    plane_ok = (lam_mid > 1e-3) & np.all(dist <= plane_dist_thresh, axis=1)
    plane_edge = ((np.abs(lam_mid - 1e-3) < margin * 1e-1)
                  | np.any(np.abs(dist - plane_dist_thresh) < margin, axis=1))

    pd2 = np.einsum("ni,ni->n", normal, q) + offset
    rng = np.linalg.norm(scan, axis=1)
    s = 1.0 - 0.9 * np.abs(pd2) / np.sqrt(np.sqrt(np.maximum(rng, 1e-6)))
    valid = mask & nn_ok & plane_ok & (s > robust_weight_floor)
    s_edge = np.abs(s - robust_weight_floor) < margin

    w_s = np.where(valid, s, 0.0)
    w = w_s * w_s
    Jrot = np.einsum("ni,ijk,nj->nk", normal, dR, scan)
    J = np.concatenate([Jrot, normal], axis=1)
    borderline = mask & (near_edge | tie | nn_edge
                         | (nn_ok & (plane_edge | s_edge)))
    return ReferenceResult(
        AtA=np.einsum("ni,n,nj->ij", J, w, J),
        Atb=-np.einsum("ni,n,n->i", J, w, pd2),
        n_inliers=int(valid.sum()), weight_sum=float(w_s.sum()),
        wres_sum=float(np.sum(w_s * np.abs(pd2))),
        wres2_sum=float(np.sum(w * pd2 * pd2)),
        valid=valid, borderline=borderline)


def normal_equation_errors(AtA, Atb, n_inliers, weight_sum, wres_sum,
                           ref: ReferenceResult) -> dict:
    """Scale-aware errors of a float32 system against the reference.

    An entry of a Gram matrix is bounded by sqrt(A_ii A_jj) (Cauchy-Schwarz),
    so AtA_ij is compared relative to that, and Atb_i relative to
    sqrt(A_ii * sum s^2 pd2^2).  Entries that cancel to near zero would
    otherwise be held to a relative bound their own float32 rounding
    cannot meet."""
    AtA = np.asarray(AtA, np.float64)
    Atb = np.asarray(Atb, np.float64)
    d = np.sqrt(np.maximum(np.diag(ref.AtA), 1e-30))
    return {
        "AtA_rel": float(np.max(np.abs(AtA - ref.AtA) / np.outer(d, d))),
        "Atb_rel": float(np.max(np.abs(Atb - ref.Atb)
                                / (d * np.sqrt(max(ref.wres2_sum, 1e-30))))),
        "inlier_diff": int(n_inliers) - ref.n_inliers,
        "weight_sum_rel": abs(float(weight_sum) - ref.weight_sum)
        / max(ref.weight_sum, 1e-30),
        "wres_sum_rel": abs(float(wres_sum) - ref.wres_sum)
        / max(ref.wres_sum, 1e-30),
    }
