"""Spatial hash-grid neighbour search — the production k-NN path.

The reference rebuilds a PCL kd-tree over the local map every scan
(`mapOptmization.cpp:1846`) and queries 5-NN per point per GN iteration
(:1631).  Kd-trees are pointer-chasing; the equivalent here is a voxel
bucket grid in **bucket-major layout**: points live in a (T buckets x C slots
x 3) table, so a query gathers whole buckets as wide contiguous rows instead
of hundreds of scattered 12 B rows.  The design dial is *insert
multiplicity vs gather width*:

- halo="none": each point inserted once; a query scans the 27 surrounding
  cells (27 narrow gathers).
- halo="z": each point also inserted under its z±1 cell keys; a query scans
  the 9 xy-neighbour cells (the default).
- halo="xy": each point inserted under its 9 xy-neighbourhood cell keys; a
  query scans only z±1 — 3 wide rows per query; bucket cap must be ~3-4x
  "z".
- halo="full": each point inserted under all 27 neighbour cell keys; a query
  gathers exactly ONE bucket — a single contiguous C·12 B row per query.  27x
  insert rows are amortized by the incremental map (inserts happen per
  keyframe, queries per GN iteration per scan).

Which layout wins depends on what the mission carries (grid state size and
insert volume), not on the isolated gather; "z" is the default.

Build/insert emit one (bucket, point) row per halo offset, sort all rows by
bucket once, rank within runs, and scatter — rows of distinct cells that
hash-collide into one bucket merge into a single correctly-ranked run (a
per-offset rank-reuse shortcut was tried and loses ~20% of points at
realistic cell-to-bucket load factors).

Hash collisions merely add far-away candidates (distance-filtered), never
wrong neighbours.  One rare artifact is accepted (bounded by pairs/table_size
~1%): a point whose offset cells hash-collide inserts twice into that bucket,
wasting a slot.  Bucket overflow overwrites ring-buffer style (oldest first),
which bounds memory like the reference's rolling 50 m local map window.

Empty slots hold SENTINEL coordinates (1e6) so queries need no occupancy
gather: sentinel candidates lose every distance comparison naturally.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BIG = jnp.float32(1e30)
SENTINEL = 1e6           # empty-slot coordinate; d2 >= ~1e12 >> any real match
_VALID_MAX = 1e10        # d2 above this means "sentinel / no neighbour"


class HashGrid(NamedTuple):
    """Bucket-major point table.  T, C are static (from shape).  The halo
    layout (see module docstring) is a compile-time property passed to
    build/insert/query (wired from `RegistrationConfig.grid_halo`), never a
    traced value."""

    table: jax.Array         # (T, C, 3) float32 points (SENTINEL where empty)
    counts: jax.Array        # (T,) int32 inserted slots per bucket (capped C)
    cell_size: jax.Array     # () float32


class NeighborResult(NamedTuple):
    """k nearest neighbours with coordinates materialized (no secondary
    gather needed by the consumer)."""

    neighbors: jax.Array     # (N, k, 3) coordinates (garbage where ~valid)
    dist2: jax.Array         # (N, k)
    valid: jax.Array         # (N, k)


def _cell_hash(coords: jax.Array, table_size: int) -> jax.Array:
    h = (coords[..., 0] * 73856093) ^ (coords[..., 1] * 19349663) \
        ^ (coords[..., 2] * 83492791)
    return jnp.abs(h) % table_size


_OFFSETS_27 = jnp.stack(jnp.meshgrid(
    jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2),
    indexing="ij"), axis=-1).reshape(27, 3)

_OFFSETS_Z3 = jnp.array([[0, 0, 0], [0, 0, -1], [0, 0, 1]], jnp.int32)

_OFFSETS_XY9 = jnp.stack(jnp.meshgrid(
    jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(0, 1),
    indexing="ij"), axis=-1).reshape(9, 3)

_OFFSETS_1 = jnp.zeros((1, 3), jnp.int32)

# insert multiplicity per layout / cells a query must scan per layout
_INSERT_OFFSETS = {"none": _OFFSETS_1, "z": _OFFSETS_Z3, "xy": _OFFSETS_XY9,
                   "full": _OFFSETS_27}
_QUERY_OFFSETS = {"none": _OFFSETS_27, "z": _OFFSETS_XY9, "xy": _OFFSETS_Z3,
                  "full": _OFFSETS_1}


def _insert_core(table: jax.Array, counts: jax.Array, points: jax.Array,
                 mask: jax.Array, cell_size: jax.Array, halo: str):
    """Shared build/insert: emit K halo rows per point, sort all rows by
    target bucket, rank within runs, scatter (see module docstring)."""
    T, C, _ = table.shape
    offsets = _INSERT_OFFSETS[halo].astype(jnp.int32)
    K = offsets.shape[0]
    M = points.shape[0]
    coords = jnp.floor(points / cell_size).astype(jnp.int32)       # (M, 3)
    cells = coords[:, None, :] + offsets[None]                     # (M, K, 3)
    h = _cell_hash(cells, T)                                       # (M, K)
    if K > 1:
        # offset cells of the SAME point may hash-collide; a double insert
        # wastes a slot and would double-count the point as a candidate
        dup = jnp.any((h[:, :, None] == h[:, None, :])
                      & (jnp.arange(K)[None, :, None]
                         > jnp.arange(K)[None, None, :]), axis=2)  # (M, K)
        keep_row = mask[:, None] & ~dup
    else:
        keep_row = jnp.broadcast_to(mask[:, None], (M, K))
    hf = jnp.where(keep_row, h, T).reshape(-1)        # invalid rows sort last
    pts = jnp.broadcast_to(points[:, None, :], (M, K, 3)).reshape(-1, 3)
    # multi-operand sort carries the coordinates through the sort network
    # directly (cheaper than an argsort plus three row gathers)
    h_s, px_s, py_s, pz_s = jax.lax.sort(
        (hf, pts[:, 0], pts[:, 1], pts[:, 2]), num_keys=1)
    pts_s = jnp.stack([px_s, py_s, pz_s], axis=-1)
    # within-bucket rank = position - first position of this bucket value
    first = jnp.concatenate([jnp.array([True]), h_s[1:] != h_s[:-1]])
    pos = jnp.arange(h_s.shape[0], dtype=jnp.int32)
    run_start = jax.lax.associative_scan(jnp.maximum, jnp.where(first, pos, 0))
    rank = pos - run_start
    ok = (h_s < T) & (rank < C)                   # at most C new per bucket
    base = jnp.where(h_s < T, counts[jnp.minimum(h_s, T - 1)], 0)
    slot = (base + rank) % C                      # ring overwrite on overflow
    dst_b = jnp.where(ok, h_s, T)
    padded = jnp.concatenate([table, jnp.full((1, C, 3), SENTINEL,
                                              table.dtype)], axis=0)
    padded = padded.at[dst_b, jnp.where(ok, slot, 0)].set(pts_s)
    new = jnp.zeros(T + 1, jnp.int32).at[dst_b].add(ok.astype(jnp.int32))
    counts = jnp.minimum(counts + new[:T], C)
    return padded[:T], counts


@partial(jax.jit, static_argnames=("table_size", "max_per_cell", "halo", "chunk"))
def build_grid(points: jax.Array, mask: jax.Array, cell_size: float,
               table_size: int = 32768, max_per_cell: int = 16,
               halo: str = "none", chunk: int = 262144) -> HashGrid:
    """Build a grid over `points`.  Inputs beyond `chunk` points are
    inserted in chunk-sized pieces under a fori_loop: the insert's
    multi-operand lax.sort has K halo rows per point, and one sort over a
    whole full-map rebuild (millions of rows at K=2048 keyframes) is a
    program whose compile time grows superlinearly; chunked inserts compile
    quickly and cost ~nc sequential sorts at loop-event cadence."""
    cs = jnp.float32(cell_size)
    table = jnp.full((table_size, max_per_cell, 3), SENTINEL, points.dtype)
    counts = jnp.zeros(table_size, jnp.int32)
    M = points.shape[0]
    if M <= chunk:
        table, counts = _insert_core(table, counts, points, mask, cs, halo)
    else:
        nc = -(-M // chunk)
        pad = nc * chunk - M
        pts = jnp.concatenate(
            [points, jnp.zeros((pad, 3), points.dtype)], axis=0)
        msk = jnp.concatenate([mask, jnp.zeros(pad, bool)])
        pts = pts.reshape(nc, chunk, 3)
        msk = msk.reshape(nc, chunk)

        def body(i, carry):
            t, c = carry
            return _insert_core(t, c, pts[i], msk[i], cs, halo)

        table, counts = jax.lax.fori_loop(0, nc, body, (table, counts))
    return HashGrid(table=table, counts=counts, cell_size=cs)


@partial(jax.jit, static_argnames=("halo",))
def insert_points(grid: HashGrid, points: jax.Array, mask: jax.Array,
                  halo: str = "none") -> HashGrid:
    """Incrementally insert points into an existing grid (the rolling local
    map: new keyframe clouds are scattered in; no per-scan rebuild)."""
    table, counts = _insert_core(grid.table, grid.counts, points, mask,
                                 grid.cell_size, halo)
    return HashGrid(table=table, counts=counts, cell_size=grid.cell_size)


@partial(jax.jit, static_argnames=("k", "halo"))
def query_knn(grid: HashGrid, queries: jax.Array, query_mask: jax.Array,
              k: int = 5, halo: str = "none") -> NeighborResult:
    """Exact k-NN among the candidates in the cells around each query
    (27 cells for halo="none", 9 xy cells for "z", the query's own bucket
    for "full" — matching how the grid was built).

    Correct for any neighbour within `cell_size` of the query (the radius the
    registration gate uses) as long as bucket occupancy <= C.

    Layout: offset-major — every intermediate keeps the N queries as the
    LAST dimension, so the small (O, C)-sized dims are never the minor axis.
    """
    T, C, _ = grid.table.shape
    N = queries.shape[0]
    offsets = _QUERY_OFFSETS[halo]
    O = offsets.shape[0]
    qT = queries.T                                                   # (3, N)
    coords = jnp.floor(qT / grid.cell_size).astype(jnp.int32)        # (3, N)
    offs = offsets.T.astype(jnp.int32)                               # (3, O)
    cells = coords[:, None, :] + offs[:, :, None]                    # (3, O, N)
    h = (cells[0] * 73856093) ^ (cells[1] * 19349663) ^ (cells[2] * 83492791)
    hh = jnp.abs(h) % T                                              # (O, N)
    flat = grid.table.reshape(T, C * 3)
    cand = flat[hh]                                                  # (O, N, 3C) wide gather
    candT = jnp.swapaxes(cand, 1, 2).reshape(O, C, 3, N)
    R = O * C
    cx = candT[:, :, 0, :].reshape(R, N)
    cy = candT[:, :, 1, :].reshape(R, N)
    cz = candT[:, :, 2, :].reshape(R, N)
    d2 = ((cx - qT[0][None, :]) ** 2 + (cy - qT[1][None, :]) ** 2
          + (cz - qT[2][None, :]) ** 2)
    if O > 1:
        # distinct offset cells may hash-collide to the same bucket; scanning
        # it twice would duplicate candidates and crowd out true neighbours
        dup = jnp.any((hh[:, None, :] == hh[None, :, :])
                      & (jnp.arange(O)[:, None, None]
                         > jnp.arange(O)[None, :, None]),
                      axis=1)                                        # (O, N)
        slot_ok = ~jnp.broadcast_to(dup[:, None, :], (O, C, N))
        d2 = jnp.where(slot_ok.reshape(R, N), d2, _BIG)
    # k iterative masked mins along the (small) candidate axis.  Extraction
    # is by one-hot masked reductions instead of a scatter/take_along_axis
    # per k: XLA fuses each round into one reduction over the candidates.
    rows = jax.lax.broadcasted_iota(jnp.int32, (R, 1), 0)
    nbs, dsts = [], []
    dd = d2
    for _ in range(k):
        am = jnp.argmin(dd, axis=0)                                  # (N,)
        hot = rows == am[None, :]                                    # (R, N)
        dmin = jnp.min(dd, axis=0)
        nx = jnp.sum(jnp.where(hot, cx, 0.0), axis=0)
        ny = jnp.sum(jnp.where(hot, cy, 0.0), axis=0)
        nz = jnp.sum(jnp.where(hot, cz, 0.0), axis=0)
        nbs.append(jnp.stack([nx, ny, nz], axis=-1))
        dsts.append(dmin)
        dd = jnp.where(hot, _BIG, dd)
    neighbors = jnp.stack(nbs, axis=1)                               # (N, k, 3)
    best_d = jnp.stack(dsts, axis=1)                                 # (N, k)
    valid = (best_d < _VALID_MAX) & query_mask[:, None]
    return NeighborResult(neighbors=neighbors,
                          dist2=jnp.where(valid, jnp.maximum(best_d, 0.0), _BIG),
                          valid=valid)


def empty_grid(cell_size: float, table_size: int = 32768,
               max_per_cell: int = 16, dtype=jnp.float32) -> HashGrid:
    return HashGrid(
        table=jnp.full((table_size, max_per_cell, 3), SENTINEL, dtype),
        counts=jnp.zeros(table_size, jnp.int32),
        cell_size=jnp.float32(cell_size))
