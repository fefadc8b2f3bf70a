"""2.5D elevation / occupancy rasterization.

Replaces the reference's grid_map_pcl pipeline
(`src/grid_map/grid_map_pcl/src/grid_map_pcl_loader_node.cpp:45-72` +
`GridMapPclLoader`): the downstream consumer subscribes the local planning
cloud and publishes a `/height_map` GridMap.  The whole 26.5 kLoC library's
used capability is "rasterize a cloud into an elevation grid" — here that
is one scatter-max (elevation), scatter-add (counts/occupancy) and an
optional scatter-min, over a fixed-size grid centered on the vehicle.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class HeightMap(NamedTuple):
    elevation: jax.Array   # (H, W) max z per cell (NaN where empty)
    min_z: jax.Array       # (H, W) min z per cell
    count: jax.Array       # (H, W) points per cell
    origin: jax.Array      # (2,) world xy of cell (0, 0) corner
    resolution: jax.Array  # () meters per cell


@partial(jax.jit, static_argnames=("shape",))
def rasterize(xyz: jax.Array, mask: jax.Array, center_xy: jax.Array,
              resolution: float = 0.2, shape: tuple = (512, 512)) -> HeightMap:
    """Scatter a masked cloud into an elevation grid centred on `center_xy`."""
    H, W = shape
    res = jnp.float32(resolution)
    origin = center_xy - jnp.array([H, W], jnp.float32) * res / 2.0
    ij = jnp.floor((xyz[:, :2] - origin[None, :]) / res).astype(jnp.int32)
    inb = mask & (ij[:, 0] >= 0) & (ij[:, 0] < H) & (ij[:, 1] >= 0) & (ij[:, 1] < W)
    flat = jnp.where(inb, ij[:, 0] * W + ij[:, 1], H * W)
    z = xyz[:, 2]
    elev = jnp.full(H * W + 1, -jnp.inf).at[flat].max(jnp.where(inb, z, -jnp.inf))
    mins = jnp.full(H * W + 1, jnp.inf).at[flat].min(jnp.where(inb, z, jnp.inf))
    cnt = jnp.zeros(H * W + 1, jnp.int32).at[flat].add(inb.astype(jnp.int32))
    elev = elev[:-1].reshape(H, W)
    mins = mins[:-1].reshape(H, W)
    cnt = cnt[:-1].reshape(H, W)
    empty = cnt == 0
    return HeightMap(
        elevation=jnp.where(empty, jnp.nan, elev),
        min_z=jnp.where(empty, jnp.nan, mins),
        count=cnt, origin=origin, resolution=res)


@jax.jit
def inpaint_nearest(hm: HeightMap, iterations: int = 4) -> jax.Array:
    """Fill empty cells from neighbour means (grid_map_cv inpainting, coarse
    equivalent) — a few Jacobi passes, jit-friendly."""
    e = jnp.where(jnp.isnan(hm.elevation), 0.0, hm.elevation)
    known = (~jnp.isnan(hm.elevation)).astype(jnp.float32)

    H, W = e.shape
    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    # validity of each rolled-in neighbour (jnp.roll wraps — the opposite map
    # edge must not bleed into border cells)
    inb = {(1, 0): row >= 1, (-1, 0): row < H - 1,
           (1, 1): col >= 1, (-1, 1): col < W - 1}

    def body(_, carry):
        e, known = carry
        ksum = sum(jnp.roll(known, d, ax) * inb[(d, ax)]
                   for d, ax in inb)
        esum = sum(jnp.roll(e * known, d, ax) * inb[(d, ax)]
                   for d, ax in inb)
        fill = jnp.where((known == 0) & (ksum > 0), esum / jnp.maximum(ksum, 1), e)
        new_known = jnp.where((known == 0) & (ksum > 0), 1.0, known)
        return fill, new_known

    e, known = jax.lax.fori_loop(0, iterations, body, (e, known))
    return jnp.where(known > 0, e, jnp.nan)


# ---------------------------------------------------------------------------
# filter layers (grid_map_filters / grid_map_sdf capability equivalents)
# ---------------------------------------------------------------------------


@jax.jit
def normals_and_slope(hm: HeightMap):
    """Surface normals + slope from the elevation layer.

    Capability equivalent of grid_map_filters' NormalVectorsFilter /
    SlopeFilter (`src/grid_map/grid_map_filters/src/NormalVectorsFilter.cpp`):
    central differences on elevation -> unit normal (H, W, 3) and slope angle
    (H, W) rad.  NaN cells propagate NaN."""
    e = hm.elevation
    res = hm.resolution
    filled = jnp.where(jnp.isnan(e), 0.0, e)
    ok = ~jnp.isnan(e)

    def shifted(val, d, axis):
        """roll + mark wrapped-in border cells invalid (jnp.roll alone would
        read the OPPOSITE map edge as a neighbour, inventing huge border
        slopes on vehicle-centered maps)."""
        v = jnp.roll(val, d, axis)
        o = jnp.roll(ok, d, axis)
        idx = jnp.arange(val.shape[axis])
        inb = (idx >= d) if d > 0 else (idx < val.shape[axis] + d)
        inb = jnp.expand_dims(inb, 1 - axis)
        return v, o & inb

    # one-sided at NaN/border neighbours: fall back to the centre value
    vp, op_ = shifted(filled, -1, 0)
    vm, om = shifted(filled, 1, 0)
    dzdx = (jnp.where(op_, vp, filled) - jnp.where(om, vm, filled)) / (2 * res)
    vp, op_ = shifted(filled, -1, 1)
    vm, om = shifted(filled, 1, 1)
    dzdy = (jnp.where(op_, vp, filled) - jnp.where(om, vm, filled)) / (2 * res)
    n = jnp.stack([-dzdx, -dzdy, jnp.ones_like(dzdx)], axis=-1)
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    slope = jnp.arccos(jnp.clip(n[..., 2], -1.0, 1.0))
    nanm = jnp.isnan(e)
    return (jnp.where(nanm[..., None], jnp.nan, n),
            jnp.where(nanm, jnp.nan, slope))


@partial(jax.jit, static_argnames=())
def signed_distance_2d(occupied: jax.Array, resolution) -> jax.Array:
    """2D signed distance to the occupied-cell set, meters (positive outside,
    negative inside).

    Capability equivalent of grid_map_sdf's per-layer 2D distance field
    (`src/grid_map/grid_map_sdf/src/SignedDistanceField.cpp` builds per-slice
    2D EDTs).  Jump-flooding over roll-shifted seed maps: O(log n) passes of
    a 9-neighbour min — exact for convex regions, <=1-cell error elsewhere
    (JFA's standard bound), and entirely gather-free."""
    H, W = occupied.shape
    ii, jj = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")

    def edt(seed_mask):
        # nearest-seed coordinates per cell, INF where unknown yet
        big = jnp.float32(1e9)
        si = jnp.where(seed_mask, ii, big)
        sj = jnp.where(seed_mask, jj, big)

        def pass_at(step, carry):
            si, sj = carry
            best_d = jnp.where(si < big, (si - ii) ** 2 + (sj - jj) ** 2, jnp.inf)
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    if di == 0 and dj == 0:
                        continue
                    ci = jnp.roll(si, (di * step, dj * step), (0, 1))
                    cj = jnp.roll(sj, (di * step, dj * step), (0, 1))
                    d = jnp.where(ci < big, (ci - ii) ** 2 + (cj - jj) ** 2,
                                  jnp.inf)
                    take = d < best_d
                    si = jnp.where(take, ci, si)
                    sj = jnp.where(take, cj, sj)
                    best_d = jnp.where(take, d, best_d)
            return si, sj

        n_pass = max(H, W).bit_length()
        for p in range(n_pass):
            step = 1 << (n_pass - 1 - p)
            si, sj = pass_at(step, (si, sj))
        si, sj = pass_at(1, (si, sj))    # standard JFA+1 cleanup pass
        d2 = jnp.where(si < big, (si - ii) ** 2 + (sj - jj) ** 2, jnp.inf)
        return jnp.sqrt(d2)

    occupied = occupied.astype(bool)
    d_out = edt(occupied)                 # distance to nearest occupied
    d_in = edt(~occupied)                 # distance to nearest free
    res = jnp.asarray(resolution, jnp.float32)
    return jnp.where(occupied, -d_in, d_out) * res


@jax.jit
def obstacle_sdf(hm: HeightMap, reference_z, clearance: float = 0.3) -> jax.Array:
    """Planning-facing product: signed distance (m) to cells whose elevation
    rises more than `clearance` above `reference_z` (vehicle footprint z).
    Empty cells count as free space."""
    occ = (~jnp.isnan(hm.elevation)) & (hm.elevation > reference_z + clearance)
    return signed_distance_2d(occ, hm.resolution)
