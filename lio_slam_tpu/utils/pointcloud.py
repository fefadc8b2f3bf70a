"""Masked fixed-shape point tensors + voxel downsampling.

Replacement for PCL's dynamic clouds and `pcl::VoxelGrid` (used throughout
the reference: `mapOptmization.cpp` downSizeFilter*, `imageProjection.cpp`
filtering).  Every cloud is a `(capacity, D)` float32 array plus a `(capacity,)`
bool mask; all ops are static-shape, jit/vmap-safe, and deterministic.

Voxel downsample = hash voxel coords -> sort -> segment-mean, which XLA compiles
to an efficient sort + scatter, instead of PCL's hash-map insertion loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class Cloud(NamedTuple):
    """Fixed-capacity masked point cloud.

    xyz:  (N, 3) float32; undefined where ~mask
    attr: (N, A) float32 extra channels (intensity, time, ring, ...) or None
    mask: (N,) bool
    """

    xyz: jax.Array
    mask: jax.Array
    attr: Optional[jax.Array] = None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))


def make_cloud(xyz, mask=None, attr=None) -> Cloud:
    xyz = jnp.asarray(xyz, jnp.float32)
    if mask is None:
        mask = jnp.ones(xyz.shape[0], dtype=bool)
    return Cloud(xyz=xyz, mask=jnp.asarray(mask, bool),
                 attr=None if attr is None else jnp.asarray(attr, jnp.float32))


def pad_cloud(xyz, capacity: int, attr=None) -> Cloud:
    """Pad a concrete (n, 3) array up to `capacity` with masked slots."""
    xyz = jnp.asarray(xyz, jnp.float32)
    n = min(xyz.shape[0], capacity)
    out = jnp.zeros((capacity, 3), jnp.float32).at[:n].set(xyz[:n])
    mask = jnp.zeros(capacity, bool).at[:n].set(True)
    out_attr = None
    if attr is not None:
        attr = jnp.asarray(attr, jnp.float32)
        out_attr = jnp.zeros((capacity,) + attr.shape[1:], jnp.float32).at[:n].set(attr[:n])
    return Cloud(xyz=out, mask=mask, attr=out_attr)


def compact(cloud: Cloud) -> Cloud:
    """Move valid points to the front (stable). Same capacity."""
    # stable argsort on ~mask: valid (False=0) first
    order = jnp.argsort(~cloud.mask, stable=True)
    return Cloud(
        xyz=cloud.xyz[order],
        mask=cloud.mask[order],
        attr=None if cloud.attr is None else cloud.attr[order],
    )


def filter_points(cloud: Cloud, min_range: float, max_range: float,
                  crop_min=None, crop_max=None, min_intensity: float = -jnp.inf,
                  intensity_col: int = 0) -> Cloud:
    """Range + self-crop-box + intensity gate.

    Mirrors the reference's per-point filter in projectPointCloud
    (imageProjection.cpp:577-615): drop out-of-range points and points inside
    the vehicle crop box.
    """
    r = jnp.linalg.norm(cloud.xyz, axis=-1)
    keep = cloud.mask & (r >= min_range) & (r <= max_range)
    if crop_min is not None:
        cmin = jnp.asarray(crop_min, jnp.float32)
        cmax = jnp.asarray(crop_max, jnp.float32)
        inside = jnp.all((cloud.xyz >= cmin) & (cloud.xyz <= cmax), axis=-1)
        keep = keep & ~inside
    if cloud.attr is not None and min_intensity > -jnp.inf:
        keep = keep & (cloud.attr[..., intensity_col] >= min_intensity)
    return cloud._replace(mask=keep)


def decimate(cloud: Cloud, point_filter_num: int, ring=None,
             downsample_rate: int = 1) -> Cloud:
    """1-in-k point decimation + ring decimation (imageProjection point_filter_num
    / downsampleRate)."""
    idx = jnp.arange(cloud.capacity)
    keep = cloud.mask & (idx % point_filter_num == 0)
    if ring is not None and downsample_rate > 1:
        keep = keep & (jnp.asarray(ring, jnp.int32) % downsample_rate == 0)
    return cloud._replace(mask=keep)


def _voxel_ids(xyz: jax.Array, mask: jax.Array, leaf: jax.Array) -> jax.Array:
    """Spatial-hash voxel id per point; invalid points get INT32_MAX sentinel."""
    coords = jnp.floor(xyz / leaf).astype(jnp.int32)
    # 3x 21-bit-ish mix hash (collisions only merge far-apart voxels; acceptable
    # for downsampling the same way PCL tolerates leaf-size aliasing)
    h = (coords[..., 0] * 73856093) ^ (coords[..., 1] * 19349663) ^ (coords[..., 2] * 83492791)
    h = h & 0x7FFFFFFF
    return jnp.where(mask, h, jnp.int32(0x7FFFFFFF))


def voxel_downsample(cloud: Cloud, leaf_size: float, max_out: int,
                     with_attr: bool = False) -> Cloud:
    """Centroid voxel-grid downsample into a fixed-capacity output.

    pcl::VoxelGrid equivalent: one representative (centroid) per occupied voxel.
    sort-by-voxel-id -> run-detection -> segment mean.  Points whose voxel rank
    exceeds `max_out` are dropped (deterministically: voxels are kept in hash
    order), mirroring the implicit truncation the reference applies via leaf
    size tuning.
    """
    leaf = jnp.float32(leaf_size)
    vid = _voxel_ids(cloud.xyz, cloud.mask, leaf)
    # multi-operand lax.sort carries the payload columns through the sort
    # network directly — cheaper than an argsort plus row gathers of the
    # same columns
    has_attr = with_attr and cloud.attr is not None
    cols = [cloud.xyz[:, 0], cloud.xyz[:, 1], cloud.xyz[:, 2], cloud.mask]
    if has_attr:
        A = cloud.attr.shape[1]
        cols += [cloud.attr[:, j] for j in range(A)]
    sorted_ops = jax.lax.sort((vid, *cols), num_keys=1)
    vid_s, x_s, y_s, z_s, mask_s = sorted_ops[:5]

    first = jnp.concatenate([jnp.array([True]), vid_s[1:] != vid_s[:-1]]) & mask_s
    # output slot per run (0-based); invalid points land in trailing slots
    slot = jnp.cumsum(first.astype(jnp.int32)) - 1
    slot = jnp.where(mask_s, slot, max_out)          # park invalid out of range
    slot_c = jnp.clip(slot, 0, max_out)              # segment_sum needs bounded ids

    num_seg = max_out + 1
    ones = mask_s.astype(jnp.float32)
    counts = jax.ops.segment_sum(ones, slot_c, num_segments=num_seg)
    sx = jax.ops.segment_sum(x_s * ones, slot_c, num_segments=num_seg)
    sy = jax.ops.segment_sum(y_s * ones, slot_c, num_segments=num_seg)
    sz = jax.ops.segment_sum(z_s * ones, slot_c, num_segments=num_seg)
    denom = jnp.maximum(counts[:max_out], 1.0)
    out_xyz = jnp.stack([sx[:max_out], sy[:max_out], sz[:max_out]],
                        axis=-1) / denom[:, None]
    out_mask = counts[:max_out] > 0
    out_attr = None
    if has_attr:
        asum = [jax.ops.segment_sum(a_s * ones, slot_c, num_segments=num_seg)
                for a_s in sorted_ops[5:]]
        out_attr = jnp.stack([a[:max_out] for a in asum], axis=-1) / denom[:, None]
    return Cloud(xyz=out_xyz, mask=out_mask, attr=out_attr)


def packed_voxel_downsample(cloud: Cloud, leaf_size: float,
                            max_out: int) -> Cloud:
    """Exact centroid voxel downsample with a 3-operand packed sort — the
    scan hot path (~1.6x `voxel_downsample`, which carries 5 f32 columns
    through the sort network).

    Voxel coords are recentred to the cloud's min corner and packed EXACTLY
    into 30 bits (10/axis: the working volume may span up to 1024 voxels per
    axis — any lidar scan after range filtering; NOT a kilometre-scale global
    map, which keeps the hash path).  In-voxel offsets quantize to 16
    bits/axis (leaf/65535 ~ 6 um at 0.4 m) and ride in two uint32 payload
    lanes; the sort moves 12 B/point instead of 20 B.  Exact ids also remove
    the (far-apart) voxel merges the 32-bit hash tolerates.
    """
    leaf = jnp.float32(leaf_size)
    coords = jnp.floor(cloud.xyz / leaf).astype(jnp.int32)        # (N, 3)
    big = jnp.int32(1 << 20)
    cmin = jnp.min(jnp.where(cloud.mask[:, None], coords, big), axis=0)
    rel = coords - cmin                                            # >= 0
    in_range = jnp.all(rel < 1024, axis=-1)
    valid = cloud.mask & in_range
    vid = (rel[:, 0] << 20) | (rel[:, 1] << 10) | rel[:, 2]        # 30 bits
    vid = jnp.where(valid, vid, jnp.int32(0x7FFFFFFF))
    off = cloud.xyz - coords.astype(jnp.float32) * leaf
    q = jnp.clip(jnp.round(off / leaf * 65535.0), 0, 65535).astype(jnp.uint32)
    lo = q[:, 0] | (q[:, 1] << 16)
    hi = q[:, 2]
    vid_s, lo_s, hi_s = jax.lax.sort((vid, lo, hi), num_keys=1)
    mask_s = vid_s != jnp.int32(0x7FFFFFFF)

    cs = jnp.stack([(vid_s >> 20) & 1023, (vid_s >> 10) & 1023,
                    vid_s & 1023], axis=-1) + cmin                 # (N, 3)
    qs = jnp.stack([lo_s & 0xFFFF, (lo_s >> 16) & 0xFFFF, hi_s],
                   axis=-1).astype(jnp.float32) * (1.0 / 65535.0)
    xyz_s = (cs.astype(jnp.float32) + qs) * leaf

    first = jnp.concatenate([jnp.array([True]), vid_s[1:] != vid_s[:-1]]) & mask_s
    slot = jnp.cumsum(first.astype(jnp.int32)) - 1
    slot = jnp.where(mask_s, slot, max_out)
    slot_c = jnp.clip(slot, 0, max_out)
    num_seg = max_out + 1
    ones = mask_s.astype(jnp.float32)
    counts = jax.ops.segment_sum(ones, slot_c, num_segments=num_seg)
    sums = jax.ops.segment_sum(xyz_s * ones[:, None], slot_c,
                               num_segments=num_seg)
    denom = jnp.maximum(counts[:max_out], 1.0)
    return Cloud(xyz=sums[:max_out] / denom[:, None],
                 mask=counts[:max_out] > 0)


def hash_downsample(cloud: Cloud, leaf_size: float, max_out: int) -> Cloud:
    """Sort-free voxel downsample: one representative point per occupied
    hash slot (voxel id scattered modulo `max_out`; last write wins).

    ~10x cheaper than the centroid `voxel_downsample` (no argsort) at the
    cost of (a) representative points instead of centroids and (b) distinct
    voxels colliding in a slot merge to one representative (~N_vox/max_out
    loss).  Good enough for the registration scan path (Faster-LIO-style);
    keyframe storage and map products keep the exact centroid version.
    """
    leaf = jnp.float32(leaf_size)
    vid = _voxel_ids(cloud.xyz, cloud.mask, leaf)
    slot = jnp.where(cloud.mask, vid % max_out, max_out)
    xyz = jnp.zeros((max_out + 1, 3), cloud.xyz.dtype).at[slot].set(cloud.xyz)
    mask = jnp.zeros(max_out + 1, bool).at[slot].set(cloud.mask)
    return Cloud(xyz=xyz[:max_out], mask=mask[:max_out])


def merge_clouds(a: Cloud, b: Cloud, capacity: int) -> Cloud:
    """Concatenate two masked clouds into a fixed capacity (valid-first)."""
    xyz = jnp.concatenate([a.xyz, b.xyz], axis=0)
    mask = jnp.concatenate([a.mask, b.mask], axis=0)
    merged = compact(Cloud(xyz=xyz, mask=mask))
    return Cloud(xyz=merged.xyz[:capacity], mask=merged.mask[:capacity])


def random_downsample(cloud: Cloud, max_out: int, key=None) -> Cloud:
    """Deterministic stride-subsample of valid points to `max_out` (fallback
    when voxel grid is overkill, e.g. assembling loop-closure submaps)."""
    c = compact(cloud)
    n = c.count()
    stride = jnp.maximum(n // max_out + (n % max_out > 0), 1)
    idx = jnp.arange(max_out) * stride
    idx = jnp.clip(idx, 0, c.capacity - 1)
    return Cloud(xyz=c.xyz[idx], mask=(jnp.arange(max_out) * stride) < n)
