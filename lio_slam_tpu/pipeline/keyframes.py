"""Keyframe tensor store + local-map assembly.

Replacement for the reference's keyframe machinery
(`src/liorf/src/mapOptmization.cpp`):

- `cloudKeyPoses3D/6D` + `surfCloudKeyFrames` (:74-86) -> fixed-capacity
  ring-buffer tensors (poses, stamps, per-keyframe downsampled clouds).
- `extractNearby`/`extractCloud` (:1519-1588): kd-tree radius search over
  keyframe positions + last-10 s keyframes, assemble the local map from
  transformed keyframe clouds.  The reference caches transformed clouds in
  `laserCloudMapContainer` (evicted >1000 entries, cleared on loop); here a
  batched gather+transform of ~50 keyframe clouds is a couple of matmuls, so
  we recompute every scan and the cache (and its invalidation bugs) disappears.
- keyframe gating (:1909-1928).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lio_slam_tpu.utils import pointcloud as pc
from lio_slam_tpu.utils import se3


class KeyframeStore(NamedTuple):
    poses: jax.Array       # (K, 6) optimized keyframe poses
    stamps: jax.Array      # (K,) scan timestamps (seconds)
    clouds: jax.Array      # (K, P, 3) downsampled clouds in body frame
    cloud_masks: jax.Array # (K, P) bool
    count: jax.Array       # () int32 number of active keyframes
    # LOAM corner features per keyframe (cornerCloudKeyFrames in upstream
    # LIO-SAM; the liorf fork dropped them — SURVEY.md §2.1 #4).  Capacity 1
    # when cfg.registration.use_corner_features is off (negligible memory,
    # one code path).
    corner_clouds: jax.Array  # (K, Pc, 3)
    corner_masks: jax.Array   # (K, Pc) bool


def empty_store(max_keyframes: int, points_per_kf: int,
                corner_points_per_kf: int = 1) -> KeyframeStore:
    K, P = max_keyframes, points_per_kf
    Pc = max(corner_points_per_kf, 1)
    return KeyframeStore(
        poses=jnp.zeros((K, 6), jnp.float32),
        stamps=jnp.zeros(K, jnp.float32),
        clouds=jnp.zeros((K, P, 3), jnp.float32),
        cloud_masks=jnp.zeros((K, P), bool),
        count=jnp.zeros((), jnp.int32),
        corner_clouds=jnp.zeros((K, Pc, 3), jnp.float32),
        corner_masks=jnp.zeros((K, Pc), bool),
    )


def should_add_keyframe(store: KeyframeStore, pose: jax.Array,
                        angle_threshold: float, dist_threshold: float) -> jax.Array:
    """saveFrame gate (:1909-1928): first scan always; else motion since the
    last keyframe > thresholds."""
    last = store.poses[jnp.maximum(store.count - 1, 0)]
    delta = se3.pose6_between(last, pose)
    big_angle = jnp.any(jnp.abs(delta[:3]) >= angle_threshold)
    big_dist = jnp.linalg.norm(delta[3:]) >= dist_threshold
    return (store.count == 0) | big_angle | big_dist


def add_keyframe(store: KeyframeStore, pose: jax.Array, stamp: jax.Array,
                 cloud: pc.Cloud, corner: pc.Cloud = None) -> KeyframeStore:
    """Append at slot `count`.  The mission path never calls this at
    capacity — `lio._evict_oldest` frees slot K-1 first (ring eviction with
    graph rebase); the clamp below is only a safety net for direct callers."""
    i = jnp.minimum(store.count, store.poses.shape[0] - 1)
    P = store.clouds.shape[1]
    store = store._replace(
        poses=store.poses.at[i].set(pose),
        stamps=store.stamps.at[i].set(stamp),
        clouds=store.clouds.at[i].set(cloud.xyz[:P]),
        cloud_masks=store.cloud_masks.at[i].set(cloud.mask[:P]),
        count=jnp.minimum(store.count + 1, store.poses.shape[0]),
    )
    if corner is not None:
        Pc = store.corner_clouds.shape[1]
        store = store._replace(
            corner_clouds=store.corner_clouds.at[i].set(corner.xyz[:Pc]),
            corner_masks=store.corner_masks.at[i].set(corner.mask[:Pc]))
    return store


def _select_nearby(store: KeyframeStore, position: jax.Array,
                   now: jax.Array, radius: float, recent_sec: float,
                   max_selected: int):
    """extractNearby keyframe selection: within `radius` of `position` or in
    the last `recent_sec` seconds; the `max_selected` nearest win."""
    K = store.poses.shape[0]
    kf_mask = jnp.arange(K) < store.count
    d2 = jnp.sum((store.poses[:, 3:] - position[None, :]) ** 2, axis=-1)
    recent = store.stamps >= (now - recent_sec)
    selected = kf_mask & ((d2 <= radius * radius) | recent)
    order_key = jnp.where(selected, d2, jnp.inf)
    sel_idx = jnp.argsort(order_key)[:max_selected]            # (S,)
    sel_valid = jnp.isfinite(order_key[sel_idx])               # (S,)
    return sel_idx, sel_valid


def _merge_selected(store: KeyframeStore, clouds: jax.Array, masks: jax.Array,
                    sel_idx: jax.Array, sel_valid: jax.Array,
                    leaf_size: float, map_capacity: int) -> pc.Cloud:
    """Transform the selected keyframes' clouds to map frame, merge +
    voxel-downsample into a fixed-capacity cloud (extractCloud)."""
    poses = store.poses[sel_idx]                               # (S, 6)
    sel_clouds = clouds[sel_idx]                               # (S, P, 3)
    sel_masks = masks[sel_idx] & sel_valid[:, None]            # (S, P)
    R, t = se3.pose6_to_Rt(poses)                              # (S,3,3),(S,3)
    world = jnp.einsum("sij,spj->spi", R, sel_clouds) + t[:, None, :]
    merged = pc.Cloud(xyz=world.reshape(-1, 3), mask=sel_masks.reshape(-1))
    return pc.voxel_downsample(merged, leaf_size, map_capacity)


@partial(jax.jit, static_argnames=("max_selected", "map_capacity"))
def assemble_local_map(store: KeyframeStore, position: jax.Array,
                       now: jax.Array, radius: float, recent_sec: float,
                       leaf_size: float, max_selected: int,
                       map_capacity: int) -> pc.Cloud:
    """extractNearby + extractCloud: select keyframes within `radius` of
    `position` plus those of the last `recent_sec` seconds; take the
    `max_selected` nearest; transform their clouds to map frame; merge +
    voxel-downsample into a fixed-capacity map cloud."""
    sel_idx, sel_valid = _select_nearby(store, position, now, radius,
                                        recent_sec, max_selected)
    return _merge_selected(store, store.clouds, store.cloud_masks,
                           sel_idx, sel_valid, leaf_size, map_capacity)


@partial(jax.jit, static_argnames=("max_selected", "map_capacity"))
def assemble_corner_map(store: KeyframeStore, position: jax.Array,
                        now: jax.Array, radius: float, recent_sec: float,
                        leaf_size: float, max_selected: int,
                        map_capacity: int) -> pc.Cloud:
    """Corner-feature local map (upstream LIO-SAM's laserCloudCornerFromMap):
    same keyframe selection as the surf map, gathered from the per-keyframe
    corner clouds.  Corner sets are small (<=2k/keyframe) so a per-scan
    rebuild is a couple of matmuls."""
    sel_idx, sel_valid = _select_nearby(store, position, now, radius,
                                        recent_sec, max_selected)
    return _merge_selected(store, store.corner_clouds, store.corner_masks,
                           sel_idx, sel_valid, leaf_size, map_capacity)


def transform_keyframe_clouds(store: KeyframeStore) -> jax.Array:
    """All keyframe clouds in world frame (K, P, 3) — used by the global-map
    exporter (saveMapService :938-941) and the planning map."""
    R, t = se3.pose6_to_Rt(store.poses)
    return jnp.einsum("kij,kpj->kpi", R, store.clouds) + t[:, None, :]
