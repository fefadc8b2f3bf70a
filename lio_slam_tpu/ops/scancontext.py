"""Scan Context place recognition as batched JAX programs.

Rebuild of the vendored Scan Context implementation
(`src/liorf/include/Scancontext.{h,cpp}`, Kim & Kim IROS 2018):

- descriptor (`makeScancontext`, Scancontext.cpp:151-195): 20-ring x 60-sector
  polar image of max z (+LIDAR_HEIGHT offset, 80 m radius) — here one
  scatter-max instead of a point loop.
- ring key / sector key (:198-227): row / column means.
- retrieval (`detectLoopClosureID`, :253-342): the reference keeps a nanoflann
  kd-tree over ring keys rebuilt every 10 inserts and searches 3 candidates,
  excluding the 30 most recent; we compute all ring-key distances in one
  matmul-sized op (the database is tiny: <= max_keyframes x 20) — no index
  maintenance, always exact.
- alignment (`distanceBtnScanContext`, :116-148): the reference prunes the
  column-shift search to +-10% around the sector-key argmin; we evaluate all
  60 shifts as one batched einsum (no data-dependent pruning) and
  return the best shift as a yaw initial guess.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

NUM_RING = 20
NUM_SECTOR = 60


class ScanContextDB(NamedTuple):
    """Fixed-capacity descriptor database (one row per keyframe)."""

    descriptors: jax.Array   # (K, R, S)
    ring_keys: jax.Array     # (K, R)
    count: jax.Array         # () int32


def empty_db(max_keyframes: int, num_ring: int = NUM_RING,
             num_sector: int = NUM_SECTOR) -> ScanContextDB:
    return ScanContextDB(
        descriptors=jnp.zeros((max_keyframes, num_ring, num_sector), jnp.float32),
        ring_keys=jnp.zeros((max_keyframes, num_ring), jnp.float32),
        count=jnp.zeros((), jnp.int32))


@partial(jax.jit, static_argnames=("num_ring", "num_sector"))
def make_descriptor(xyz: jax.Array, mask: jax.Array,
                    max_radius: float = 80.0, lidar_height: float = 2.0,
                    num_ring: int = NUM_RING,
                    num_sector: int = NUM_SECTOR) -> jax.Array:
    """Polar max-z image of a body-frame scan (makeScancontext)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(y, x)                      # [-pi, pi]
    theta = jnp.where(theta < 0, theta + 2 * jnp.pi, theta)
    ring = jnp.clip((r / max_radius * num_ring).astype(jnp.int32), 0, num_ring - 1)
    sector = jnp.clip((theta / (2 * jnp.pi) * num_sector).astype(jnp.int32),
                      0, num_sector - 1)
    ok = mask & (r < max_radius)
    zval = jnp.where(ok, z + lidar_height, -jnp.inf)
    idx = jnp.where(ok, ring * num_sector + sector, -1)
    # dense one-hot max over bins instead of a scatter-max: the (bins x N)
    # masked reduction fuses into one streaming pass with no write
    # conflicts
    bins = jnp.arange(num_ring * num_sector, dtype=jnp.int32)[:, None]
    img = jnp.max(jnp.where(idx[None, :] == bins, zval[None, :], -jnp.inf),
                  axis=1)
    img = img.reshape(num_ring, num_sector)
    return jnp.where(jnp.isfinite(img), img, 0.0)   # empty bins -> 0 (ref NO_POINT=0 after init)


def ring_key(desc: jax.Array) -> jax.Array:
    """Row means (makeRingkeyFromScancontext)."""
    return jnp.mean(desc, axis=-1)


def add_descriptor(db: ScanContextDB, desc: jax.Array) -> ScanContextDB:
    i = jnp.minimum(db.count, db.descriptors.shape[0] - 1)
    return ScanContextDB(
        descriptors=db.descriptors.at[i].set(desc),
        ring_keys=db.ring_keys.at[i].set(ring_key(desc)),
        count=jnp.minimum(db.count + 1, db.descriptors.shape[0]))


def _sc_distance_all_shifts(query: jax.Array, cands: jax.Array) -> jax.Array:
    """Column-shifted cosine distance between `query` (R,S) and candidate
    descriptors (C,R,S) for all S shifts -> (C, S) distances.

    distDirectSC (:93-113): mean over columns of (1 - cos(col_q, col_c)),
    skipping empty columns.
    """
    S = query.shape[-1]
    # all circular shifts of the query: (S, R, S)
    shifts = jnp.stack([jnp.roll(query, -s, axis=-1) for s in range(S)])
    qn = jnp.linalg.norm(shifts, axis=-2)                     # (S, S) col norms
    cn = jnp.linalg.norm(cands, axis=-2)                      # (C, S)
    dots = jnp.einsum("srk,crk->csk", shifts, cands)          # (C, S, S)
    denom = qn[None, :, :] * cn[:, None, :]
    cos = jnp.where(denom > 1e-9, dots / jnp.maximum(denom, 1e-9), 0.0)
    col_valid = (qn[None, :, :] > 1e-9) & (cn[:, None, :] > 1e-9)
    n_valid = jnp.maximum(jnp.sum(col_valid, axis=-1), 1)
    dist = jnp.sum(jnp.where(col_valid, 1.0 - cos, 0.0), axis=-1) / n_valid
    return dist                                                # (C, S)


class SCMatch(NamedTuple):
    index: jax.Array       # () int32 matched keyframe (-1 if none)
    distance: jax.Array    # () best descriptor distance
    yaw: jax.Array         # () rad — yaw of match (shift * 2pi/S)


@partial(jax.jit, static_argnames=("num_candidates", "exclude_recent"))
def detect(db: ScanContextDB, query_desc: jax.Array,
           dist_threshold: float = 0.3, num_candidates: int = 3,
           exclude_recent: int = 30) -> SCMatch:
    """detectLoopClosureID: ring-key KNN -> shifted cosine distance -> gate."""
    K = db.descriptors.shape[0]
    qkey = ring_key(query_desc)
    d_ring = jnp.linalg.norm(db.ring_keys - qkey[None, :], axis=-1)
    eligible = (jnp.arange(K) < (db.count - exclude_recent))
    d_ring = jnp.where(eligible, d_ring, jnp.inf)
    _, cand_idx = jax.lax.top_k(-d_ring, num_candidates)       # (C,)
    cand_ok = jnp.isfinite(d_ring[cand_idx])
    cands = db.descriptors[cand_idx]                           # (C, R, S)
    dist = _sc_distance_all_shifts(query_desc, cands)          # (C, S)
    best_shift = jnp.argmin(dist, axis=-1)                     # (C,)
    best_dist = jnp.min(dist, axis=-1)
    best_dist = jnp.where(cand_ok, best_dist, jnp.inf)
    b = jnp.argmin(best_dist)
    accept = best_dist[b] < dist_threshold
    S = query_desc.shape[-1]
    # sign: a query pose yawed +theta relative to the match sees world
    # content at body azimuth -theta, i.e. columns shifted DOWN; the matching
    # circshift s therefore corresponds to yaw = -s * 2pi/S
    yaw = -best_shift[b].astype(jnp.float32) * (2.0 * jnp.pi / S)
    yaw = jnp.where(yaw < -jnp.pi, yaw + 2 * jnp.pi, yaw)
    return SCMatch(index=jnp.where(accept, cand_idx[b], -1),
                   distance=best_dist[b],
                   yaw=jnp.where(accept, yaw, 0.0))
