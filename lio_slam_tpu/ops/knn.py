"""k-nearest-neighbour search over masked point sets.

Replacement for the reference's per-point `pcl::KdTreeFLANN` 5-NN queries
in the registration hot loop (`mapOptmization.cpp:1631` kdtreeSurfFromMap) and
the keypose radius searches.  Kd-trees are pointer-chasing and compile to
nothing useful in XLA; instead we compute squared distances as one matmul
per map chunk
(‖q-r‖² = ‖q‖² + ‖r‖² − 2 q·rᵀ) and maintain a running top-k with
`lax.top_k`, scanning over chunks so peak memory is N×(chunk+k) instead of
N×M.  Exact (not approximate) — matches kd-tree results up to ties.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BIG = jnp.float32(1e30)


class KnnResult(NamedTuple):
    idx: jax.Array    # (N, k) int32 indices into the reference set
    dist2: jax.Array  # (N, k) squared distances (1e30 for invalid)
    valid: jax.Array  # (N, k) bool — neighbour exists and is a real point


@partial(jax.jit, static_argnames=("k", "chunk"))
def knn(query: jax.Array, query_mask: jax.Array,
        ref: jax.Array, ref_mask: jax.Array,
        k: int = 5, chunk: int = 4096) -> KnnResult:
    """Exact k-NN of `query` (N,3) against `ref` (M,3), masked.

    Invalid reference points never appear as neighbours; invalid queries get
    all-invalid results.  M must be a multiple of `chunk` or is padded
    implicitly by masking.
    """
    N = query.shape[0]
    M = ref.shape[0]
    chunk = min(chunk, M)
    n_chunks = (M + chunk - 1) // chunk
    pad = n_chunks * chunk - M
    if pad:
        ref = jnp.concatenate([ref, jnp.zeros((pad, 3), ref.dtype)])
        ref_mask = jnp.concatenate([ref_mask, jnp.zeros(pad, bool)])

    q2 = jnp.sum(query * query, axis=-1, keepdims=True)        # (N, 1)
    ref_c = ref.reshape(n_chunks, chunk, 3)
    ref_m = ref_mask.reshape(n_chunks, chunk)

    init = (jnp.full((N, k), _BIG), jnp.zeros((N, k), jnp.int32))

    def body(carry, inp):
        best_d, best_i = carry
        r, rm, base = inp
        r2 = jnp.sum(r * r, axis=-1)[None, :]                  # (1, C)
        d2 = q2 + r2 - 2.0 * jnp.dot(query, r.T,
                                     preferred_element_type=jnp.float32)
        d2 = jnp.where(rm[None, :], d2, _BIG)
        cand_d = jnp.concatenate([best_d, d2], axis=1)          # (N, k+C)
        cand_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(base + jnp.arange(chunk, dtype=jnp.int32)[None, :], (N, chunk))],
            axis=1)
        neg, sel = jax.lax.top_k(-cand_d, k)
        best_d = -neg
        best_i = jnp.take_along_axis(cand_i, sel, axis=1)
        return (best_d, best_i), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (best_d, best_i), _ = jax.lax.scan(body, init, (ref_c, ref_m, bases))
    valid = (best_d < _BIG) & query_mask[:, None]
    best_d = jnp.maximum(best_d, 0.0)
    return KnnResult(idx=best_i, dist2=jnp.where(valid, best_d, _BIG),
                     valid=valid)


@partial(jax.jit, static_argnames=("max_neighbors",))
def radius_neighbors_mask(query: jax.Array, ref: jax.Array, ref_mask: jax.Array,
                          radius: float, max_neighbors: int = 0) -> jax.Array:
    """Boolean mask (M,) of reference points within `radius` of a single query
    point — the keypose radius search (`mapOptmization.cpp:1527`) on a masked
    pose array (poses are few; a dense distance is trivial)."""
    d2 = jnp.sum((ref - query[None, :]) ** 2, axis=-1)
    return ref_mask & (d2 <= radius * radius)
