"""Device-mesh construction and sharding helpers.

The reference's concurrency model (SURVEY.md §2.4) is 4 ROS processes + OpenMP
per-point loops on one machine.  The equivalents here:

- OpenMP per-point parallel-for  ->  scan points sharded over the mesh 'data'
  axis; per-shard correspondence search + normal-equation blocks reduced with
  `psum` (parallel/registration.py).
- process pipeline               ->  one SPMD program per scan (pipeline/lio.py).
- map/keyframe state at scale    ->  map points shardable over the same axis.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_points(mesh: Mesh, arr: jax.Array, axis: str = "data") -> jax.Array:
    """Place a (N, ...) point tensor sharded along its first dim."""
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))
