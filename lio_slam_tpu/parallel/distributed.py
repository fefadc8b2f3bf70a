"""Multi-process (multi-host) runtime plumbing.

The reference's "cluster" is one machine wired by TCPROS (SURVEY.md §2.4);
the scale-out unit here is one host process per slice of devices, coordinated
by `jax.distributed` and programmed with the SAME global-mesh code as the
single-host path (`parallel/multislice.py`): after `initialize()`,
`jax.devices()` spans every host and a Mesh over it makes XLA place the
inter-host collectives at process boundaries automatically.

Nothing here is device-specific — tests/test_distributed.py drives this layer
with two CPU processes x 4 virtual devices each, which exercises the real
cross-process collective path (the closest thing to multi-host validation
a single machine can provide).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """`jax.distributed.initialize` with env-var fallback.

    Env contract (matches common cluster launchers):
      LIO_COORDINATOR (host:port), LIO_NUM_PROCESSES, LIO_PROCESS_ID.
    Where a cluster launcher provides the metadata JAX understands, all
    three may be None and JAX autodetects.
    """
    coordinator_address = coordinator_address or os.environ.get("LIO_COORDINATOR")
    if num_processes is None and "LIO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LIO_NUM_PROCESSES"])
    if process_id is None and "LIO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LIO_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(n_slices: int | None = None,
                devices_per_slice: int | None = None) -> Mesh:
    """('slice', 'data') mesh over ALL processes' devices.

    Default: one slice per process (the host boundary is the slice
    boundary), 'data' over each process's local devices — the layout
    `multislice.psum_staged` assumes (within-host reduction first, one
    small partial per slice across hosts).
    """
    devs = jax.devices()
    if n_slices is None:
        n_slices = jax.process_count()
    if devices_per_slice is None:
        devices_per_slice = len(devs) // n_slices
    arr = np.asarray(devs[:n_slices * devices_per_slice]).reshape(
        n_slices, devices_per_slice)
    return Mesh(arr, ("slice", "data"))


def replicated(mesh: Mesh, x) -> jax.Array:
    """Place a host value identically on every device (every process must
    pass the same value — the standard replicated-input contract)."""
    x = np.asarray(x)
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), x, global_shape=x.shape)


def factor_sharded(mesh: Mesh, x) -> jax.Array:
    """Shard axis 0 over the whole pod ('slice' x 'data' flattened) from a
    full copy on every process — the factor-array layout of
    `multislice.shard_factors`, but multi-process-safe (each process hands
    over only the block its devices own)."""
    x = np.asarray(x)
    spec = P(("slice", "data"), *([None] * (x.ndim - 1)))
    n = x.shape[0]
    pc_ = jax.process_count()
    pid = jax.process_index()
    chunk = n // pc_
    local = x[pid * chunk:(pid + 1) * chunk] if pc_ > 1 else x
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local, global_shape=x.shape)
