"""Device timing: full-graph solver scaling — dense (K·6)² vs sparse
block-tridiagonal+Woodbury (graph/sparse.py) at production capacities.

The reference's iSAM2 stays O(active) as the graph grows
(mapOptmization.cpp:2082-2134); the dense assembly allocates a (K·6)² H per
linearization (~600 MB at K=2048).  This measures the crossover and
whether the sparse path holds the 100 ms full-correction budget at K=2048.

Run on the GPU:  python tools/prof_sparse.py
"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time

import numpy as np
import jax
import jax.numpy as jnp

from lio_slam_tpu.graph import factors as F
from lio_slam_tpu.graph import solver, sparse
from lio_slam_tpu.utils import se3


def chain_graph(n, K, L=16, n_loops=2, seed=0):
    """Yawing odometry chain (planar arc) with a couple of long loops.
    All construction is vectorized host math — per-pose device dispatches
    would dominate the benchmark setup."""
    rs = np.random.RandomState(seed)
    B = K - 1 + L
    # constant increment [0,0,dyaw, dx,0,0]: yaw_i = i*dyaw and positions are
    # the cumsum of R(yaw_i) @ [dx,0,0] — so every chain measurement is
    # exactly the increment, no per-pose compose needed
    dyaw, dx = 0.01, 1.0
    yaw = dyaw * np.arange(n, dtype=np.float64)
    step = np.stack([dx * np.cos(yaw), dx * np.sin(yaw)], 1)
    pos = np.concatenate([np.zeros((1, 2)), np.cumsum(step, 0)[:-1]], 0)
    true = np.zeros((n, 6), np.float32)
    true[:, 2] = yaw
    true[:, 3:5] = pos
    noisy = true + rs.randn(n, 6).astype(np.float32) * 0.02
    g = F.empty_graph(K, B, 8)
    g = g._replace(
        poses=g.poses.at[:n].set(jnp.asarray(noisy)),
        pose_mask=g.pose_mask.at[:n].set(True),
        prior_pose=jnp.asarray(true[0]),
        prior_info=F.info_from_variances([1e-4] * 6))
    info = F.info_from_variances([1e-6] * 3 + [1e-4] * 3)
    idx = np.arange(n - 1)
    inc = np.tile(np.array([[0, 0, dyaw, dx, 0, 0]], np.float32), (n - 1, 1))
    g = g._replace(
        bt_i=g.bt_i.at[idx].set(idx), bt_j=g.bt_j.at[idx].set(idx + 1),
        bt_meas=g.bt_meas.at[idx].set(jnp.asarray(inc)),
        bt_info=g.bt_info.at[idx].set(jnp.tile(info[None], (n - 1, 1))),
        bt_mask=g.bt_mask.at[idx].set(True))
    for q in range(n_loops):
        i, j = 2 + q, n - 3 - q
        slot = K - 1 + q
        lm = np.asarray(se3.pose6_between(jnp.asarray(true[i]),
                                          jnp.asarray(true[j])))
        g = g._replace(
            bt_i=g.bt_i.at[slot].set(i), bt_j=g.bt_j.at[slot].set(j),
            bt_meas=g.bt_meas.at[slot].set(jnp.asarray(lm)),
            bt_info=g.bt_info.at[slot].set(jnp.full(6, 1e2)),
            bt_mask=g.bt_mask.at[slot].set(True))
    return jax.device_put(g), n


def timeit(name, fn, reps=5):
    jax.block_until_ready(fn())          # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    print(f"{name:52s} {best * 1e3:9.2f} ms", flush=True)
    return best


def main():
    print(f"backend: {jax.devices()[0].platform}", flush=True)
    for K in (256, 1024, 2048):
        n = K - K // 8
        g, _ = chain_graph(n, K)
        print(f"--- K={K} (active {n}), 5 GN iterations ---")
        timeit(f"sparse solve_sparse        K={K}",
               lambda g=g: sparse.solve_sparse(g, iterations=5).graph.poses)
        timeit(f"sparse marginal_covariance K={K}",
               lambda g=g: sparse.marginal_covariance_sparse(
                   g, jnp.int32(n - 1)))
        # dense at K=2048 assembles a 12288^2 H (~600 MB x fori_loop
        # double-buffering) — measure only where it fits comfortably
        if K <= 1024:
            timeit(f"dense  solve               K={K}",
                   lambda g=g: solver.solve(g, g.pose_mask,
                                            iterations=5).graph.poses)
            timeit(f"dense  marginal_covariance K={K}",
                   lambda g=g: solver.marginal_covariance(g, jnp.int32(n - 1)))


if __name__ == "__main__":
    main()
