"""Per-stage device timing with bench shapes.

Each stage is iterated REPS times inside one jit via lax.fori_loop with
data dependency threading to prevent DCE/CSE, so dispatch overhead does
not enter the per-stage time.
"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from lio_slam_tpu.config import RegistrationConfig
from lio_slam_tpu.ops import voxel_grid as vg, registration as reg

N = 8192       # scan points
M = 65536      # map points
REPS = 30
cfg = RegistrationConfig()

rng = np.random.default_rng(0)
map_pts = jnp.asarray(rng.uniform(-40, 40, (M, 3)).astype(np.float32))
map_mask = jnp.ones(M, bool)
scan = jnp.asarray(rng.uniform(-30, 30, (N, 3)).astype(np.float32))
scan_mask = jnp.ones(N, bool)
pose = jnp.zeros(6, jnp.float32)

grid = vg.build_grid(map_pts, map_mask, cfg.nn_radius, cfg.grid_table_size,
                     cfg.grid_max_per_cell, halo=cfg.grid_halo)
grid_full = vg.build_grid(map_pts, map_mask, cfg.nn_radius,
                          cfg.grid_table_size, 128, halo="full")
jax.block_until_ready((grid, grid_full))


def timeit(name, fn, n=3, reps=REPS):
    jax.block_until_ready(fn())            # compile + warm
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    print(f"{name:44s} {best/reps*1e3:8.3f} ms/iter   ({best*1e3:7.1f} ms /{reps})")


def loop(body):  # body: carry -> carry
    @jax.jit
    def run():
        return lax.fori_loop(0, REPS, lambda i, c: body(c), jnp.float32(0))
    return run


def knn_body(g, halo):
    def body(carry):
        q = scan + carry * 1e-9
        _, d2, _ = vg.query_knn(g, q, scan_mask, k=5, halo=halo)
        return carry + jnp.float32(d2.sum())
    return body


def corr_body(g):
    def body(carry):
        p = pose.at[3].add(carry * 1e-9)
        c = reg.find_correspondences(scan, scan_mask, None, None, p, cfg,
                                     grid=g)
        return carry + jnp.float32(c.weight.sum())
    return body


c0 = reg.find_correspondences(scan, scan_mask, None, None, pose, cfg,
                              grid=grid)
c0 = jax.tree.map(jax.block_until_ready, c0)


def ne_body(carry):
    p = pose.at[3].add(carry * 1e-9)
    H, b = reg._normal_equations(scan, c0, p)
    return carry + jnp.float32(H.sum() + b.sum())


def build_body(halo, C):
    def body(carry):
        g = vg.build_grid(map_pts + carry * 1e-9, map_mask, cfg.nn_radius,
                          cfg.grid_table_size, C, halo=halo)
        return carry + jnp.float32(g.counts.sum())
    return body


def insert_body(g, halo):
    def body(carry):
        g2 = vg.insert_points(g, scan + carry * 1e-9, scan_mask, halo=halo)
        return carry + jnp.float32(g2.counts.sum())
    return body


timeit("query_knn z-halo (C=24, O=9)", loop(knn_body(grid, "z")))
timeit("query_knn full-halo (C=128, O=1)", loop(knn_body(grid_full, "full")))
timeit("find_correspondences (z)", loop(corr_body(grid)))
timeit("normal_equations only", loop(ne_body))
timeit("build_grid z (65k)", loop(build_body("z", 24)), reps=REPS)
timeit("build_grid full C=128 (65k)", loop(build_body("full", 128)), reps=REPS)
timeit("insert_points z (8k)", loop(insert_body(grid, "z")))
timeit("insert_points full (8k)", loop(insert_body(grid_full, "full")))
