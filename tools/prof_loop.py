"""Device timing: loop-closure detector cost at production shapes.

The detector's dominant cost is the submap assembly (`loopFindNearKeyframes`,
mapOptmization.cpp:1360-1383): 2*search_num+1 = 51 keyframes x 8192 points =
417k rows transformed + voxel-downsampled to `icp_submap_points`, then
point-to-plane verification — per candidate, per cycle, inside jit.  The
reference pays the analogous cost in pcl ICP (100 iters over the same
submap); this tool answers VERDICT weak #8: what does one full detector
cycle (RS + SC candidates, both verified) cost on real hardware at K=256,
P=8192?

Prints per-cycle latency for (a) a cycle with no candidate (gate only),
(b) a cycle where RS+SC both fire and are both verified.
"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time

import numpy as np
import jax
import jax.numpy as jnp

from lio_slam_tpu.config import Config, StaticConfig
from lio_slam_tpu.ops import scancontext as sc_mod
from lio_slam_tpu.pipeline import lio, loop_closure

K = 256
P = 8192

cfg = Config(
    static=StaticConfig(max_raw_points=32768, max_scan_points=P,
                        max_map_points=65536, max_keyframes=K,
                        max_keyframe_points=P, max_loop_queue=8,
                        max_gps_queue=8, window_size=32))

rng = np.random.default_rng(0)
state = lio.init_state(cfg)

# Revisit trajectory: drive out 200 m and come back, so the last keyframe
# is within RS radius of an old one with a > 30 s stamp gap.
t = np.linspace(0, 1, K)
xs = 200 * np.sin(np.pi * t)                     # out and back
poses = np.zeros((K, 6), np.float32)
poses[:, 3] = xs
stamps = np.linspace(0, 2 * K / 10, K)           # 0.2 s/kf -> 51.2 s span

# Structured keyframe clouds (planes + walls) so plane fits succeed.
base = rng.uniform(-30, 30, (P, 3)).astype(np.float32)
base[: P // 2, 2] = 0.0                          # ground plane
base[P // 2 :, 1] = 10.0                         # wall
clouds = np.stack([base + rng.normal(0, 0.02, (P, 3)).astype(np.float32)
                   for _ in range(4)])
clouds = clouds[rng.integers(0, 4, K)]

store = state.store._replace(
    poses=jnp.asarray(poses), stamps=jnp.asarray(stamps.astype(np.float32)),
    clouds=jnp.asarray(clouds), cloud_masks=jnp.ones((K, P), bool),
    count=jnp.asarray(K, jnp.int32))

descs = jax.vmap(lambda c: sc_mod.make_descriptor(c, jnp.ones(P, bool)))(
    jnp.asarray(clouds))
sc_db = state.sc_db._replace(
    descriptors=descs,
    ring_keys=descs.mean(axis=-1),
    count=jnp.asarray(K, jnp.int32))

state = state._replace(store=store, sc_db=sc_db)

# gate-only variant: detector already ran on this keyframe (runnable False),
# so the cycle is candidate search + a skipped cond branch
state_nocand = state._replace(last_loop_kf=jnp.asarray(K - 1, jnp.int32))

detect = loop_closure.make_loop_detector(cfg)


def timeit(name, st, n=5):
    jax.block_until_ready(detect(st)[0])         # compile
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(detect(st)[0])
        best = min(best, time.perf_counter() - t0)
    print(f"{name:48s} {best * 1e3:8.2f} ms/cycle", flush=True)
    return best


timeit("detector cycle, no candidate (gate only)", state_nocand)
both = timeit("detector cycle, RS+SC fired, both verified", state)
print(f"loop budget (BASELINE.md): 1000-5000 ms;  margin "
      f"{1000.0 / (both * 1e3):.0f}x", flush=True)
