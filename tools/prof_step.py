"""Device timing: full per-scan step composition at bench shapes.

Where does the per-scan time go?  Times each lio_step sub-stage in isolation
(fori_loop REPS inside one jit, data-dependency threaded)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from lio_slam_tpu.config import Config, RegistrationConfig, StaticConfig
from lio_slam_tpu.graph import factors as F, solver
from lio_slam_tpu.io import synthetic
from lio_slam_tpu.ops import registration as reg, scancontext as sc_mod, \
    voxel_grid as vg
from lio_slam_tpu.pipeline import lio, keyframes as kf
from lio_slam_tpu.utils import pointcloud as pc

REPS = 30
NRAW = 32768
NSCAN = 8192
M = 65536

cfg = Config(
    static=StaticConfig(max_raw_points=NRAW, max_scan_points=NSCAN,
                        max_map_points=M, max_keyframes=256,
                        max_keyframe_points=NSCAN, max_loop_queue=8,
                        max_gps_queue=8, window_size=32),
    registration=RegistrationConfig())

rng = np.random.default_rng(0)
raw = pc.Cloud(xyz=jnp.asarray(rng.uniform(-40, 40, (NRAW, 3))
                               .astype(np.float32)),
               mask=jnp.ones(NRAW, bool))
scan = jnp.asarray(rng.uniform(-30, 30, (NSCAN, 3)).astype(np.float32))
scan_mask = jnp.ones(NSCAN, bool)
map_pts = jnp.asarray(rng.uniform(-40, 40, (M, 3)).astype(np.float32))
grid = vg.build_grid(map_pts, jnp.ones(M, bool), cfg.registration.nn_radius,
                     cfg.registration.grid_table_size,
                     cfg.registration.grid_max_per_cell,
                     halo=cfg.registration.grid_halo)
pose = jnp.zeros(6, jnp.float32)
jax.block_until_ready(grid)


def timeit(name, fn, n=3, reps=REPS):
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    print(f"{name:44s} {best/reps*1e3:8.3f} ms/iter   ({best*1e3:7.1f} ms /{reps})",
          flush=True)


def loop(body):
    @jax.jit
    def run():
        return lax.fori_loop(0, REPS, lambda i, c: body(c), jnp.float32(0))
    return run


def ds_body(c):
    cl = pc.Cloud(xyz=raw.xyz + c * 1e-9, mask=raw.mask)
    out = pc.voxel_downsample(cl, 0.4, NSCAN)
    return c + out.xyz.sum()


def hashds_body(c):
    cl = pc.Cloud(xyz=raw.xyz + c * 1e-9, mask=raw.mask)
    out = pc.hash_downsample(cl, 0.4, NSCAN)
    return c + out.xyz.sum()


def reg_body(c):
    res = reg.register_with_grid(scan + c * 1e-9, scan_mask, grid, pose,
                                 cfg.registration)
    return c + res.pose.sum()


def insert_body(c):
    g2 = vg.insert_points(grid, scan + c * 1e-9, scan_mask,
                          halo=cfg.registration.grid_halo)
    return c + jnp.float32(g2.counts.sum())


def sc_body(c):
    d = sc_mod.make_descriptor(scan + c * 1e-9, scan_mask, max_radius=80.0,
                               lidar_height=2.0, num_ring=20, num_sector=60)
    return c + d.sum()


state0 = lio.init_state(cfg)
g0 = state0.graph
g0 = g0._replace(pose_mask=g0.pose_mask.at[:64].set(True))


def window_body(c):
    g = g0._replace(poses=g0.poses.at[0, 3].add(c * 1e-9))
    g = solver.solve_window_compact(g, jnp.int32(64), cfg.static.window_size,
                                    iterations=2)
    return c + g.poses.sum()


step = lio.make_lio_step(cfg)
seq = synthetic.make_sequence(n_scans=2, n_points=NRAW, seed=0, speed=2.0)
inp = lio.ScanInput(
    cloud=pc.Cloud(xyz=jnp.asarray(seq.scans[0]),
                   mask=jnp.asarray(seq.scan_masks[0])),
    stamp=jnp.zeros(()), init_guess=jnp.zeros(6),
    guess_valid=jnp.zeros((), bool), imu_rpy=jnp.zeros(3),
    imu_available=jnp.zeros((), bool), gps_pos=jnp.zeros(3),
    gps_info=jnp.zeros(3), gps_valid=jnp.zeros((), bool))


def fullstep_body(carry):
    st, c = carry
    st, out = step(st, inp._replace(
        cloud=pc.Cloud(xyz=inp.cloud.xyz + c * 1e-9, mask=inp.cloud.mask)))
    return st, c + out.pose.sum()


@jax.jit
def fullstep_run():
    st = lio.init_state(cfg)
    st, c = lax.fori_loop(0, REPS, lambda i, sc_: fullstep_body(sc_),
                          (st, jnp.float32(0)))
    return c


timeit("voxel_downsample 32k->8k", loop(ds_body))
timeit("hash_downsample 32k->8k", loop(hashds_body))
timeit("register_with_grid (uniform)", loop(reg_body))
timeit("insert_points z 8k", loop(insert_body))
timeit("scancontext descriptor", loop(sc_body))
timeit("solve_window_compact x2 (W=32)", loop(window_body))
timeit("FULL lio_step (incl. keyframe branch)", fullstep_run)


def packed_body(c):
    cl = pc.Cloud(xyz=raw.xyz + c * 1e-9, mask=raw.mask)
    out = pc.packed_voxel_downsample(cl, 0.4, NSCAN)
    return c + out.xyz.sum()


timeit("packed_voxel_downsample 32k->8k", loop(packed_body))
timeit("insert_points z 8k (multi-op sort)", loop(insert_body))

