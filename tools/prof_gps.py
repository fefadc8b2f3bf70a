"""Timing of the GPS gate's marginal covariance (K=256 dense solver)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time
import jax
import jax.numpy as jnp
from jax import lax

from lio_slam_tpu.config import Config, RegistrationConfig, StaticConfig
from lio_slam_tpu.graph import solver
from lio_slam_tpu.pipeline import lio
from tests.graph_fixtures import make_chain_fixture

REPS = 10

cfg = Config(
    static=StaticConfig(max_raw_points=1024, max_scan_points=8192,
                        max_map_points=65536, max_keyframes=256,
                        max_keyframe_points=512, max_loop_queue=8,
                        max_gps_queue=8, window_size=32),
    registration=RegistrationConfig())

state0 = lio.init_state(cfg)
g0 = state0.graph
# populate a realistic graph: 200 keyframes
g, n = make_chain_fixture(n=24, K=256, B=g0.bt_i.shape[0],
                          G=g0.gps_i.shape[0])
g = g._replace(pose_mask=g.pose_mask.at[:200].set(True))


def timeit(name, fn, n_=3, reps=REPS):
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(n_):
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


def marg_body(c):
    gg = g._replace(poses=g.poses.at[0, 3].add(c * 1e-9))
    cov = solver.marginal_covariance(gg, jnp.int32(199))
    return c + cov.sum()


timeit("marginal_covariance K=256", loop(marg_body))
