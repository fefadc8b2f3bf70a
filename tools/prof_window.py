"""Device timing: window-solve internals — where does the time go?"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from lio_slam_tpu.config import Config, RegistrationConfig, StaticConfig
from lio_slam_tpu.graph import solver
from lio_slam_tpu.pipeline import lio
from lio_slam_tpu.utils import smallmat

REPS = 30
W = 32

cfg = Config(
    static=StaticConfig(max_raw_points=1024, max_scan_points=512,
                        max_map_points=1024, max_keyframes=256,
                        max_keyframe_points=512, max_loop_queue=8,
                        max_gps_queue=8, window_size=W),
    registration=RegistrationConfig())

state0 = lio.init_state(cfg)
g0 = state0.graph._replace(
    pose_mask=state0.graph.pose_mask.at[:64].set(True))

rng = np.random.default_rng(0)
A = jnp.asarray(rng.standard_normal((W * 6, W * 6)).astype(np.float32))
H192 = A @ A.T + jnp.eye(W * 6) * 10.0
b192 = jnp.asarray(rng.standard_normal(W * 6).astype(np.float32))

D = jnp.asarray(rng.standard_normal((W, 6, 6)).astype(np.float32))
D = jnp.einsum("wij,wkj->wik", D, D) + jnp.eye(6) * 10.0
U = jnp.asarray(rng.standard_normal((W, 6, 6)).astype(np.float32)) * 0.1
bb = jnp.asarray(rng.standard_normal((W, 6)).astype(np.float32))


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


def cho_body(c):
    x = solver._equilibrated_cholesky_solve(H192 + c * 1e-9, b192)
    return c + x.sum()


def thomas_body(c):
    Dn = D + c * 1e-9

    def fwd(carry, inp):
        C_prev, z_prev = carry
        Di, Ui, bi, UiPrev = inp
        Dm = Di - UiPrev.T @ C_prev
        bm = bi - UiPrev.T @ z_prev
        rhs = jnp.concatenate([Ui, bm[:, None]], axis=1)
        sol = smallmat.cholesky_solve_mat(Dm, rhs, eps=1e-6)
        return (sol[:, :6], sol[:, 6]), (sol[:, :6], sol[:, 6])

    U_prev = jnp.concatenate([jnp.zeros((1, 6, 6)), U[:-1]], axis=0)
    _, (Cs, zs) = lax.scan(fwd, (jnp.zeros((6, 6)), jnp.zeros(6)),
                           (Dn, U, bb, U_prev))

    def bwd(x_next, inp):
        Ci, zi = inp
        xi = zi - Ci @ x_next
        return xi, xi

    _, xs = lax.scan(bwd, jnp.zeros(6), (Cs, zs), reverse=True)
    return c + xs.sum()


def dense_iter_body(c):
    g = g0._replace(poses=g0.poses.at[0, 3].add(c * 1e-9))
    g = solver.solve_window_compact(g, jnp.int32(64), W, iterations=1)
    return c + g.poses.sum()


timeit("equilibrated cho solve 192", loop(cho_body))
timeit("thomas scan W=32 (solve only)", loop(thomas_body))
timeit("solve_window_compact x1 (W=32)", loop(dense_iter_body))
