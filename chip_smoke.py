#!/usr/bin/env python3
"""Smoke run of the SLAM main path on NVIDIA GPUs.

    python chip_smoke.py             # one card: phases 1-5 below
    python chip_smoke.py --cards 4   # four cards: the sharded mission only

One process runs every phase.  Any failure ends the run with a non-zero exit
and no result line; the last line of standard output is, on success,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

1. device     the JAX devices must be GPUs; prints the card's name and power
              limit (nvidia-smi), the JAX version and the compile cache.
2. precision  a float32 (1,1024)@(1024,1) product that TF32 would round:
              1024.5 in float32, 1024 in TF32.
3. mission    `Runner(get_config("6t"))` at the default full static widths on
              a seeded sweep-sensor mission with 50 Hz IMU windows, 1 Hz GPS
              fixes, the loop detector and archive at cadence, one injected
              loop constraint (a full K=2048 correction and map rebuild) and
              `save_map` at the end.  Fails on a non-finite pose or ATE above
              0.2 m.
4. parity     one scan's Gauss-Newton normal equations (16,384 queries, a
              131,072-point map in the z-halo hash grid) against the float64
              NumPy reference `ops/registration_ref.py`.
5. card tests the tests marked `gpu`, in this process.

With --cards 4 the phase-3 mission runs with its map sharded over four cards
(`Runner(cfg, mesh=make_mesh(4))`: each card hashes its share of the points
into its own 32,768 x 24 table) and is compared with a one-card oracle whose
table holds what the four hold together: 32,768 buckets of 4 x 24 slots, so
that a cell keeps as many points in both.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

MISSION_SCANS = 160         # 16 s of 10 Hz scans
SPEED = 0.8                 # m/s: a fix paired 0.2 s off its keyframe is 0.16 m off
GPS_SIGMA = 0.05            # m, seeded noise of the corrected (RTK) fixes
ATE_LIMIT = 0.2             # m
WARMUP_SCANS = 40           # scans before the steady-state window
# parity tolerances (from tests/test_normal_equations_ref.py; see below)
PARITY_TOL = {"AtA_rel": 2e-4, "Atb_rel": 2e-4, "weight_sum_rel": 1e-4,
              "wres_sum_rel": 1e-4}
MAX_BORDERLINE = 0.01       # share of queries allowed to sit on a gate edge
# sharded mission vs its one-card oracle.  Until the two runs first differ
# in the scan at which a keyframe, loop or GPS factor is added, they solve
# the same graph and differ only in summation order: held to 5 cm.  From
# that scan on they solve different graphs (a GPS factor paired with a
# keyframe one scan apart re-anchors the map by up to one pairing offset,
# 0.2 s x SPEED = 0.16 m): held to 0.2 m.
SHARDED_ALIGNED_TOL = 0.05  # m
SHARDED_DIVERGED_TOL = 0.2  # m
# lower matmul precisions read once beside the float32 path in phase 4
PRECISION_CONTROLS = ("tensorfloat32", "bfloat16")


def say(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi in a child process
    that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    return lines[0]


def gpu_devices(count: int):
    """The first `count` GPU devices, or SystemExit(2) when JAX has none."""
    import jax
    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"no accelerator: {e}", file=sys.stderr)
        raise SystemExit(2)
    if devs[0].platform != "gpu":
        print(f"no accelerator: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        raise SystemExit(2)
    if len(devs) < count:
        print(f"need {count} GPUs, JAX found {len(devs)}", file=sys.stderr)
        raise SystemExit(2)
    return devs[:count]


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {"platform": d.platform,
                                              "kind": d.device_kind,
                                              "count": len(devices)}})


# ---------------------------------------------------------------------------
# phase 2: matmul precision
# ---------------------------------------------------------------------------

def precision_probe() -> float:
    """float32 (1,1024) @ (1024,1) of ones and 1 + 2**-11: 1024.5 exactly
    in float32; TF32 keeps 10 mantissa bits and drops the 2**-11 terms."""
    import jax
    import jax.numpy as jnp
    x = jnp.ones((1, 1024), jnp.float32)
    y = jnp.full((1024, 1), 1.0 + 2.0 ** -11, jnp.float32)
    return float(jax.jit(jnp.matmul)(x, y)[0, 0])


# ---------------------------------------------------------------------------
# phase 3: the mission
# ---------------------------------------------------------------------------

class CompileLog:
    """Backend compile seconds per jitted program, from JAX's monitoring
    events."""

    def __init__(self):
        from jax import monitoring
        self.events: list[tuple[str, float]] = []
        monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.events.append((str(kw.get("fun_name", "?")), float(duration)))

    def since(self, start: int) -> dict:
        out: dict[str, float] = {}
        for name, sec in self.events[start:]:
            out[name] = out.get(name, 0.0) + sec
        return out


def make_mission(cfg, n_scans: int, n_points: int, seed: int = 0,
                 speed: float = SPEED):
    """A seeded sweep-sensor mission for `cfg`'s rig.

    Returns (scans, imus, gps, truth): per-scan StandardScans; IMU window
    dicts at the preset's rate from `synthetic.make_imu_windows` (body rates
    and specific force of the truth trajectory, through the sweep's end so
    deskew has coverage), expressed in the IMU frame through the rig's
    extrinsic rotation; 1 Hz GPS fix lists (truth plus seeded noise,
    projected about a fixed datum); and truth poses relative to the first
    pose.  The platform starts from rest; the fixes its receiver made while
    it waited there (the intake averages `first_fix_average` of them into
    the datum) are queued at the first scan."""
    import jax
    import jax.numpy as jnp
    from lio_slam_tpu.io import formats, synthetic
    from lio_slam_tpu.utils import enu, se3

    # the generator's many small eager ops run on the host CPU backend when
    # the process has one: each would otherwise wait on the card
    host = jax.local_devices(backend="cpu")[:1] if "cpu" in os.environ.get(
        "JAX_PLATFORMS", "cpu") else []
    with (jax.default_device(host[0]) if host else contextlib.nullcontext()):
        sensor = synthetic.rig_sensor_for(cfg)
        seq = synthetic.make_sweep_sequence(
            n_scans=n_scans + 1, n_points=n_points, seed=seed, sensor=sensor,
            speed=speed)
        poses = jnp.asarray(seq.poses)
        truth = np.asarray(se3.pose6_between(poses[:1], poses[:n_scans]))
        acc, gyr, _, rel_t, imask = synthetic.make_imu_windows(
            seq, 2 * sensor.samples_per_scan + 2,
            samples_per_scan=sensor.samples_per_scan,
            gravity=cfg.imu.gravity, sweep_cover=sensor.sweep_time)
    ext = np.asarray(cfg.imu.ext_rot, np.float64).reshape(3, 3)
    rng = np.random.RandomState(seed + 11)
    datum = enu.LocalCartesian()
    datum.reset(31.2304, 121.4737, 12.0)

    def fix(stamp, position):
        lat, lon, alt = datum.reverse(
            (position + rng.randn(3) * GPS_SIGMA).astype(np.float64))
        return (stamp, float(lat), float(lon), float(alt), 0,
                np.array([GPS_SIGMA ** 2] * 2 + [4 * GPS_SIGMA ** 2]))

    def window(i):
        m = imask[i]
        return {"acc": (acc[i][m] @ ext).astype(np.float32),
                "gyr": (gyr[i][m] @ ext).astype(np.float32),
                "stamps": float(seq.stamps[i]) + rel_t[i][m].astype(np.float64)}

    scans, imus, gps = [], [], []
    for i in range(n_scans):
        m = seq.scan_masks[i]
        scans.append(formats.StandardScan(
            xyz=seq.scans[i][m], intensity=np.zeros(int(m.sum()), np.float32),
            ring=seq.rings[i][m].astype(np.uint16), time=seq.ptimes[i][m],
            stamp=float(seq.stamps[i])))
        imus.append(window(i) if i else None)
        gps.append(None)
    # 1 Hz fixes at scan stamps, each handed over with the scan 0.2 s
    # before it (the pairing window): LiveFeed's two-scan delay means a
    # fix that young is already queued when the scan is processed
    for k in range(0, n_scans, 10):
        at = max(k - 2, 0)
        waited = cfg.gps.first_fix_average - 1 if k == 0 else 0
        gps[at] = [fix(float(seq.stamps[k]) - j, truth[k, 3:])
                   for j in range(waited, -1, -1)]
    return scans, imus, gps, truth


def pose6_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a^-1 b of two (roll, pitch, yaw, x, y, z) poses, R = Rz Ry Rx, on
    the host."""
    from scipy.spatial.transform import Rotation
    ra = Rotation.from_euler("ZYX", a[2::-1])
    rb = Rotation.from_euler("ZYX", b[2::-1])
    return np.concatenate([(ra.inv() * rb).as_euler("ZYX")[::-1],
                           ra.inv().apply(b[3:] - a[3:])])


def mission_events(path: str) -> np.ndarray:
    """(scans, 3) keyframes, loops and GPS factors after each scan, read
    from a Runner mission log."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return np.asarray([(r["keyframes"], r["loops"], r["gps_factors"])
                       for r in recs if "event" not in r], np.int64)


def run_mission(cfg, mission, label: str, mesh=None, inject_at: int = None,
                warmup: int = WARMUP_SCANS, save_dir: str = None,
                compile_log: CompileLog = None, events: bool = False) -> dict:
    """Drive `Runner` over the mission through its public API and return
    the measurements.  `inject_at`: scan index at which one loop constraint
    between the first and the newest keyframe (truth relative pose) is
    posted through `Runner.inject_loop_constraint`.  `events`: also return
    the per-scan counts of `mission_events`, from the Runner's mission
    log."""
    from lio_slam_tpu.pipeline.runner import Runner

    scans, imus, gps, truth = mission
    n = len(scans)
    warmup = min(warmup, n // 2)
    c0 = len(compile_log.events) if compile_log else 0
    log_dir = tempfile.TemporaryDirectory() if events else None
    log_path = os.path.join(log_dir.name, "mission.jsonl") if events else None
    t_build = time.perf_counter()
    runner = Runner(cfg, loop_every=10, mesh=mesh, mission_log=log_path)
    lat = np.zeros(n)
    injected = False
    c_warm = None
    t_warm = None
    for i in range(n):
        if i == warmup:
            t_warm = time.perf_counter()
            c_warm = len(compile_log.events) if compile_log else 0
        if inject_at is not None and i == inject_at:
            # host-side harness work: one transfer of the store's stamps
            count = int(runner.state.store.count)
            stamps = np.asarray(runner.state.store.stamps)[:count]
            j = count - 1
            si = int(round(float(stamps[0]) / 0.1))
            sj = int(round(float(stamps[j]) / 0.1))
            injected = runner.inject_loop_constraint(
                0, j, pose6_between(truth[si], truth[sj]))
        t0 = time.perf_counter()
        runner.process_scan(scans[i], imu=imus[i], gps_fixes=gps[i])
        lat[i] = time.perf_counter() - t0
    runner.drain()
    t_end = time.perf_counter()
    est = np.stack(runner.trajectory)
    st = runner.state
    res = {
        "label": label, "scans": n, "warmup": warmup,
        "wall_s": t_end - t_build,
        "steady_scans_per_s": (n - warmup) / (t_end - t_warm),
        "latency_p50_ms": float(np.median(lat[warmup:]) * 1e3),
        "latency_p99_ms": float(np.percentile(lat[warmup:], 99) * 1e3),
        "latency_max_ms": float(lat[warmup:].max() * 1e3),
        "ate_m": float(np.sqrt(np.mean(np.sum((est[:, 3:] - truth[:n, 3:]) ** 2,
                                              axis=1)))),
        "finite": bool(np.isfinite(est).all()),
        "keyframes": int(st.store.count), "loops": int(st.loop_count),
        "gps_factors": int(st.gps_count),
        "injected": bool(injected),
        "full_solve_pending": bool(st.needs_full_solve),
        "stages": runner.timer.as_dict(),
        "trajectory": est,
        "runner": runner,
    }
    if events:
        runner.close()
        res["events"] = mission_events(log_path)
        log_dir.cleanup()
    if compile_log is not None:
        res["compile_s"] = compile_log.since(c0)
        res["compiles_in_window"] = compile_log.events[c_warm:]
    if save_dir is not None:
        saved = runner.save_map(save_dir, resolution=cfg.output.global_map_leaf_size)
        hm = runner.height_map()
        elev = np.asarray(hm.elevation)
        res["map_points"] = saved.num_points
        res["map_files"] = [os.path.basename(f) for f in saved.files]
        res["height_cells"] = int(np.isfinite(elev).sum())
        if not saved.success or saved.num_points == 0 or not res["height_cells"]:
            raise RuntimeError(f"{label}: map products empty")
    return res


def check_mission(res: dict):
    if not res["finite"]:
        raise RuntimeError(f"{res['label']}: non-finite pose")
    if res["ate_m"] > ATE_LIMIT:
        raise RuntimeError(f"{res['label']}: ATE {res['ate_m']:.4f} m "
                           f"> {ATE_LIMIT} m")
    if not res["injected"] or res["loops"] < 1:
        raise RuntimeError(f"{res['label']}: injected loop not consumed")
    if res["gps_factors"] < 1:
        raise RuntimeError(f"{res['label']}: no GPS factor added")
    if res["full_solve_pending"]:
        raise RuntimeError(f"{res['label']}: full correction left pending")


def print_mission(res: dict, card: str):
    tag = f"[{card}] {res['label']}"
    for name, sec in sorted(res.get("compile_s", {}).items(),
                            key=lambda kv: -kv[1]):
        if sec >= 0.5:
            say(f"{tag} compile {name}: {sec:.2f} s")
    if "compile_s" in res:
        late = res["compiles_in_window"]
        say(f"{tag} compile total: {sum(res['compile_s'].values()):.2f} s; "
            f"{len(late)} compilations inside the steady window "
            f"({sum(sec for _, sec in late):.2f} s): "
            + ", ".join(f"{n} {sec:.2f} s" for n, sec in late if sec >= 0.1))
    say(f"{tag} steady state: {res['steady_scans_per_s']:.2f} scans/s over "
        f"{res['scans'] - res['warmup']} scans; per-scan latency p50 "
        f"{res['latency_p50_ms']:.2f} ms, p99 {res['latency_p99_ms']:.2f} ms, "
        f"max {res['latency_max_ms']:.2f} ms")
    say(f"{tag} host stages (mean/max ms over all scans; device time lands "
        f"in host_fetch): " + ", ".join(
            f"{k} {v['mean_ms']:.2f}/{v['max_ms']:.1f}"
            for k, v in sorted(res["stages"].items())))
    say(f"{tag} ATE {res['ate_m']:.4f} m over {res['scans']} scans; "
        f"keyframes {res['keyframes']}, loops {res['loops']}, "
        f"GPS factors {res['gps_factors']}")
    if "map_points" in res:
        say(f"{tag} save_map: {res['map_points']} points in "
            f"{res['map_files']}; height grid cells {res['height_cells']}")


def step_memory(runner) -> str:
    """`memory_analysis()` of the compiled mapping step at its real
    arguments (a persistent-cache hit after the mission compiled it)."""
    from lio_slam_tpu.pipeline import lio
    s = runner.cfg.static
    inp = lio.empty_scan_input(s.max_raw_points)
    ma = runner.step.lower(runner.state, inp).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')} "
                     f"{getattr(ma, f) / 2**20:.1f} MiB" for f in fields)


# ---------------------------------------------------------------------------
# phase 4: normal-equation parity with the float64 reference
# ---------------------------------------------------------------------------

def parity_scene(n_queries: int, n_map: int, seed: int = 3):
    """One scan of the synthetic world against a map sampled from it, at a
    pose one Gauss-Newton step away from the truth."""
    from lio_slam_tpu.io import synthetic
    rs = np.random.RandomState(seed)
    world = synthetic.make_world(seed)
    map_pts = world[rs.choice(len(world), n_map, replace=False)]
    truth = np.array([0.01, -0.02, 0.4, 3.0, -2.0, 0.5], np.float32)
    scan, mask = synthetic.observe(world, truth, n_queries, rng=rs)
    pose = truth + np.array([2e-3, -1e-3, 3e-3, 0.02, -0.015, 0.01],
                            np.float32)
    return map_pts.astype(np.float32), scan, mask, pose


def device_normal_equations(grid, scan, mask, pose, rcfg):
    """The production plain path: find_correspondences + _normal_equations."""
    import jax
    import jax.numpy as jnp
    from lio_slam_tpu.ops import registration as reg

    @jax.jit
    def ne(grid, scan, mask, pose):
        corr = reg.find_correspondences(scan, mask, None, None, pose, rcfg,
                                        grid=grid)
        AtA, Atb = reg._normal_equations(scan, corr, pose)
        return (AtA, Atb, jnp.sum(corr.valid.astype(jnp.int32)),
                jnp.sum(corr.weight),
                jnp.sum(corr.weight * jnp.abs(corr.residual)))

    return jax.device_get(ne(grid, jnp.asarray(scan), jnp.asarray(mask),
                             jnp.asarray(pose)))


def parity(rcfg, n_queries: int, n_map: int, table_size: int,
           controls: tuple = ()) -> dict:
    """Normal equations on the device against the float64 reference.

    Queries that float32 rounding can legitimately flip (within 1e-4 of a
    gate, a cell boundary, or a 5th/6th neighbour tie — the reference flags
    them) are left out of both sides, and must be under MAX_BORDERLINE of
    the scan.  The grid table the device built is the reference's input, so
    which points survive bucket overflow (an unstable sort on the device)
    does not enter the comparison; the table itself is checked against the
    map points (`registration_ref.grid_table_errors`).  `controls`: matmul
    precisions whose errors are read beside the float32 path's."""
    import jax
    import jax.numpy as jnp
    from lio_slam_tpu.ops import registration_ref as ref
    from lio_slam_tpu.ops import voxel_grid as vg

    map_pts, scan, mask, pose = parity_scene(n_queries, n_map)
    grid = vg.build_grid(jnp.asarray(map_pts), jnp.ones(len(map_pts), bool),
                         rcfg.nn_radius, table_size, rcfg.grid_max_per_cell,
                         halo=rcfg.grid_halo)
    table = np.asarray(grid.table)
    table_err = ref.grid_table_errors(table, grid.counts, map_pts,
                                      rcfg.nn_radius, rcfg.grid_halo)
    kw = dict(halo=rcfg.grid_halo, nn_radius=rcfg.nn_radius,
              plane_dist_thresh=rcfg.plane_dist_thresh,
              robust_weight_floor=rcfg.robust_weight_floor)
    full = ref.normal_equations(table, rcfg.nn_radius, scan, mask, pose, **kw)
    keep = mask & ~full.borderline
    r = ref.normal_equations(table, rcfg.nn_radius, scan, keep, pose, **kw)
    dev = device_normal_equations(grid, scan, keep, pose, rcfg)
    out = {"queries": int(mask.sum()), "borderline": int(full.borderline.sum()),
           "inliers": r.n_inliers, "table": table_err,
           "paths": {"plain": ref.normal_equation_errors(*dev, r)},
           "controls": {}}
    for prec in controls:
        with jax.default_matmul_precision(prec):
            low = device_normal_equations(grid, scan, keep, pose, rcfg)
        out["controls"][prec] = ref.normal_equation_errors(*low, r)
    return out


def beyond_tolerance(err: dict) -> list:
    """The parity checks `err` fails."""
    bad = [f"inlier count differs by {err['inlier_diff']}"] \
        if err["inlier_diff"] != 0 else []
    return bad + [f"{key} {err[key]:.3e} > {tol:.0e}"
                  for key, tol in PARITY_TOL.items() if not err[key] <= tol]


def check_parity(p: dict):
    if p["borderline"] > MAX_BORDERLINE * p["queries"]:
        raise RuntimeError(f"parity: {p['borderline']} borderline queries of "
                           f"{p['queries']}")
    if any(p["table"].values()):
        raise RuntimeError(f"parity: grid table disagrees with the map "
                           f"points: {p['table']}")
    for name, err in p["paths"].items():
        bad = beyond_tolerance(err)
        if bad:
            raise RuntimeError(f"parity {name}: " + "; ".join(bad))


# ---------------------------------------------------------------------------
# phase 5: tests that need the card
# ---------------------------------------------------------------------------

def card_tests(root: str) -> dict:
    import pytest

    class Tally:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.failed:
                self.n["failed"] += 1
            elif report.skipped:
                self.n["skipped"] += 1
            elif report.when == "call":
                self.n["passed"] += 1

    tally = Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(root, "tests", "test_gpu.py")],
                     plugins=[tally])
    if rc != 0 or tally.n["failed"] or tally.n["skipped"] \
            or not tally.n["passed"]:
        raise RuntimeError(f"card tests: exit {rc}, {tally.n}")
    return tally.n


# ---------------------------------------------------------------------------
# the two runs
# ---------------------------------------------------------------------------

def one_card(devices, card: str, root: str):
    from lio_slam_tpu.config import get_config
    from lio_slam_tpu.pipeline import lio

    v = precision_probe()
    say(f"[{card}] precision probe (1,1024)@(1024,1): {v}")
    if v != 1024.5:
        raise RuntimeError(f"matmul is not float32: {v} (TF32 gives 1024)")

    cfg = get_config("6t")
    s = cfg.static
    say(f"[{card}] mission: 6t preset, raw {s.max_raw_points}, registered "
        f"{s.max_scan_points}, keyframes {s.max_keyframes} x "
        f"{s.max_keyframe_points}, grid {cfg.registration.grid_table_size} x "
        f"{cfg.registration.grid_max_per_cell}, full solver "
        f"{'sparse' if lio._use_sparse_solver(cfg) else 'dense'} at "
        f"K={s.max_keyframes}")
    log = CompileLog()
    t0 = time.perf_counter()
    mission = make_mission(cfg, MISSION_SCANS, s.max_raw_points)
    say(f"[{card}] mission data: {MISSION_SCANS} scans made in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    with tempfile.TemporaryDirectory() as out_dir:
        res = run_mission(cfg, mission, "6t mission",
                          inject_at=MISSION_SCANS - 30, save_dir=out_dir,
                          compile_log=log)
    print_mission(res, card)
    check_mission(res)
    dev = devices[0]
    say(f"[{card}] mapping step memory_analysis: {step_memory(res['runner'])}")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    say(f"[{card}] peak_bytes_in_use: "
        + (f"{peak / 2**30:.3f} GiB" if peak else "not reported"))
    del res

    p = parity(cfg.registration, s.max_scan_points, s.max_map_points,
               cfg.registration.grid_table_size, controls=PRECISION_CONTROLS)
    say(f"[{card}] parity: {p['queries']} queries vs {s.max_map_points}-point "
        f"map, {p['inliers']} inliers, {p['borderline']} borderline queries "
        f"left out; tolerance {PARITY_TOL}, inlier counts equal")
    say(f"[{card}] parity grid table vs map points: {p['table']}")

    def errors(err):
        return ", ".join(f"{k} {v:.3e}" if isinstance(v, float)
                         else f"{k} {v}" for k, v in err.items())

    for name, err in p["paths"].items():
        say(f"[{card}] parity {name}: {errors(err)}")
    for prec, err in p["controls"].items():
        bad = beyond_tolerance(err)
        say(f"[{card}] parity control, matmul precision {prec}: "
            f"{errors(err)}; " + ("outside the tolerance: " + "; ".join(bad)
                                  if bad else "inside the tolerance"))
    check_parity(p)

    n = card_tests(root)
    say(f"[{card}] card tests: {n}")


def first_divergence(ev_a: np.ndarray, ev_b: np.ndarray):
    """The first scan after which two runs' keyframe, loop or GPS-factor
    counts (`mission_events`) differ, and which of them differ; (number of
    scans, []) when they never do."""
    diff = np.any(ev_a != ev_b, axis=1)
    if not diff.any():
        return len(diff), []
    d = int(np.argmax(diff))
    return d, [name for k, name in enumerate(("keyframes", "loops",
                                               "GPS factors"))
               if ev_a[d, k] != ev_b[d, k]]


def event_scans(ev: np.ndarray) -> dict:
    """Scan indices at which each count of `mission_events` grew."""
    prev = np.vstack([np.zeros((1, 3), ev.dtype), ev[:-1]])
    return {name: np.nonzero(ev[:, k] > prev[:, k])[0].tolist()
            for k, name in enumerate(("keyframes", "loops", "GPS factors"))}


def sharded_vs_oracle(devices, cfg, mission, inject_at: int,
                      card: str = "", compile_log: CompileLog = None) -> dict:
    """The mission with its map sharded over `devices` against the
    one-device oracle whose table holds what the devices' tables hold
    together: the same buckets, D times the slots.  Fails unless every
    device holds its own occupied shard of the map table and the two
    trajectories agree within SHARDED_ALIGNED_TOL up to the first scan at
    which their keyframe, loop or GPS-factor events differ, and within
    SHARDED_DIVERGED_TOL from there on."""
    import dataclasses
    from jax.sharding import Mesh

    D = len(devices)
    mesh = Mesh(np.asarray(devices), ("data",))
    r = cfg.registration
    oracle_cfg = cfg.replace(registration=dataclasses.replace(
        r, grid_max_per_cell=D * r.grid_max_per_cell))
    sh = run_mission(cfg, mission, f"sharded x{D}", mesh=mesh,
                     inject_at=inject_at, compile_log=compile_log, events=True)
    orc = run_mission(oracle_cfg, mission, "one-device oracle",
                      inject_at=inject_at, compile_log=compile_log,
                      events=True)
    for res in (sh, orc):
        print_mission(res, card)
    grid = sh["runner"].state.map_grid
    shards = grid.table.addressable_shards
    per_dev = {str(s.device): int(np.asarray(s.data).sum())
               for s in grid.counts.addressable_shards}
    if (len(shards) != D or {s.device for s in shards} != set(devices)
            or any(s.data.shape[0] != r.grid_table_size for s in shards)
            or any(set(s.data.devices()) != {s.device} for s in shards)
            or min(per_dev.values()) == 0):
        raise RuntimeError(f"map table not spread over the devices: "
                           f"{[(s.device, s.data.shape) for s in shards]}, "
                           f"occupied slots {per_dev}")
    err = np.linalg.norm(sh["trajectory"][:, 3:] - orc["trajectory"][:, 3:],
                         axis=1)
    say(f"[{card}] sharded map table: {D} shards of {shards[0].data.shape}, "
        f"one per device; occupied slots per device {per_dev}")
    d, kinds = first_divergence(sh["events"], orc["events"])
    for res in (sh, orc):
        say(f"[{card}] {res['label']} event scans: {event_scans(res['events'])}")
    aligned = float(err[:d].max()) if d else 0.0
    diverged = float(err[d:].max()) if d < len(err) else 0.0
    say(f"[{card}] sharded vs oracle: events "
        + (f"first differ after scan {d} ({', '.join(kinds)})"
           if kinds else "identical")
        + f"; max position difference {aligned:.4f} m over the {d} scans "
        f"before that (limit {SHARDED_ALIGNED_TOL} m), {diverged:.4f} m over "
        f"the {len(err) - d} from there on (limit {SHARDED_DIVERGED_TOL} m); "
        f"mean {err.mean():.4f} m over {len(err)} scans")
    if aligned > SHARDED_ALIGNED_TOL or diverged > SHARDED_DIVERGED_TOL:
        raise RuntimeError(f"sharded mission left its oracle: {aligned:.4f} m "
                           f"while their events agree, {diverged:.4f} m after")
    return {"aligned_m": aligned, "diverged_m": diverged, "diverged_at": d,
            "sharded": sh, "oracle": orc}


def four_cards(devices, card: str):
    """--cards 4: the phase-3 mission at full widths, map sharded over the
    four cards (32,768 x 24 slots each), against the one-card oracle
    (32,768 x 96)."""
    from lio_slam_tpu.config import get_config

    cfg = get_config("6t")
    mission = make_mission(cfg, MISSION_SCANS, cfg.static.max_raw_points)
    out = sharded_vs_oracle(devices, cfg, mission,
                            inject_at=MISSION_SCANS - 30, card=card,
                            compile_log=CompileLog())
    for res in (out["sharded"], out["oracle"]):
        check_mission(res)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded mission on four cards")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    # the CUDA backend (plus the host CPU for data generation) unless the
    # caller chose a platform: a run without a card fails at the device gate
    # instead of falling back to the CPU
    os.environ.setdefault("JAX_PLATFORMS", "cuda,cpu")
    devices = gpu_devices(args.cards)
    import jax
    import lio_slam_tpu  # noqa: F401  (matmul precision, compile cache)

    card = card_line()
    say(card)
    say(f"[{card}] JAX {jax.__version__}; devices {len(jax.devices())} x "
        f"{devices[0].device_kind}; compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    if args.cards == 1:
        one_card(devices, card, root)
    else:
        four_cards(devices, card)
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
