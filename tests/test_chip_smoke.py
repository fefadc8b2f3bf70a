"""chip_smoke.py's contract on the CPU: it refuses to run without a GPU, its
result line has exactly the keys the contract names, the compile cache sits
where it should, and its mission and four-card paths work at small widths
(four virtual CPU devices stand in for the cards)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run(args, cwd, **env):
    e = dict(os.environ)
    e.update(env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_refuses_the_cpu():
    p = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT, JAX_PLATFORMS="cpu")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no accelerator" in p.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path),
             JAX_PLATFORMS="cpu")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_result_line_keys():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.result_line([Dev()]))
    assert line == {"ok": True, "device": {"platform": "gpu",
                                           "kind": "NVIDIA H100 80GB HBM3",
                                           "count": 1}}
    assert json.loads(chip_smoke.result_line([Dev()] * 4))["device"]["count"] == 4


def _cache_dir(**env):
    code = "import jax, lio_slam_tpu; print(jax.config.jax_compilation_cache_dir)"
    e = {k: v for k, v in os.environ.items()
         if k != "JAX_COMPILATION_CACHE_DIR"}
    e.update(env, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=e,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_cache_dir_follows_the_environment(tmp_path):
    assert _cache_dir(JAX_COMPILATION_CACHE_DIR=str(tmp_path)) == str(tmp_path)


def test_cache_dir_defaults_to_the_checkout():
    d = _cache_dir()
    assert os.path.realpath(d) == os.path.realpath(os.path.join(ROOT,
                                                                ".jax_cache"))
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _small_cfg(table_size=2048):
    import dataclasses
    from lio_slam_tpu.config import StaticConfig, get_config
    cfg = get_config("6t")
    return cfg.replace(
        static=StaticConfig(max_raw_points=16384, max_scan_points=4096,
                            max_map_points=16384, max_keyframes=32,
                            max_keyframe_points=4096, max_loop_queue=2,
                            max_gps_queue=2, window_size=8,
                            max_imu_window=32),
        registration=dataclasses.replace(cfg.registration,
                                         grid_table_size=table_size))


def test_mission_feeds():
    """IMU windows at the rig's rate through the sweep end; 1 Hz GPS fixes
    handed over 0.2 s ahead, the datum fixes queued at the first scan;
    truth anchored at the first pose."""
    cfg = _small_cfg()
    scans, imus, gps, truth = chip_smoke.make_mission(cfg, 24, 4096)
    assert len(scans) == len(imus) == len(gps) == len(truth) == 24
    assert imus[0] is None
    for i in (1, 15):
        st = imus[i]["stamps"]
        assert np.all(np.diff(st) > 0)
        assert st[0] > scans[i - 1].stamp and st[-1] > scans[i].stamp
        assert len(st) == 2 * round(cfg.imu.imu_rate * 0.1)
    assert [i for i, g in enumerate(gps) if g] == [0, 8, 18]
    assert [f[0] for f in gps[0]] == [-4.0, -3.0, -2.0, -1.0, 0.0]
    assert gps[8][0][0] == scans[10].stamp
    np.testing.assert_allclose(truth[0], 0.0, atol=1e-6)


def test_four_card_path_on_virtual_devices():
    """The --cards 4 path: the mission with its map sharded over four
    devices tracks the one-device oracle whose table holds what the four
    hold together, and each device holds its own shard."""
    import jax
    cfg = _small_cfg(table_size=512)
    mission = chip_smoke.make_mission(cfg, 40, 16384)
    out = chip_smoke.sharded_vs_oracle(jax.devices()[:4], cfg, mission,
                                       inject_at=30)
    assert out["aligned_m"] <= chip_smoke.SHARDED_ALIGNED_TOL
    assert out["diverged_m"] <= chip_smoke.SHARDED_DIVERGED_TOL
    assert out["sharded"]["loops"] == 1 and out["oracle"]["loops"] == 1
    for run in ("sharded", "oracle"):
        ev = out[run]["events"]
        assert ev.shape == (40, 3)
        assert ev[-1].tolist() == [out[run]["keyframes"], 1,
                                   out[run]["gps_factors"]]


def test_host_relative_pose_matches_se3():
    from lio_slam_tpu.utils import se3
    rs = np.random.RandomState(4)
    a = np.concatenate([rs.uniform(-0.5, 0.5, 3), rs.uniform(-9, 9, 3)])
    b = np.concatenate([rs.uniform(-0.5, 0.5, 3), rs.uniform(-9, 9, 3)])
    np.testing.assert_allclose(chip_smoke.pose6_between(a, b),
                               np.asarray(se3.pose6_between(a, b)), atol=1e-5)


def test_event_divergence():
    a = np.array([[1, 0, 0], [1, 0, 0], [2, 0, 0], [2, 0, 1], [3, 1, 1]])
    b = a.copy()
    assert chip_smoke.first_divergence(a, b) == (5, [])
    b[3:, 2] = 0
    b[4, 2] = 1
    assert chip_smoke.first_divergence(a, b) == (3, ["GPS factors"])
    assert chip_smoke.event_scans(a) == {"keyframes": [0, 2, 4], "loops": [4],
                                         "GPS factors": [3]}
