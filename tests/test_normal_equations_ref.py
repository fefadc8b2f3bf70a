"""The plain correspondence + normal-equation path against the float64
reference (`ops/registration_ref.py`), and Gauss-Newton on the plain path.

Tolerance (the same `chip_smoke.py` holds the card to): AtA entries within
2e-4 of sqrt(A_ii A_jj), Atb within 2e-4 of sqrt(A_ii sum s^2 pd2^2), weight
sums within 1e-4 relative, equal inlier counts — over the queries float32
rounding cannot flip (the reference flags the rest as borderline)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from lio_slam_tpu.config import RegistrationConfig
from lio_slam_tpu.ops import registration as reg
from lio_slam_tpu.ops import registration_ref as ref
from lio_slam_tpu.ops import voxel_grid as vg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


def make_scene(seed=0, n_map=4096, n_scan=512):
    rs = np.random.RandomState(seed)
    # planar-ish world: ground plane + wall + noise points
    g = np.stack([rs.uniform(-20, 20, n_map // 2),
                  rs.uniform(-20, 20, n_map // 2),
                  rs.randn(n_map // 2) * 0.01], 1)
    w = np.stack([np.full(n_map // 2, 8.0) + rs.randn(n_map // 2) * 0.01,
                  rs.uniform(-20, 20, n_map // 2),
                  rs.uniform(0, 5, n_map // 2)], 1)
    map_pts = np.concatenate([g, w]).astype(np.float32)
    sel = rs.permutation(n_map)[:n_scan]
    scan = (map_pts[sel] + rs.randn(n_scan, 3) * 0.02).astype(np.float32)
    return map_pts, scan


POSE = np.array([0.02, -0.01, 0.3, 0.5, -0.2, 0.1], np.float32)


def compare(halo, cap, mask=None, seed=0):
    map_pts, scan = make_scene(seed)
    cfg = RegistrationConfig(grid_halo=halo, grid_max_per_cell=cap)
    grid = vg.build_grid(jnp.asarray(map_pts), jnp.ones(len(map_pts), bool),
                         cfg.nn_radius, 4096, cap, halo=halo)
    mask = np.ones(len(scan), bool) if mask is None else mask
    kw = dict(halo=halo, nn_radius=cfg.nn_radius,
              plane_dist_thresh=cfg.plane_dist_thresh,
              robust_weight_floor=cfg.robust_weight_floor)
    table = np.asarray(grid.table)
    full = ref.normal_equations(table, cfg.nn_radius, scan, mask, POSE, **kw)
    keep = mask & ~full.borderline
    r = ref.normal_equations(table, cfg.nn_radius, scan, keep, POSE, **kw)
    dev = chip_smoke.device_normal_equations(grid, scan, keep, POSE, cfg)
    return ref.normal_equation_errors(*dev, r), r, full


def assert_within(err):
    assert err["inlier_diff"] == 0
    for key, tol in chip_smoke.PARITY_TOL.items():
        assert err[key] <= tol, (key, err[key])


@pytest.mark.parametrize("halo,cap", [("z", 24), ("xy", 72), ("full", 64),
                                      ("none", 24)])
def test_plain_path_matches_float64_reference(halo, cap):
    err, r, full = compare(halo, cap)
    assert_within(err)
    assert r.n_inliers > 100
    assert full.borderline.sum() <= 0.02 * len(full.borderline)


@pytest.mark.parametrize("halo,cap", [("z", 24), ("xy", 8), ("full", 16),
                                      ("none", 4)])
def test_grid_table_matches_map_points(halo, cap):
    """The built table against the points: counts are min(rows, C), slots
    past the count are empty, each occupied slot holds a point hashing
    there (small caps make buckets overflow)."""
    map_pts, _ = make_scene(5)
    grid = vg.build_grid(jnp.asarray(map_pts), jnp.ones(len(map_pts), bool),
                         1.0, 1024, cap, halo=halo)
    err = ref.grid_table_errors(grid.table, grid.counts, map_pts, 1.0, halo)
    assert err == {"count_errors": 0, "slot_errors": 0, "stray_rows": 0}
    assert int(np.asarray(grid.counts).max()) == cap


def test_grid_table_check_sees_a_wrong_table():
    map_pts, _ = make_scene(6)
    grid = vg.build_grid(jnp.asarray(map_pts), jnp.ones(len(map_pts), bool),
                         1.0, 1024, 24, halo="z")
    table = np.asarray(grid.table).copy()
    counts = np.asarray(grid.counts).copy()
    b = int(np.argmax(counts))
    o = int(np.argmin(np.where(counts > 0, counts, 99)))
    moved = table.copy()
    moved[o, 0] = table[b, 0]                     # a point in a foreign bucket
    assert ref.grid_table_errors(moved, counts, map_pts, 1.0, "z")[
        "stray_rows"] == 1
    twice = table.copy()
    twice[b, 1] = table[b, 0]                     # one point stored twice
    assert ref.grid_table_errors(twice, counts, map_pts, 1.0, "z")[
        "stray_rows"] == 1
    short = counts.copy()
    short[b] -= 1                                 # count below its rows
    err = ref.grid_table_errors(table, short, map_pts, 1.0, "z")
    assert err["count_errors"] == 1 and err["slot_errors"] == 1


def test_reference_respects_scan_mask():
    mask = np.arange(512) < 256
    err, r, _ = compare("z", 24, mask=mask, seed=3)
    assert_within(err)
    assert 0 < r.n_inliers <= 256
    assert not r.valid[256:].any()


def test_empty_map_gives_empty_system():
    cfg = RegistrationConfig()
    grid = vg.empty_grid(cfg.nn_radius, 1024, cfg.grid_max_per_cell)
    scan = np.random.RandomState(0).uniform(-5, 5, (128, 3)).astype(np.float32)
    mask = np.ones(128, bool)
    r = ref.normal_equations(np.asarray(grid.table), cfg.nn_radius, scan,
                             mask, np.zeros(6, np.float32))
    AtA, Atb, n, ws, wr = chip_smoke.device_normal_equations(
        grid, scan, mask, np.zeros(6, np.float32), cfg)
    assert r.n_inliers == 0 and int(n) == 0
    assert float(np.abs(AtA).sum()) == 0.0 and float(np.abs(Atb).sum()) == 0.0
    assert not r.AtA.any() and float(ws) == 0.0


def test_reference_jacobian_matches_finite_differences():
    """The reference's analytic dR/dtheta against central differences."""
    rpy = np.array([0.3, -0.2, 1.1])
    _, dR = ref.rpy_to_matrix(rpy)
    for k in range(3):
        e = np.zeros(3)
        e[k] = 1e-6
        fd = (ref.rpy_to_matrix(rpy + e)[0]
              - ref.rpy_to_matrix(rpy - e)[0]) / 2e-6
        np.testing.assert_allclose(dR[..., k], fd, atol=1e-8)


def test_gauss_newton_converges_on_plain_path():
    """register_with_grid from a perturbed pose recovers the scan's true
    pose (the scan is the map under a known rigid motion)."""
    rs = np.random.RandomState(1)
    u = lambda lo, hi: rs.uniform(lo, hi, 3000)
    map_pts = np.concatenate([                      # ground + two walls
        np.stack([u(-15, 15), u(-15, 15), rs.randn(3000) * 0.005], 1),
        np.stack([np.full(3000, 8.0), u(-15, 15), u(0, 5)], 1),
        np.stack([u(-15, 15), np.full(3000, -10.0), u(0, 5)], 1),
    ]).astype(np.float32)
    body = map_pts[rs.permutation(len(map_pts))[:2048]]
    truth = np.array([0.01, -0.02, 0.05, 0.3, -0.2, 0.05], np.float32)
    R, _ = ref.rpy_to_matrix(truth[:3])
    scan = ((body - truth[3:]) @ R).astype(np.float32)    # world -> body
    cfg = RegistrationConfig(max_iterations=30)
    grid = vg.build_grid(jnp.asarray(map_pts), jnp.ones(len(map_pts), bool),
                         cfg.nn_radius, 4096, cfg.grid_max_per_cell,
                         halo=cfg.grid_halo)
    init = truth + np.array([0.01, -0.01, 0.02, 0.1, -0.08, 0.05], np.float32)
    res = reg.register_with_grid(jnp.asarray(scan), jnp.ones(2048, bool),
                                 grid, jnp.asarray(init), cfg)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.pose), truth, atol=5e-3)
    assert int(res.num_inliers) > 1000


def test_parity_phase_at_small_width():
    """chip_smoke's phase 4 on the CPU at a reduced width: the scene, the
    borderline exclusion and the tolerance check hold together."""
    p = chip_smoke.parity(RegistrationConfig(), 2048, 16384, 4096,
                          controls=("bfloat16",))
    chip_smoke.check_parity(p)
    assert set(p["controls"]) == {"bfloat16"}
    assert p["inliers"] > 500
    assert set(p["paths"]) == {"plain"}
    assert p["table"] == {"count_errors": 0, "slot_errors": 0, "stray_rows": 0}
