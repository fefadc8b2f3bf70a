"""End-to-end golden test: replay a synthetic sequence through the full
per-scan LIO step and score ATE — this build's stand-in for the reference's
bag-replay validation (SURVEY.md §4)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from lio_slam_tpu.config import Config, StaticConfig, RegistrationConfig
from lio_slam_tpu.io import synthetic
from lio_slam_tpu.pipeline import lio
from lio_slam_tpu.utils import pointcloud as pc


def small_config():
    return Config(
        static=StaticConfig(
            max_raw_points=4096, max_scan_points=4096, max_map_points=16384,
            max_keyframes=64, max_keyframe_points=2048,
            max_loop_queue=4, max_gps_queue=4, window_size=16),
        registration=RegistrationConfig(degeneracy_eig_thresh=10.0),
    )


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(n_scans=25, n_points=4096, seed=0)


@pytest.fixture(scope="module")
def run_result(seq):
    cfg = small_config()
    step = lio.make_lio_step(cfg)
    state = lio.init_state(cfg)
    outs = []
    rs = np.random.RandomState(7)
    for i in range(len(seq.stamps)):
        # initial guess = previous estimate composed with the true increment
        # plus noise — emulating IMU-odometry quality
        if i == 0:
            guess = np.zeros(6, np.float32)
            gvalid = False
        else:
            from lio_slam_tpu.utils import se3
            inc = se3.pose6_between(jnp.asarray(seq.poses[i - 1]),
                                    jnp.asarray(seq.poses[i]))
            inc = jnp.asarray(inc) + jnp.asarray(
                rs.randn(6).astype(np.float32) * [0.002, 0.002, 0.005, 0.02, 0.02, 0.01])
            guess = np.asarray(se3.pose6_compose(jnp.asarray(np.asarray(outs[-1].pose)),
                                                 inc))
            gvalid = True
        inp = lio.ScanInput(
            cloud=pc.Cloud(xyz=jnp.asarray(seq.scans[i]),
                           mask=jnp.asarray(seq.scan_masks[i])),
            stamp=jnp.float32(seq.stamps[i]),
            init_guess=jnp.asarray(guess),
            guess_valid=jnp.asarray(gvalid),
            imu_rpy=jnp.asarray(seq.imu_rpy[i]),
            imu_available=jnp.asarray(True),
            gps_pos=jnp.zeros(3), gps_info=jnp.zeros(3),
            gps_valid=jnp.asarray(False),
        )
        state, out = step(state, inp)
        outs.append(out)
    return state, outs


def test_trajectory_ate(seq, run_result):
    from lio_slam_tpu.utils import se3
    state, outs = run_result
    est = np.stack([np.asarray(o.pose) for o in outs])
    # the estimator's odometry frame is anchored at its first pose; compare
    # against the truth trajectory re-based to its own first pose
    rel_truth = np.stack([
        np.asarray(se3.pose6_between(jnp.asarray(seq.poses[0]), jnp.asarray(p)))
        for p in seq.poses])
    ate = synthetic.ate_rmse(est, rel_truth)
    assert ate < 0.12, f"ATE {ate:.3f} m too high"


def test_keyframes_created(run_result):
    state, outs = run_result
    n_kf = int(state.store.count)
    assert 3 <= n_kf <= 25
    # keyframe poses mirror the graph
    np.testing.assert_allclose(np.asarray(state.store.poses[:n_kf]),
                               np.asarray(state.graph.poses[:n_kf]), atol=1e-5)


def test_odometry_chain_factors(run_result):
    state, _ = run_result
    n_kf = int(state.store.count)
    bt_mask = np.asarray(state.graph.bt_mask)
    assert bt_mask[:n_kf - 1].all()
    assert not bt_mask[n_kf - 1:].any()


def test_incremental_odometry_consistent(run_result):
    """Composing incremental outputs must reproduce the absolute trajectory."""
    from lio_slam_tpu.utils import se3
    state, outs = run_result
    pose = np.zeros(6, np.float32)
    acc = jnp.asarray(outs[0].pose)  # first increment is from origin
    for o in outs[1:]:
        acc = se3.pose6_compose(acc, jnp.asarray(o.incremental))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(outs[-1].pose),
                               atol=1e-3)


def test_registration_healthy(run_result):
    _, outs = run_result
    inliers = [int(o.num_inliers) for o in outs[1:]]
    assert np.median(inliers) > 500
    assert not any(bool(o.degenerate) for o in outs[1:])
