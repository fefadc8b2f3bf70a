"""Replay a ROS1 bag through the JAX pipeline — the equivalent of the
reference's `rosbag play slope02_01.bag` + `roslaunch liorf
run_lio_sam_6t.launch` workflow (src/liorf/README.md:137-158).

Usage:
    python examples/bag_replay.py mission.bag \
        --lidar /velodyne_points --imu /imu/data --gps /gps/fix \
        --sensor velodyne --save-map /tmp/map_out

With no bag argument this writes and replays a small synthetic bag, so the
example is runnable out of the box.
"""

import argparse
import sys

import numpy as np

from lio_slam_tpu.config import get_config
from lio_slam_tpu.io.bag_replay import BagTopics, replay_bag
from lio_slam_tpu.pipeline.runner import Runner


def make_demo_bag(path: str, n_scans: int = 10) -> str:
    from lio_slam_tpu.io import rosbag as rb

    rng = np.random.default_rng(0)
    w = rb.BagWriter(path)
    t0 = 100.0
    for i in range(n_scans):
        ts = t0 + 0.1 * i
        for j in range(10):
            it = ts + 0.01 * j
            w.write("/imu/data", "sensor_msgs/Imu",
                    rb.encode_imu(it, [0, 0, 0, 1], [0, 0, 0],
                                  [0, 0, 9.81]), it)
        # three-wall room seen from a platform moving +x at 2 m/s
        pts = []
        for ax, off in ((0, 12.0), (1, 12.0), (2, -1.5)):
            p = rng.uniform(-10, 10, (1000, 3))
            p[:, ax] = off + rng.normal(0, 0.02, 1000)
            pts.append(p)
        xyz = (np.concatenate(pts) - [0.2 * i, 0, 0]).astype(np.float32)
        n = len(xyz)
        w.write("/velodyne_points", "sensor_msgs/PointCloud2",
                rb.encode_pointcloud2(xyz, np.zeros(n, np.float32),
                                      np.arange(n, dtype=np.uint16) % 16,
                                      np.zeros(n, np.float32), ts), ts)
    w.close()
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("bag", nargs="?", default=None)
    ap.add_argument("--lidar", default="/velodyne_points")
    ap.add_argument("--imu", default="/imu/data")
    ap.add_argument("--gps", default=None)
    ap.add_argument("--sensor", default="velodyne")
    ap.add_argument("--preset", default="default")
    ap.add_argument("--save-map", default=None)
    args = ap.parse_args()

    bag = args.bag or make_demo_bag("/tmp/lio_demo.bag")
    runner = Runner(get_config(args.preset))
    topics = BagTopics(lidar=args.lidar, imu=args.imu, gps=args.gps,
                       sensor=args.sensor)
    for i, r in enumerate(replay_bag(runner, bag, topics)):
        print(f"scan {i:4d}  pose={np.round(r.pose, 3)}  "
              f"kf={int(r.is_keyframe)}  inliers={r.num_inliers}")
    if args.save_map:
        res = runner.save_map(args.save_map, resolution=0.4)
        print("saved:", res.files)
    return 0


if __name__ == "__main__":
    sys.exit(main())
