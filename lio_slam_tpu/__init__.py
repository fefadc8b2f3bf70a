"""lio_slam_tpu — a LiDAR-inertial SLAM engine written in JAX.

A ground-up re-design (JAX / XLA / Pallas / pjit) of the capabilities of the
reference system (JiLiBIT/LIO-SLAM, a ROS1/C++ LIO-SAM fork):

- scan deskew via IMU rotation integration
- scan-to-map point-to-plane registration (Gauss-Newton, degeneracy handling)
- keyframe pose graph with odometry / GPS / loop factors
- IMU preintegration with online bias estimation
- loop closure (radius search + Scan Context) with submap ICP
- GPS/ENU fusion with a positioning-health state machine
- map products: global map export, rolling local map, 2.5D height map

Design stance (vs the reference's 4-process ROS pipeline):
- one SPMD JAX program per scan step; fixed-shape masked tensors
- voxel-bucket / tiled-matmul correspondence search instead of kd-trees
- batched Gauss-Newton pose-graph solver instead of GTSAM iSAM2
- `lax.scan` IMU preintegration; error-state fusion for the IMU front-end
- keyframe / map state shardable over a `jax.sharding.Mesh`
"""

__version__ = "0.1.0"

import jax as _jax

# float32 matmuls everywhere: geometry needs ~1e-6 relative precision
# (meter-scale coordinates; a 512-step rotation chain drifts ~20% and the GN
# normal equations go NaN at bfloat16).  On an NVIDIA GPU this setting is
# also what keeps cuBLAS from running float32 products in TF32, which keeps
# only 10 mantissa bits.  Kernels that can safely use less precision (none
# of the geometric ones) opt in via `precision=` at the call site.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent compilation cache: the mapping step, the full correction and
# the loop detector are large XLA programs, so replays, tests and benchmarks
# reuse compiled executables across processes.  `JAX_COMPILATION_CACHE_DIR`
# wins when set (JAX reads it itself); otherwise the cache sits at a fixed
# path inside the checkout (`.jax_cache`, gitignored).
import os as _os

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from lio_slam_tpu import config as config  # noqa: F401
