"""Tests that need an NVIDIA GPU.

They skip elsewhere through the `gpu` fixture; `chip_smoke.py` runs them in
its own process on the card (phase 5):

    python chip_smoke.py
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
    return dev


def test_float32_matmul_is_not_tf32(gpu):
    """The package's matmul precision keeps cuBLAS off TF32: a product
    whose 2**-11 terms TF32 would drop comes out exact."""
    import chip_smoke
    assert chip_smoke.precision_probe() == 1024.5


def test_plain_normal_equations_match_float64_reference(gpu):
    """find_correspondences + _normal_equations compiled for the card
    against the float64 reference, at a reduced width."""
    import chip_smoke
    from lio_slam_tpu.config import RegistrationConfig
    p = chip_smoke.parity(RegistrationConfig(), 4096, 32768, 8192)
    chip_smoke.check_parity(p)
    assert p["inliers"] > 1000


def test_float64_marginal_covariance_on_card(gpu):
    """The GPS gate's marginal covariance runs in float64 inside jit on the
    card: at the end of a chain anchored only by the 1e8 m² translation
    prior it reads far above the 25 m² gate (float32 read about 0.6 m²)."""
    import jax
    import jax.numpy as jnp
    from lio_slam_tpu.graph import factors as F
    from lio_slam_tpu.graph import sparse
    K = 256
    g = F.empty_graph(K, K - 1, 8)
    meas = np.tile(np.array([0, 0, 0, 1.0, 0, 0], np.float32), (K - 1, 1))
    poses = np.zeros((K, 6), np.float32)
    poses[:, 3] = np.arange(K)
    g = g._replace(
        poses=jnp.asarray(poses), pose_mask=jnp.ones(K, bool),
        prior_info=F.info_from_variances((1e-2, 1e-2, np.pi ** 2, 1e8, 1e8,
                                          1e8)),
        bt_i=jnp.arange(K - 1, dtype=jnp.int32),
        bt_j=jnp.arange(1, K, dtype=jnp.int32), bt_meas=jnp.asarray(meas),
        bt_info=jnp.tile(F.info_from_variances((1e-6,) * 3 + (1e-4,) * 3),
                         (K - 1, 1)),
        bt_mask=jnp.ones(K - 1, bool))
    cov = np.asarray(jax.jit(sparse.marginal_covariance_sparse)(
        g, jnp.int32(K - 1)))
    assert np.isfinite(cov).all()
    assert cov[3, 3] > 1e3 and cov[4, 4] > 1e3          # prior-dominated
