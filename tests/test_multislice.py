"""Multi-slice (2D 'slice' x 'data' mesh) tests on the 8-way virtual mesh:
the host-staged solver and mesh-wide registration must match the single-device
reference implementations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lio_slam_tpu.config import RegistrationConfig
from lio_slam_tpu.graph import factors as F
from lio_slam_tpu.graph import solver
from lio_slam_tpu.parallel import multislice as ms
from lio_slam_tpu.utils import se3


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return ms.make_multislice_mesh(2, 4)


def chain_graph(K=16, cap=16, seed=0):
    """Noisy odometry chain with a GPS factor sprinkle."""
    rs = np.random.RandomState(seed)
    true = np.zeros((cap, 6), np.float32)
    for i in range(1, K):
        true[i] = true[i - 1]
        true[i, 3] += 1.0
        true[i, 4] += 0.1 * np.sin(i)
    g = F.empty_graph(cap, max_between=cap, max_gps=cap)
    noisy = true + np.concatenate(
        [rs.randn(cap, 3) * 0.01, rs.randn(cap, 3) * 0.05], 1).astype(np.float32)
    noisy[0] = true[0]
    g = g._replace(
        poses=jnp.asarray(noisy),
        pose_mask=jnp.asarray(np.arange(cap) < K),
        prior_pose=jnp.asarray(true[0]),
        prior_info=F.info_from_variances((1e-2,) * 3 + (1e-2,) * 3),
    )
    bt_i = np.arange(cap, dtype=np.int32)
    bt_j = np.minimum(bt_i + 1, cap - 1)
    meas = np.stack([np.asarray(se3.pose6_between(
        jnp.asarray(true[i]), jnp.asarray(true[min(i + 1, cap - 1)])))
        for i in range(cap)])
    g = g._replace(
        bt_i=jnp.asarray(bt_i), bt_j=jnp.asarray(bt_j),
        bt_meas=jnp.asarray(meas),
        bt_info=jnp.tile(F.info_from_variances((1e-4,) * 3 + (1e-2,) * 3)[None],
                         (cap, 1)),
        bt_mask=jnp.asarray(bt_i + 1 < K))
    gps_i = np.arange(cap, dtype=np.int32)
    g = g._replace(
        gps_i=jnp.asarray(gps_i),
        gps_meas=jnp.asarray(true[:, 3:] + rs.randn(cap, 3).astype(np.float32) * 0.02),
        gps_info=jnp.full((cap, 3), 25.0, jnp.float32),
        gps_mask=jnp.asarray((gps_i % 4 == 0) & (gps_i < K)))
    return g, jnp.asarray(true)


def test_multislice_mesh_axes(mesh):
    assert mesh.axis_names == ("slice", "data")
    assert mesh.devices.shape == (2, 4)


def test_multislice_solver_matches_reference(mesh):
    g, true = chain_graph()
    active = g.pose_mask

    ref = solver.solve(g, active, iterations=3).graph
    got = ms.make_multislice_solver(mesh)(g, active, iterations=3)

    np.testing.assert_allclose(np.asarray(got.poses)[np.asarray(active)],
                               np.asarray(ref.poses)[np.asarray(active)],
                               rtol=1e-4, atol=1e-4)
    # and it actually moved toward the truth
    err0 = np.abs(np.asarray(g.poses) - np.asarray(true))[np.asarray(active)].max()
    err1 = np.abs(np.asarray(got.poses) - np.asarray(true))[np.asarray(active)].max()
    assert err1 < err0 * 0.5


def test_multislice_register_converges(mesh):
    rs = np.random.RandomState(1)
    n_map, n_scan = 4096, 512
    u = lambda n, lo, hi: rs.uniform(lo, hi, n).astype(np.float32)
    npl = n_map // 4
    world = np.concatenate([
        np.stack([u(2 * npl, -20, 20), u(2 * npl, -20, 20),
                  np.zeros(2 * npl, np.float32)], 1),
        np.stack([np.full(npl, 15.0, np.float32),
                  u(npl, -20, 20), u(npl, 0, 6)], 1),
        np.stack([u(npl, -20, 20), np.full(npl, -12.0, np.float32),
                  u(npl, 0, 6)], 1),
    ]) + rs.randn(n_map, 3).astype(np.float32) * 0.005
    scan_world = world[rs.choice(n_map, n_scan, replace=False)]
    true_pose = jnp.asarray(np.array([0.02, -0.01, 0.03, 0.2, -0.1, 0.05],
                                     np.float32))
    R, t = se3.pose6_to_Rt(true_pose)
    scan_body = se3.transform_points(R.T, -R.T @ t, jnp.asarray(scan_world))

    cfg = RegistrationConfig(max_iterations=10, degeneracy_eig_thresh=1.0)
    register = ms.make_multislice_register(mesh, cfg)
    res = register(scan_body, jnp.ones(n_scan, bool), jnp.asarray(world),
                   jnp.ones(n_map, bool), jnp.zeros(6))
    np.testing.assert_allclose(np.asarray(res.pose), np.asarray(true_pose),
                               atol=0.02)


def test_psum_staged_equals_full_psum(mesh):
    from functools import partial
    from jax.sharding import PartitionSpec as P

    x = jnp.arange(8.0)

    @partial(jax.shard_map, mesh=mesh, in_specs=P(("slice", "data")),
             out_specs=P(), check_vma=False)
    def staged(v):
        return ms.psum_staged(jnp.sum(v))

    @partial(jax.shard_map, mesh=mesh, in_specs=P(("slice", "data")),
             out_specs=P(), check_vma=False)
    def flat(v):
        return jax.lax.psum(jnp.sum(v), ("slice", "data"))

    assert float(staged(x)) == float(flat(x)) == 28.0
