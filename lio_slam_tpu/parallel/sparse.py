"""Distributed SPARSE pose-graph solve: factor-sharded block-tridiagonal
assembly + column-sharded Woodbury — the production-scale distributed BA.

Round-3's distributed solvers assembled a dense (K, K, 6, 6) Hessian per
device (~600 MB at the default K=2048 — unusable at exactly the scale where
`graph/sparse.py` is the selected backend).  This module is the sharded
version of that sparse factorization (round-3 verdict missing #2 / next #3):

- each device linearizes its CONTIGUOUS shard of the odometry chain (and of
  the GPS unaries) into per-keyframe diagonal D (K,6,6) / subdiagonal Loff
  (K,6,6) blocks and gradient b (K,6) — O(K·36) per device, never O(K²);
- one `psum` (staged within-slice first on a 2D mesh) reduces the block arrays;
- the block-tridiagonal LDLᵀ factorization runs replicated (O(K) sequential
  6×6 chain — latency-bound, nothing to shard);
- the Woodbury loop correction's heavy part, Y = T⁻¹Aᵀ with 6L right-hand
  sides, is SHARDED over its columns: each device back-substitutes its
  column chunk, computes its S-columns, and the small (6L)² S solve is
  replicated.  Loop factors themselves are linearized replicated (L ≤
  `max_loop_queue`·8 — tiny by construction).

Semantics match `graph.sparse.solve_sparse` (same equilibration, damping,
masking); `tests/test_parallel_sparse.py` asserts 1e-4 parity at K=2048 on
the virtual 8-device mesh, and `__graft_entry__.dryrun_multichip` runs it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from lio_slam_tpu.graph import factors as F
from lio_slam_tpu.graph import sparse as sp
from lio_slam_tpu.graph.solver import SolveResult, _equilibrated_cholesky_solve
from lio_slam_tpu.utils import se3


def _psum_axes(x, axes):
    """Reduce over mesh axes innermost-first ('data' before 'slice' on a
    ('slice', 'data') mesh — multislice.psum_staged semantics)."""
    for ax in reversed(axes):
        x = jax.lax.psum(x, ax)
    return x


def _pad_to(arr, n):
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr[:n]
    return jnp.concatenate(
        [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)


def make_sharded_sparse_solver(mesh: Mesh, axes=("data",)):
    """Returns solve(graph, iterations) — drop-in for
    `graph.sparse.solve_sparse` with assembly + Woodbury sharded over the
    mesh axes (1D ('data',) or 2D ('slice', 'data'))."""
    n_dev = 1
    for ax in axes:
        n_dev *= mesh.shape[ax]
    spec_sh = P(axes if len(axes) > 1 else axes[0])
    spec_sh2 = P(axes if len(axes) > 1 else axes[0], None)

    # ---- sharded chain/GPS assembly -> psum'd (D, Loff, b) ----

    def _local_chain(poses, bt_i, bt_j, bt_meas, bt_info, bt_mask):
        """Per-device: linearize a chain-factor shard, scatter into global
        (K,6,6)/(K,6) block arrays.  bt_j == bt_i + 1 by chain layout, so
        Loff[bt_i] (= T[i+1, i]) collects the off-diagonal block."""
        K = poses.shape[0]
        dtype = poses.dtype

        def one(pi, pj, meas):
            e = F.between_error(pi, pj, F.Z6(), F.Z6(), meas)
            Ji = F._between_jac_i(pi, pj, F.Z6(), F.Z6(), meas)
            Jj = F._between_jac_j(pi, pj, F.Z6(), F.Z6(), meas)
            return e, Ji, Jj

        eb, Ji, Jj = jax.vmap(one)(poses[bt_i], poses[bt_j], bt_meas)
        # chain-layout guard (round-4 advisor): the tridiagonal structure can
        # only represent couplings between ADJACENT keyframes — a factor in
        # the chain region with bt_j != bt_i+1 would scatter its off-diagonal
        # block to slot bt_i (= T[bt_i+1, bt_i]) and silently corrupt the
        # solve.  Drop such factors entirely (non-chain topology belongs in
        # the loop region, whose low-rank path handles arbitrary endpoints).
        chain_ok = bt_j == bt_i + 1
        w = bt_info * (bt_mask & chain_ok)[:, None]
        D = jnp.zeros((K, 6, 6), dtype)
        Loff = jnp.zeros((K, 6, 6), dtype)
        b = jnp.zeros((K, 6), dtype)
        D = D.at[bt_i].add(jnp.einsum("bri,br,brj->bij", Ji, w, Ji))
        D = D.at[bt_j].add(jnp.einsum("bri,br,brj->bij", Jj, w, Jj))
        Loff = Loff.at[bt_i].add(jnp.einsum("bri,br,brj->bij", Jj, w, Ji))
        b = b.at[bt_i].add(-jnp.einsum("bri,br,br->bi", Ji, w, eb))
        b = b.at[bt_j].add(-jnp.einsum("bri,br,br->bi", Jj, w, eb))
        chi2 = jnp.sum(w * eb * eb)
        return D, Loff, b, chi2

    def _local_gps(poses, gps_i, gps_meas, gps_info, gps_mask):
        K = poses.shape[0]
        dtype = poses.dtype

        def one(pi, meas):
            e = F.gps_error(pi, F.Z6(), meas)
            J = F._gps_jac(pi, F.Z6(), meas)
            return e, J

        eg, Jg = jax.vmap(one)(poses[gps_i], gps_meas)
        w = gps_info * gps_mask[:, None]
        D = jnp.zeros((K, 6, 6), dtype)
        b = jnp.zeros((K, 6), dtype)
        D = D.at[gps_i].add(jnp.einsum("gri,gr,grj->gij", Jg, w, Jg))
        b = b.at[gps_i].add(-jnp.einsum("gri,gr,gr->gi", Jg, w, eg))
        chi2 = jnp.sum(w * eg * eg)
        return D, b, chi2

    assemble_sh = partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), spec_sh, spec_sh, spec_sh2, spec_sh2, spec_sh,
                  spec_sh, spec_sh2, spec_sh2, spec_sh),
        out_specs=(P(), P(), P(), P()),
        check_vma=False)

    @assemble_sh
    def _assemble_shards(poses, ci, cj, cm, cw, cmask, gi, gm, gw, gmask):
        D1, Loff, b1, x1 = _local_chain(poses, ci, cj, cm, cw, cmask)
        D2, b2, x2 = _local_gps(poses, gi, gm, gw, gmask)
        return _psum_axes((D1 + D2, Loff, b1 + b2, x1 + x2), axes)

    # ---- column-sharded Woodbury: Y = T^-1 A^T over 6L rhs columns ----

    def _woodbury_sharded(f: sp.TridiagFactor, loops, tb):
        li, lj, Jli, Jlj, wl, lmask, nL = loops
        if nL == 0:
            return tb
        K = f.chols.shape[0]
        dtype = tb.dtype
        M = nL * 6
        # pad columns to a multiple of the device count
        Mp = ((M + n_dev - 1) // n_dev) * n_dev

        def a_apply_with(x, li_, lj_, Jli_, Jlj_, lmask_):
            xi = x[li_]
            xj = x[lj_]
            rows = (jnp.einsum("lrs,ls...->lr...", Jli_, xi)
                    + jnp.einsum("lrs,ls...->lr...", Jlj_, xj))
            rows = rows * (lmask_[:, None, None] if rows.ndim == 3
                           else lmask_[:, None])
            return rows.reshape((M,) + rows.shape[2:])

        def a_apply(x):
            return a_apply_with(x, li, lj, Jli, Jlj, lmask)

        def with_loops(tb):
            At = jnp.zeros((K, 6, nL, 6), dtype)
            At = At.at[li, :, jnp.arange(nL), :].add(
                jnp.swapaxes(Jli, -1, -2) * lmask[:, None, None])
            At = At.at[lj, :, jnp.arange(nL), :].add(
                jnp.swapaxes(Jlj, -1, -2) * lmask[:, None, None])
            At = At.reshape(K, 6, M)
            At = jnp.concatenate(
                [At, jnp.zeros((K, 6, Mp - M), dtype)], axis=-1)

            # each device back-substitutes its column chunk of Y = T^-1 A^T
            # and computes its columns of A Y; columns re-join by all_gather
            ax1 = axes if len(axes) > 1 else axes[0]
            col_sh = P(None, None, ax1)

            @partial(jax.shard_map, mesh=mesh,
                     in_specs=(P(), P(), P(), col_sh, P(), P(), P(), P(), P()),
                     out_specs=(col_sh, P(None, ax1)),
                     check_vma=False)
            def y_chunks(chols, Lm, scale, At_chunk, li_, lj_, Jli_, Jlj_,
                         lmask_):
                fl = sp.TridiagFactor(chols=chols, Lm=Lm, scale=scale)
                Y = sp.tridiag_solve(fl, At_chunk)           # (K, 6, Mp/n)
                return Y, a_apply_with(Y, li_, lj_, Jli_, Jlj_, lmask_)

            Y, AY = y_chunks(f.chols, f.Lm, f.scale, At, li, lj, Jli, Jlj,
                             lmask)
            AY = AY[:, :M]
            winv = jnp.where(lmask[:, None],
                             1.0 / jnp.maximum(wl, 1e-12), sp._BIG)
            S = AY + jnp.diag(winv.reshape(-1))
            Atb = a_apply(tb)
            corr = _equilibrated_cholesky_solve(S, Atb)
            corr_p = jnp.concatenate(
                [corr, jnp.zeros(Mp - M, dtype)])
            # correction = Y @ corr, reduced over the sharded column axis
            spec_c = P(axes if len(axes) > 1 else axes[0])

            @partial(jax.shard_map, mesh=mesh,
                     in_specs=(col_sh, spec_c),
                     out_specs=P(),
                     check_vma=False)
            def apply_corr(Y_chunk, corr_chunk):
                part = jnp.einsum("ksl,l->ks", Y_chunk, corr_chunk)
                return _psum_axes(part, axes)

            return tb - apply_corr(Y, corr_p)

        return jax.lax.cond(jnp.any(lmask), with_loops, lambda t: t, tb)

    # ---- full GN solve (mirrors graph.sparse.solve_sparse) ----

    @partial(jax.jit, static_argnames=("iterations",))
    def solve(graph: F.PoseGraph, iterations: int = 5) -> SolveResult:
        K = graph.poses.shape[0]
        B = graph.bt_i.shape[0]
        c = K - 1
        nL = B - c
        dtype = graph.poses.dtype
        cp = ((c + n_dev - 1) // n_dev) * n_dev        # padded chain size
        Gn = graph.gps_i.shape[0]
        gp = ((Gn + n_dev - 1) // n_dev) * n_dev

        def step(_, carry):
            g, _, _ = carry
            # chain shard arrays (padded; pad slots carry mask=False)
            ci = _pad_to(g.bt_i[:c], cp)
            cj = _pad_to(g.bt_j[:c], cp)
            cm = _pad_to(g.bt_meas[:c], cp)
            cw = _pad_to(g.bt_info[:c], cp)
            cmask = _pad_to(g.bt_mask[:c], cp)
            gi = _pad_to(g.gps_i, gp)
            gm = _pad_to(g.gps_meas, gp)
            gw = _pad_to(g.gps_info, gp)
            gmask = _pad_to(g.gps_mask, gp)
            D, Loff, b, chi2 = _assemble_shards(
                g.poses, ci, cj, cm, cw, cmask, gi, gm, gw, gmask)

            # prior on pose 0 (single factor — replicated)
            e0, J0 = F.linearize_prior(g)
            w0 = g.prior_info
            D = D.at[0].add(jnp.einsum("ri,r,rj->ij", J0, w0, J0))
            b = b.at[0].add(-J0.T @ (w0 * e0))
            chi2 = chi2 + jnp.sum(w0 * e0 * e0)

            # loop factors: replicated linearization (L is tiny)
            li, lj = g.bt_i[c:], g.bt_j[c:]
            lmask = g.bt_mask[c:]

            def one(pi, pj, meas):
                e = F.between_error(pi, pj, F.Z6(), F.Z6(), meas)
                Ji = F._between_jac_i(pi, pj, F.Z6(), F.Z6(), meas)
                Jj = F._between_jac_j(pi, pj, F.Z6(), F.Z6(), meas)
                return e, Ji, Jj

            el, Jli, Jlj = jax.vmap(one)(g.poses[li], g.poses[lj],
                                         g.bt_meas[c:])
            wl = g.bt_info[c:] * lmask[:, None]
            b = b.at[li].add(-jnp.einsum("lri,lr,lr->li", Jli, wl, el))
            b = b.at[lj].add(-jnp.einsum("lri,lr,lr->li", Jlj, wl, el))
            chi2 = chi2 + jnp.sum(wl * el * el)

            # inactive poses: identity diagonal, decoupled (sparse._assemble)
            act = g.pose_mask.astype(dtype)
            D = D * act[:, None, None]
            D = D + jnp.eye(6, dtype=dtype)[None] * (1.0 - act)[:, None, None]
            act_next = jnp.concatenate([act[1:], jnp.zeros(1, dtype)])
            Loff = Loff * (act * act_next)[:, None, None]
            b = b * act[:, None]

            f = sp.tridiag_factor(D, Loff)
            tb = sp.tridiag_solve(f, b)
            loops = (li, lj, Jli, Jlj, wl, lmask, nL)
            delta = _woodbury_sharded(f, loops, tb)
            delta = jnp.where(g.pose_mask[:, None], delta, 0.0)
            # backtracking step control, replicated (O(B) errors-only cost
            # evals — negligible vs the solve; see sparse.backtrack_step)
            new_poses, scale = sp.backtrack_step(g, delta, chi2)
            g2 = g._replace(poses=new_poses)
            return (g2, jnp.linalg.norm(delta) * scale, chi2)

        g, dn, chi2 = jax.lax.fori_loop(
            0, iterations, step,
            (graph, jnp.zeros((), graph.poses.dtype),
             jnp.zeros((), graph.poses.dtype)))
        return SolveResult(graph=g, delta_norm=dn, chi2=chi2)

    return solve
