"""Sharded frame pipeline: data-parallel feature extraction + halo exchange.

Device-level counterpart of the reference's process-level parallelism
(SURVEY.md section 2.4):

* ``BatchPreprocess.py:157,215-225`` (10 worker processes over frame shards)
  -> ``make_batched_feature_extractor``: one jitted, vmapped program whose
  frame axis is sharded over the mesh's ``"data"`` axis.  Each chip processes
  its frames; no IPC, no Manager lists.
* ``PoseEstimation.py:221-245`` (producer/consumer pipeline) -> the same
  extractor double-buffers via XLA's async dispatch: the host enqueues batch
  k+1 while batch k computes.
* The refinement back end's keyframe-span partitioning (the framework's
  sequence-parallel analog) -> ``neighbor_pose_exchange``: a ``shard_map``
  with ``ppermute`` halo exchange of boundary poses so each device can form
  cross-shard relative-pose constraints, and ``psum`` for global residuals.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import PipelineConfig
from ..frontend.registration import extract_frame_features


def make_batched_feature_extractor(mesh: Mesh,
                                   cfg: PipelineConfig = PipelineConfig()):
    """Returns ``fn(respond_params, encoder_params, pts, mask)`` where
    ``pts`` is ``(B, N, 4)`` and ``mask`` ``(B, N)``, with B sharded over
    the mesh's 'data' axis.  Output FrameFeatures have leading axis B with
    the same sharding."""
    vm = jax.vmap(
        lambda rp, ep, p, m: extract_frame_features(rp, ep, p, m, cfg),
        in_axes=(None, None, 0, 0),
    )
    data = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    return jax.jit(
        vm, in_shardings=(rep, rep, data, data), out_shardings=data
    )


def make_sequence_processor(cfg: PipelineConfig = PipelineConfig(),
                            with_refine: bool = False):
    """ONE jitted call for a whole frame window: batched feature extraction
    (vmap over frames) + batched consecutive-pair registration (vmap over
    pairs).  This is the production throughput path: driving the pipeline
    frame-by-frame (reference style, ``PoseEstimation.py:241-268``) pays a
    host dispatch per stage per frame; one window program pays one per
    window.

    Returns ``fn(respond_params, encoder_params, pts (B,N,4), mask (B,N),
    key) -> (FrameFeatures batch, PairRegistration batch over B-1 pairs)``,
    or with ``with_refine=True`` ``-> (FrameFeatures, RefinementFeatures,
    PairRegistration)`` — the refinement features come from the same
    projection/respond/NMS results, so the refinement back end never pays a
    second front-end pass (the reference's ``KeyPts/*.mat`` save-once
    contract, ``BatchPreprocess.py:119-152``).
    """
    from ..frontend.registration import (extract_frame_features_full,
                                         register_pair,
                                         register_pair_with_prior)

    def process(respond_params, encoder_params, pts, mask, key):
        # Windows beyond 16 frames chunk the per-frame extraction through
        # lax.map so the scale-0 bit table (~84 MB/frame live inside one
        # frame's extraction) is bounded by the chunk, not the window —
        # this is what restores the 64-frame window the r3 table design
        # could not compile.  At <=16 frames a plain vmap (one fused
        # program, no sequencing) is used.
        B0 = pts.shape[0]
        chunk = 16

        def mapped(fn):
            if B0 <= chunk:
                return jax.vmap(fn)(pts, mask)
            pad = (-B0) % chunk
            pp = jnp.concatenate([pts, pts[:pad]]) if pad else pts
            mm = jnp.concatenate([mask, mask[:pad]]) if pad else mask
            n_ch = pp.shape[0] // chunk
            out = jax.lax.map(
                lambda ab: jax.vmap(fn)(*ab),
                (pp.reshape((n_ch, chunk) + pp.shape[1:]),
                 mm.reshape((n_ch, chunk) + mm.shape[1:])),
            )
            return jax.tree.map(
                lambda x: x.reshape((n_ch * chunk,) + x.shape[2:])[:B0], out)

        if with_refine:
            feats, ref_feats = mapped(
                lambda p, m: extract_frame_features_full(
                    respond_params, encoder_params, p, m, cfg
                ))
        else:
            feats = mapped(
                lambda p, m: extract_frame_features(
                    respond_params, encoder_params, p, m, cfg
                ))
            ref_feats = None
        B = pts.shape[0]
        f0 = jax.tree.map(lambda x: x[:-1], feats)
        f1 = jax.tree.map(lambda x: x[1:], feats)
        keys = jax.random.split(key, B - 1)
        regs = jax.vmap(lambda k, a, b: register_pair(k, a, b, cfg))(
            keys, f0, f1
        )
        if cfg.prior_gate_m > 0.0:
            # motion-prior fallback pass: pair k retries with pair k-1's
            # pass-1 result as a constant-velocity prior (identity for the
            # window's first pair / after a failure).  Selected only where
            # pass 1 failed, so results can only improve.  The whole pass
            # sits under a lax.cond so the (common) all-success window pays
            # nothing at runtime — XLA executes only the taken branch.
            def retry(regs):
                eye = jnp.broadcast_to(jnp.eye(3, dtype=regs.R.dtype),
                                       regs.R[:1].shape)
                zero = jnp.zeros_like(regs.t[:1])
                ok_prev = regs.success[:-1]
                prior_R = jnp.concatenate([eye, jnp.where(
                    ok_prev[:, None, None], regs.R[:-1], eye)], axis=0)
                prior_t = jnp.concatenate([zero, jnp.where(
                    ok_prev[:, None], regs.t[:-1], zero)], axis=0)
                keys2 = jax.vmap(jax.random.fold_in)(
                    keys, jnp.ones((B - 1,), jnp.uint32))
                regs2 = jax.vmap(
                    lambda k, a, b, pR, pt: register_pair_with_prior(
                        k, a, b, pR, pt, cfg)
                )(keys2, f0, f1, prior_R, prior_t)
                use2 = (~regs.success) & regs2.success
                return jax.tree.map(
                    lambda rt, first: jnp.where(
                        use2.reshape((-1,) + (1,) * (rt.ndim - 1)),
                        rt, first),
                    regs2, regs,
                )

            regs = jax.lax.cond(jnp.all(regs.success),
                                lambda r: r, retry, regs)
        if with_refine:
            return feats, ref_feats, regs
        return feats, regs

    return jax.jit(process)


def make_sharded_icp_fn(features, mesh: Mesh,
                        cfg: PipelineConfig = PipelineConfig(),
                        spans_per_device: int = 4):
    """Mesh-sharded drop-in for ``refine_runner.make_batched_icp_fn``:
    the keyframe-span hybrid-ICP solves of ``refine.refine_odometry_batched``
    with the span axis sharded over the mesh's ``'data'`` axis.

    Spans within one Jacobi pass are independent (the framework's
    context-parallel analog — SURVEY section 2.4 final row: keyframe-span /
    map-block partitioning vs the reference's 10-process frame sharding,
    ``BatchPreprocess.py:157,215-225``), so each device solves its span
    shard against the replicated feature stack; the cheap accept/propagate
    chain (and its cross-shard pose dependencies) stays host-side float64,
    fed by ``neighbor_pose_exchange``-style halo semantics — every accepted
    span correction only needs the span's OWN endpoints' relative pose,
    which the host already holds.

    Produces bit-identical results to the single-device batched path: the
    per-span ICP computation does not cross the sharded axis.

    Args:
      features: stacked ``RefinementFeatures`` pytree (leading axis
        n_frames) or a list of per-frame pytrees.
      spans_per_device: static span batch per device per call (pads the
        last call; one compile regardless of trajectory length).
    """
    from ..backend.refine_runner import refine_pair, stack_features

    feats = stack_features(features, range(
        len(features))) if isinstance(features, list) else features
    n_dev = mesh.shape["data"]
    S = n_dev * spans_per_device
    data = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    solve = jax.jit(
        lambda f, ii, jj, rR, rT, ts: (
            lambda res: (res.R, res.t, res.success, res.init_res,
                         res.final_res)
        )(jax.vmap(lambda a, b, R, t: refine_pair(a, b, R, t, cfg,
                                                  thr_scale=ts))(
            jax.tree.map(lambda x: x[ii], f),
            jax.tree.map(lambda x: x[jj], f), rR, rT)),
        in_shardings=(rep, data, data, data, data, rep),
        out_shardings=(data, data, data, data, data),
    )

    import numpy as np

    def batched(idx_i, idx_j, relRs, relTs, thr_scale=1.0):
        n = len(idx_i)
        dRs = np.zeros((n, 3, 3))
        dts = np.zeros((n, 3))
        oks = np.zeros((n,), bool)
        r0s = np.zeros((n,))
        r1s = np.zeros((n,))
        for s in range(0, n, S):
            sel = slice(s, min(s + S, n))
            k = sel.stop - sel.start
            pad = S - k
            ii = np.concatenate([idx_i[sel], np.repeat(idx_i[sel][-1:], pad)])
            jj = np.concatenate([idx_j[sel], np.repeat(idx_j[sel][-1:], pad)])
            rR = np.concatenate(
                [relRs[sel], np.repeat(relRs[sel][-1:], pad, axis=0)]
            ).astype(np.float32)
            rT = np.concatenate(
                [relTs[sel], np.repeat(relTs[sel][-1:], pad, axis=0)]
            ).astype(np.float32)
            R, t, ok, r0, r1 = solve(feats, jnp.asarray(ii, jnp.int32),
                                     jnp.asarray(jj, jnp.int32),
                                     jnp.asarray(rR), jnp.asarray(rT),
                                     jnp.float32(thr_scale))
            dRs[sel] = np.asarray(R, np.float64)[:k]
            dts[sel] = np.asarray(t, np.float64)[:k]
            oks[sel] = np.asarray(ok)[:k]
            r0s[sel] = np.asarray(r0, np.float64)[:k]
            r1s[sel] = np.asarray(r1, np.float64)[:k]
        return dRs, dts, oks, r0s, r1s

    return batched


def make_sharded_sc_correlation(mesh: Mesh):
    """Row-sharded ScanContext correlation matrix
    (``backend.scancontext.sc_correlation_matrix`` with the query-frame
    axis sharded over ``'data'``).

    Each device owns a contiguous block of query frames and correlates it
    against the full (replicated) signature stack — the loop-closure
    candidate search's multi-chip path (the (N, N) x S-shift search is the
    loop stage's FLOP hot spot at sequence scale; rows are independent, so
    the shard needs no collectives and is bit-identical to the
    single-device result).  N must be divisible by the mesh's 'data' size
    (pad with zero signatures; their rows score 0 against everything).

    Returns ``fn(scs (N, R, S)) -> (score (N, N), yaw (N, N))``.
    """

    def block(rows, full):
        n_loc = rows.shape[0]
        N, R, S = full.shape
        flat_r = rows.reshape(n_loc, R * S)
        inv_r = 1.0 / jnp.maximum(jnp.linalg.norm(flat_r, axis=1), 1e-9)
        A = flat_r * inv_r[:, None]
        flat_f = full.reshape(N, R * S)
        inv_f = 1.0 / jnp.maximum(jnp.linalg.norm(flat_f, axis=1), 1e-9)

        def body(s, carry):
            best, best_s = carry
            Bs = (jnp.roll(full, -s, axis=-1).reshape(N, R * S)
                  * inv_f[:, None])
            sim = jnp.dot(A, Bs.T, preferred_element_type=jnp.float32)
            upd = sim > best
            return jnp.where(upd, sim, best), jnp.where(upd, s, best_s)

        best, best_s = jax.lax.fori_loop(
            0, S, body,
            (jnp.full((n_loc, N), -jnp.inf, jnp.float32),
             jnp.zeros((n_loc, N), jnp.int32)))
        yaw = 2.0 * jnp.pi * best_s.astype(jnp.float32) / S
        yaw = jnp.where(yaw > jnp.pi, yaw - 2.0 * jnp.pi, yaw)
        return best, yaw

    sharded = shard_map(
        lambda rows, full: block(rows, full),
        mesh=mesh, in_specs=(P("data"), P()),
        out_specs=(P("data"), P("data")), check_vma=False)
    return jax.jit(lambda scs: sharded(scs, scs))


def neighbor_pose_exchange(mesh: Mesh):
    """shard_map halo exchange over keyframe spans.

    Each device owns a contiguous span of poses ``(K, 12)``; the step sends
    its last pose to the right neighbor (``ppermute`` ring) so every device
    can evaluate the chain constraint spanning the shard boundary, and
    returns the globally ``psum``-ed squared chain residual — the primitive
    the distributed refinement solver builds on.
    """
    axis = "data"

    def step(poses):
        n = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        # send my last pose to my right neighbor; receive left neighbor's
        perm = [(i, (i + 1) % n) for i in range(n)]
        left_last = jax.lax.ppermute(poses[-1], axis, perm)
        # chain residual: ||pose_k - pose_{k-1}|| within the shard, plus the
        # boundary term vs the halo pose (masked out on device 0)
        intra = jnp.sum((poses[1:] - poses[:-1]) ** 2)
        boundary = jnp.sum((poses[0] - left_last) ** 2)
        boundary = jnp.where(idx == 0, 0.0, boundary)
        total = jax.lax.psum(intra + boundary, axis)
        return total, left_last

    return shard_map(
        step,
        mesh=mesh,
        in_specs=P("data"),
        out_specs=(P(), P("data")),
        check_vma=False,
    )
