"""Sequence odometry driver: pipelined feature extraction + pose chaining.

The batched-device equivalent of ``PoseEstimation.py``'s producer/consumer
design (``:48-149`` generator process + 4 loader subprocesses feeding a
sequential consumer ``:241-268``): here feature extraction is the expensive
device-parallel part (optionally sharded over a mesh via
``caelo_tpu.parallel.pipeline``) while the pose chain — the only truly
sequential dependency — is cheap host float64 algebra.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..geometry.kitti_pose import chain_poses, lidar_rel_to_cam
from .registration import (FrameFeatures, PairRegistration,
                           extract_frame_features, register_pair,
                           register_pair_with_prior)


@dataclasses.dataclass
class OdometryResult:
    poses: np.ndarray                 # (N, 12) KITTI rows
    rel_Rs: np.ndarray                # (N-1, 3, 3) lidar-frame rels
    rel_ts: np.ndarray                # (N-1, 3)
    successes: np.ndarray             # (N-1,) bool
    n_inliers: np.ndarray             # (N-1,) int
    inlier_pairs: List                # per pair: (idx0, idx1) int arrays
    thresholds: np.ndarray = None     # (N-1,) accepted RANSAC rung (m)


def run_odometry(scans: Iterable, respond_params, encoder_params,
                 R_tr=None, t_tr=None,
                 cfg: PipelineConfig = PipelineConfig(),
                 seed: int = 0,
                 feature_fn: Optional[Callable] = None,
                 progress: Optional[Callable[[int], None]] = None
                 ) -> OdometryResult:
    """Run frame-to-frame odometry over an iterable of (pts, mask) scans.

    On RANSAC failure the reference chains the (bad) estimate anyway and
    relies on the de-jump stage (``RefinePoses.py:233-262``); we instead
    substitute constant-velocity propagation immediately and still record
    the failure for the back end.
    """
    if R_tr is None:
        R_tr = np.eye(3)
    if t_tr is None:
        t_tr = np.zeros(3)
    if feature_fn is None:
        feature_fn = lambda pts, mask: extract_frame_features(
            respond_params, encoder_params, pts, mask, cfg
        )

    key = jax.random.key(seed)
    rel_Rs, rel_ts, succ, n_inl, pairs, ths = [], [], [], [], [], []
    prev_feat: FrameFeatures | None = None
    prevR, prevT = np.eye(3), np.zeros(3)
    for i, (pts, mask) in enumerate(scans):
        feat = feature_fn(pts, mask)
        if prev_feat is not None:
            key, sub = jax.random.split(key)
            reg: PairRegistration = register_pair(sub, prev_feat, feat, cfg)
            ok = bool(reg.success)
            if not ok and cfg.prior_gate_m > 0.0:
                # retry with the constant-velocity motion prior gating the
                # candidate matches (GenerateTrajactory.m:210 semantics)
                key, sub = jax.random.split(key)
                reg = register_pair_with_prior(
                    sub, prev_feat, feat,
                    jnp.asarray(prevR, jnp.float32),
                    jnp.asarray(prevT, jnp.float32), cfg,
                )
                ok = bool(reg.success)
            R = np.asarray(reg.R, np.float64)
            t = np.asarray(reg.t, np.float64)
            if ok and cfg.max_rel_rot_deg > 0:
                # physical-plausibility gate (config.max_rel_rot_deg)
                ang = np.degrees(np.arccos(np.clip(
                    (np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
                if (ang > cfg.max_rel_rot_deg
                        or np.linalg.norm(t) > cfg.max_rel_trans_m):
                    ok = False
            if not ok:
                R, t = prevR, prevT  # constant-velocity fallback
            inl = np.asarray(reg.inlier_mask)
            pairs.append(
                (np.asarray(reg.inlier_idx0)[inl], np.asarray(reg.inlier_idx1)[inl])
            )
            rel_Rs.append(R)
            rel_ts.append(t)
            succ.append(ok)
            n_inl.append(int(reg.n_inliers))
            ths.append(float(reg.threshold))
            prevR, prevT = R, t
        prev_feat = feat
        if progress is not None:
            progress(i)

    rel_Rs = np.array(rel_Rs).reshape(-1, 3, 3)
    rel_ts = np.array(rel_ts).reshape(-1, 3)
    poses = np.asarray(
        chain_poses(rel_Rs, rel_ts, np.asarray(R_tr), np.asarray(t_tr))
    )
    return OdometryResult(
        poses=poses,
        rel_Rs=rel_Rs,
        rel_ts=rel_ts,
        successes=np.array(succ, bool),
        n_inliers=np.array(n_inl, np.int32),
        inlier_pairs=pairs,
        thresholds=np.array(ths, np.float32),
    )


def run_odometry_windowed(scans, respond_params, encoder_params,
                          R_tr=None, t_tr=None,
                          cfg: PipelineConfig = PipelineConfig(),
                          window: int = 16, seed: int = 0,
                          keep_features: bool = False,
                          keep_refine_features: bool = False,
                          progress: Optional[Callable[[int], None]] = None
                          ) -> tuple:
    """Windowed odometry: ONE jitted program per 16-frame window.

    Compiles two programs total (the window processor + nothing else) and
    dispatches once per window — versus one extract + one register dispatch
    per frame in ``run_odometry``.  Frame-to-frame semantics are identical;
    windows overlap by one frame so every consecutive pair is registered.

    Returns ``(OdometryResult, features_or_None)`` where ``features`` is a
    *stacked* ``FrameFeatures`` pytree with leading axis ``n`` (per-frame
    views are one gather away; a list of per-frame pytrees would cost one
    device dispatch per frame per field to build).  With ``keep_refine_features=True`` returns
    ``(OdometryResult, features, refinement_features)`` where the
    refinement features come from the same window program (no second
    front-end pass; the reference's ``KeyPts/*.mat`` save-once contract,
    ``BatchPreprocess.py:119-152``).
    """
    from ..parallel.pipeline import make_sequence_processor

    if R_tr is None:
        R_tr = np.eye(3)
    if t_tr is None:
        t_tr = np.zeros(3)
    # keep disk-backed sequences (data.scancache.NpyScanReader) lazy: the
    # window loop below reads O(window) frames at a time
    if not (hasattr(scans, "__getitem__") and hasattr(scans, "__len__")):
        scans = list(scans)
    n = len(scans)
    assert n >= 2
    keep_features = keep_features or keep_refine_features
    process = make_sequence_processor(cfg, with_refine=keep_refine_features)
    key = jax.random.key(seed)

    rel_Rs = np.zeros((n - 1, 3, 3))
    rel_ts = np.zeros((n - 1, 3))
    succ = np.zeros((n - 1,), bool)
    n_inl = np.zeros((n - 1,), np.int32)
    ths = np.zeros((n - 1,), np.float32)
    pairs: List = [None] * (n - 1)
    feat_windows: List = []      # (first_kept_j, n_kept, stacked pytree)
    ref_windows: List = []

    def consume(start, idx, feats, ref_feats, regs):
        """Pull one window's results to host — ONE fetch per field (not one
        per pair: a per-element ``np.asarray(regs.R[k])`` costs a device
        slice dispatch + fetch round-trip per pair)."""
        n_real_pairs = len(idx) - 1
        R_all = np.asarray(regs.R, np.float64)
        t_all = np.asarray(regs.t, np.float64)
        s_all = np.asarray(regs.success)
        ni_all = np.asarray(regs.n_inliers)
        th_all = np.asarray(regs.threshold)
        inl_mask = np.asarray(regs.inlier_mask)
        idx0 = np.asarray(regs.inlier_idx0)
        idx1 = np.asarray(regs.inlier_idx1)
        for k in range(n_real_pairs):
            g = start + k
            rel_Rs[g] = R_all[k]
            rel_ts[g] = t_all[k]
            ok = bool(s_all[k])
            if ok and cfg.max_rel_rot_deg > 0:
                # physical-plausibility gate (config.max_rel_rot_deg): a
                # per-pair motion impossible at scan rate is an aliased
                # consensus, not a success
                ang = np.degrees(np.arccos(np.clip(
                    (np.trace(R_all[k]) - 1.0) / 2.0, -1.0, 1.0)))
                if (ang > cfg.max_rel_rot_deg
                        or np.linalg.norm(t_all[k]) > cfg.max_rel_trans_m):
                    ok = False
            succ[g] = ok
            n_inl[g] = int(ni_all[k])
            ths[g] = float(th_all[k])
            m = inl_mask[k]
            pairs[g] = (idx0[k][m], idx1[k][m])
        if keep_features:
            j0 = 0 if start == 0 else 1         # drop the overlap frame
            feat_windows.append((j0, len(idx) - j0, feats))
            if keep_refine_features:
                ref_windows.append((j0, len(idx) - j0, ref_feats))
        if progress is not None:
            progress(idx[-1])

    # double-buffered producer/consumer (the reference hides loader latency
    # with 4 subprocesses, PoseEstimation.py:91-119; here XLA's async
    # dispatch computes window k+1 while the host consumes window k).
    # Window STAGING (disk read + np.stack of ~134 MB at window 64) runs in
    # a background thread so it overlaps the device compute too — at
    # sequence scale the staging path was the frontend bottleneck
    # (measured: 73 ms/frame e2e vs the 33 ms/frame steady-state of the
    # same window program on resident inputs).
    import queue as _queue
    import threading

    starts = []
    s0 = 0
    while s0 < n - 1:
        starts.append(s0)
        s0 = min(s0 + window, n) - 1

    q: "_queue.Queue" = _queue.Queue(maxsize=2)

    def producer():
        for start in starts:
            stop = min(start + window, n)
            idx = list(range(start, stop))
            idx_p = idx + [idx[-1]] * (window - len(idx))
            pts = np.stack([np.asarray(scans[i][0]) for i in idx_p])
            msk = np.stack([np.asarray(scans[i][1]) for i in idx_p])
            q.put((start, idx, pts, msk))
        q.put(None)

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    pending = None
    while True:
        item = q.get()
        if item is None:
            break
        start, idx, pts_np, msk_np = item
        pts = jnp.asarray(pts_np)
        msk = jnp.asarray(msk_np)
        del pts_np, msk_np, item
        key, sub = jax.random.split(key)
        if keep_refine_features:
            feats, ref_feats, regs = process(
                respond_params, encoder_params, pts, msk, sub)
        else:
            feats, regs = process(respond_params, encoder_params, pts, msk,
                                  sub)
            ref_feats = None
        if pending is not None:
            consume(*pending)
        pending = (start, idx, feats, ref_feats, regs)
    th.join()
    if pending is not None:
        consume(*pending)

    def concat_windows(windows):
        """Stack kept frames of all windows: one slice + one concat per
        pytree field, regardless of sequence length."""
        views = [jax.tree.map(lambda x: x[j0:j0 + nk], f)
                 for j0, nk, f in windows]
        if len(views) == 1:
            return views[0]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *views)

    feats_out = concat_windows(feat_windows) if keep_features else None
    refs_out = (concat_windows(ref_windows)
                if keep_refine_features else None)

    # constant-velocity fallback on failures (same as run_odometry)
    prevR, prevT = np.eye(3), np.zeros(3)
    for g in range(n - 1):
        if not succ[g]:
            rel_Rs[g] = prevR
            rel_ts[g] = prevT
        prevR, prevT = rel_Rs[g], rel_ts[g]

    poses = np.asarray(
        chain_poses(rel_Rs, rel_ts, np.asarray(R_tr), np.asarray(t_tr))
    )
    result = OdometryResult(
        poses=poses, rel_Rs=rel_Rs, rel_ts=rel_ts, successes=succ,
        n_inliers=n_inl, inlier_pairs=pairs, thresholds=ths,
    )
    if keep_refine_features:
        return result, feats_out, refs_out
    return result, feats_out
