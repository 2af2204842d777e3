"""Pose-refinement back end: de-jump, keyframe transfer chains, ICP refit.

Host-side sequential control (cheap pose algebra in float64 numpy) around
jitted device kernels (the hybrid ICP), mirroring the reference's
``RefinePoses.py`` pipeline:

* **de-jump** (``FixJumpPoses``, ``:233-262``): detect inter-frame motion
  discontinuities (>2 deg or >0.5 m change in the relative motion) and
  replace the offending step with constant-velocity propagation, then
  forward-propagate.
* **keyframe selection by inlier transfer** (``RefineOdometry``,
  ``:357-400``): chain RANSAC inlier indices across consecutive pairs until
  the track dies (>=1 shared pair, <=20 frames).
* **refinement core** (``:273-334``): re-register keyframe pairs with
  extended keypoints + hybrid ICP, accept only if the correction is < 10 deg
  and < 5 m, then forward-update the trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np

from ..config import RefineConfig


# ---------------------------------------------------------------- pose utils
def _rt(pose):
    P = np.asarray(pose, np.float64).reshape(3, 4)
    return P[:, :3], P[:, 3]


def _orth(R):
    """Project a near-rotation onto SO(3) (Gram-Schmidt rows, f64).

    Every pose row written by the host bookkeeping passes through here:
    device-computed corrections carry up to ~1e-4 of determinant error
    (f32 storage + reduced-precision matmul passes), and the de-jump / refinement /
    burst-splice cycles repeatedly RE-DERIVE rels from poses and re-chain
    — which compounds any det != 1 multiplicatively (measured: pose dets
    1.0 -> 1.57 over 519 frames, then an accepted burst splice re-chained
    those rels into det 7e54 / ATE 8e30).  Projecting at the write
    boundary caps the error of every cycle at the write's own precision
    instead of letting cycles multiply."""
    R = np.asarray(R, np.float64)
    r0 = R[0] / max(np.linalg.norm(R[0]), 1e-300)
    r1 = R[1] - (r0 @ R[1]) * r0
    r1 = r1 / max(np.linalg.norm(r1), 1e-300)
    return np.stack([r0, r1, np.cross(r0, r1)])


def _row(R, t):
    return np.concatenate(
        [_orth(R), np.asarray(t, np.float64).reshape(3, 1)], axis=1
    ).reshape(12)


def _rel(pose0, pose1):
    R0, t0 = _rt(pose0)
    R1, t1 = _rt(pose1)
    R = R0.T @ R1
    t = R0.T @ (t1 - t0)
    return R, t


def _euler_deg(R):
    ax = np.degrees(np.arctan2(R[2, 1], R[2, 2]))
    ay = np.degrees(np.arctan2(-R[2, 0], np.hypot(R[2, 1], R[2, 2])))
    az = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
    return np.array([ax, ay, az])


def _all_rels(poses):
    Rs, ts = [], []
    for i in range(len(poses) - 1):
        R, t = _rel(poses[i], poses[i + 1])
        Rs.append(R)
        ts.append(t)
    return np.array(Rs), np.array(ts)


def forward_update(poses, frame, new_pose, rel_Rs, rel_ts):
    """Replace ``poses[frame]`` and re-chain all later frames with the stored
    relative motions (``ForwardUpdatePoses``, ``RefinePoses.py:120-145``)."""
    poses = poses.copy()
    rel_Rs = rel_Rs.copy()
    rel_ts = rel_ts.copy()
    poses[frame] = new_pose
    if frame > 0:
        rel_Rs[frame - 1], rel_ts[frame - 1] = _rel(poses[frame - 1], new_pose)
    for i in range(frame + 1, len(poses)):
        R0, t0 = _rt(poses[i - 1])
        R = R0 @ rel_Rs[i - 1]
        t = R0 @ rel_ts[i - 1] + t0
        poses[i] = _row(R, t)
    return poses, rel_Rs, rel_ts


def backward_update(poses, frame0, frame1, new_pose, rel_Rs, rel_ts):
    """Distribute a correction of ``poses[frame1]`` smoothly over the frames
    in (frame0, frame1] (``BackwardUpdatePoses``, ``RefinePoses.py:149-229``
    — present but disabled in the reference; here it is a first-class op).

    The total pose delta is split into equal per-frame Euler/translation
    increments in the frame0-relative frame, and each stored relative motion
    is adjusted so the chain ends exactly at ``new_pose``.
    """
    poses = poses.copy()
    rel_Rs = rel_Rs.copy()
    rel_ts = rel_ts.copy()
    n = frame1 - frame0
    assert n >= 1
    from scipy.spatial.transform import Rotation

    R0, t0 = _rt(poses[frame0])
    Rn, tn = _rt(new_pose)
    # target relative transform frame0 -> new frame1
    Rt = R0.T @ Rn
    tt = R0.T @ (tn - t0)
    # ORIGINAL cumulative transforms frame0 -> frame0+k (before mutation)
    cum = [(np.eye(3), np.zeros(3))]
    for j in range(frame0, frame1):
        Ck, ck = cum[-1]
        cum.append((Ck @ rel_Rs[j], Ck @ rel_ts[j] + ck))
    Rc, tc = cum[n]
    # rotation delta to distribute (right-multiplied), translation additive.
    # The delta is interpolated as a ROTATION VECTOR (geodesic / slerp), not
    # per-axis Euler increments: the Euler round trip
    # (``_euler_deg(dR)`` -> ``from_euler``) is degenerate near pitch +-90
    # deg and reconstructed the endpoint only to ~1e-2 deg on real spans
    # (observed at span (171, 173) on the hard circuit), tripping the
    # exactness check below.  ``from_rotvec(rotvec(dR))`` rebuilds dR to
    # float64 round-off by construction, so the k = n step is exact.  The
    # reference's own interpolation is Euler-based (``BackwardUpdatePoses``,
    # ``RefinePoses.py:149-229``) and inherits the same edge case — its
    # verifyNorm tolerance of 0.01 is two orders looser than ours.
    dR = Rc.T @ Rt
    d_rotvec = Rotation.from_matrix(dR).as_rotvec() / n
    d_t = (tt - tc) / n

    prev_R, prev_t = np.eye(3), np.zeros(3)
    for k in range(1, n + 1):
        frac_R = Rotation.from_rotvec(d_rotvec * k).as_matrix()
        Rk = cum[k][0] @ frac_R
        tk = cum[k][1] + d_t * k
        # new relative motion for step k
        rel_Rs[frame0 + k - 1] = prev_R.T @ Rk
        rel_ts[frame0 + k - 1] = prev_R.T @ (tk - prev_t)
        prev_R, prev_t = Rk, tk
        Rp, tp = _rt(poses[frame0 + k - 1])
        poses[frame0 + k] = _row(
            Rp @ rel_Rs[frame0 + k - 1], Rp @ rel_ts[frame0 + k - 1] + tp
        )
    # exactness check (reference asserts verifyNorm < 0.01, :222-226)
    Rv, tv = _rel(poses[frame1], new_pose)
    err_deg = float(np.linalg.norm(_euler_deg(Rv)))
    err_t = float(np.linalg.norm(tv))
    if err_deg > 1e-6 or err_t > 1e-6:
        raise BackwardUpdateInexact(
            f"backward_update verification failed: span ({frame0}, {frame1})"
            f" err {err_deg:.3e} deg / {err_t:.3e} m; "
            f"d_rotvec_deg={np.degrees(d_rotvec) * n}, d_t={d_t * n}")
    return poses, rel_Rs, rel_ts


class BackwardUpdateInexact(AssertionError):
    """The distributed span correction failed its end-point verification
    (e.g. an Euler-decomposition edge case); callers fall back to the
    endpoint-only forward update."""


def fix_jump_poses(poses, cfg: RefineConfig = RefineConfig(),
                   pair_trusted=None):
    """De-jump a trajectory (``FixJumpPoses``, ``RefinePoses.py:233-262``).

    A jump is a frame where the relative motion changes by more than
    ``jump_euler_deg`` / ``jump_trans_m`` w.r.t. the previous step; it is
    replaced by constant-velocity propagation and the chain re-run.

    Args:
      pair_trusted: optional ``(N-1,)`` bool — per-pair evidence from the
        front end (RANSAC success with a healthy inlier count).  When
        given, a motion discontinuity on a TRUSTED pair is NOT treated as
        a jump: a well-supported registration that changes the motion is a
        real turn, and replacing it with constant velocity injects error.
        The reference has no such gate (its threshold test alone fires on
        legitimate 20 deg/s turn entries, which sit exactly at the 2 deg
        default); measured on the hard circuit benchmark the ungated
        de-jump made ATE *worse* (2.89 -> 5.99 m).  ``None`` reproduces
        the reference behavior exactly.
    """
    poses = np.asarray(poses, np.float64).copy()
    fixed = []
    rel_Rs, rel_ts = _all_rels(poses)
    # Replacing the jump step with constant velocity is exactly
    # ``rel[i-1] := rel[i-2]`` (``forward_update`` keeps every other stored
    # relative motion), so detection runs on the relative motions alone and
    # the absolute chain is rebuilt once at the end — O(N) on a 4,541-frame
    # sequence instead of O(N^2).
    eul = np.array([_euler_deg(R) for R in rel_Rs])
    for i in range(2, len(poses) - 1):
        if pair_trusted is not None and bool(pair_trusted[i - 1]):
            continue
        if pair_trusted is not None and not bool(pair_trusted[i - 2]):
            # The constant-velocity replacement SOURCES the previous rel;
            # if that pair is itself untrusted, propagating it cascades one
            # guess into a run of them — through a 40-frame degraded burst
            # over a turn this painted a straight line across the corner
            # (measured: ATE 48.5 -> 62.4 m).  Leave the estimate for the
            # refinement stage, whose ICP re-registers untrusted spans from
            # actual geometry.  The reference has no trust signal and
            # always propagates (``RefinePoses.py:233-262``).
            continue
        # SIGNED vector diffs, matching ``Transformations.py:148``
        # (norm(RelEulers[i+1] - RelEulers[i])): an abs-before-diff variant
        # reads a sign-flip jump (+2 -> -2 deg/frame yaw, or a translation
        # reversal) as zero change and silently misses it.
        d_eul = np.linalg.norm(eul[i - 1] - eul[i - 2])
        d_t = np.linalg.norm(rel_ts[i - 1] - rel_ts[i - 2])
        if d_eul > cfg.jump_euler_deg or d_t > cfg.jump_trans_m:
            rel_Rs[i - 1] = rel_Rs[i - 2]
            rel_ts[i - 1] = rel_ts[i - 2]
            eul[i - 1] = eul[i - 2]
            fixed.append(i)
    if fixed:
        for k in range(fixed[0], len(poses)):
            R0, t0 = _rt(poses[k - 1])
            poses[k] = _row(R0 @ rel_Rs[k - 1], R0 @ rel_ts[k - 1] + t0)
    return poses, fixed


def transfer_pair_chain(inlier_idx_pairs: Sequence, start: int,
                        max_frames: int = 20, min_pairs: int = 1):
    """Chain RANSAC inlier indices across consecutive pairs to find the
    longest keyframe span starting at ``start``
    (``RefineOdometry``/``GetTransferPairIdx``, ``RefinePoses.py:102-114,
    374-400``).

    Args:
      inlier_idx_pairs: list over frames of ``(idx0, idx1)`` int arrays —
        the RANSAC inlier keypoint indices of pair (k, k+1).
      start: first frame of the chain.

    Returns ``(end_frame, n_surviving_tracks)``.
    """
    idx0, idx1 = inlier_idx_pairs[start]
    track = np.asarray(idx1)
    end = start + 1
    while end < len(inlier_idx_pairs) + 1 - 1:
        if end - start >= max_frames:
            break
        if end >= len(inlier_idx_pairs):
            break
        nxt0, nxt1 = inlier_idx_pairs[end]
        nxt0 = np.asarray(nxt0)
        common, ia, ib = np.intersect1d(track, nxt0, return_indices=True)
        if common.size < min_pairs:
            break
        track = np.asarray(nxt1)[ib]
        end += 1
    return end, int(track.size)


@dataclasses.dataclass
class RefineStats:
    refined: List = dataclasses.field(default_factory=list)
    failed: List = dataclasses.field(default_factory=list)
    rejected: List = dataclasses.field(default_factory=list)
    # spans left untouched because every odometry pair in them was trusted
    # (successful high-inlier registration) — see RefineConfig
    skipped: List = dataclasses.field(default_factory=list)


def refine_odometry(poses, icp_fn: Callable, rel_lidar_fn: Callable,
                    apply_rel_fn: Callable,
                    inlier_idx_pairs: Sequence | None = None,
                    cfg: RefineConfig = RefineConfig(),
                    start_frame: int = 0):
    """Keyframe refinement loop (``RefineOdometry``, ``RefinePoses.py:338-464``).

    Abstracts the device work behind callables so the chain logic is testable
    without data:
      icp_fn(f0, f1, relR, relT) -> (dR, dt, success): ICP correction of the
        odometry-predicted relative pose between frames f0, f1.
      rel_lidar_fn(pose0, pose1) -> (R, t): lidar-frame relative pose.
      apply_rel_fn(pose0, relR, relT) -> new pose row for frame1.
    """
    poses = np.asarray(poses, np.float64).copy()
    rel_Rs, rel_ts = _all_rels(poses)
    stats = RefineStats()
    i = start_frame
    end_limit = len(poses) - 2
    max_transfer = cfg.max_transfer_frames
    while i < end_limit:
        if inlier_idx_pairs is not None:
            j, _ = transfer_pair_chain(
                inlier_idx_pairs, i, max_frames=max_transfer
            )
        else:
            j = i + 1
        relR, relT = rel_lidar_fn(poses[i], poses[j])
        dR, dt, ok = icp_fn(i, j, relR, relT)
        if not ok:
            if j - i > 1:
                max_transfer = 1   # retry with the shortest span
                continue
            stats.failed.append((i, j))
            max_transfer = cfg.max_transfer_frames
            i += 1
            continue
        newR = dR @ relR
        newT = dR @ relT + dt
        d_eul = np.linalg.norm(_euler_deg(relR) - _euler_deg(newR))
        d_tr = np.linalg.norm(relT - newT)
        if d_eul > cfg.accept_euler_deg or d_tr > cfg.accept_trans_m:
            if j - i > 1:
                max_transfer = 1
                continue
            stats.rejected.append((i, j))
            max_transfer = cfg.max_transfer_frames
            i += 1
            continue
        new_pose = apply_rel_fn(poses[i], newR, newT)
        poses, rel_Rs, rel_ts = _apply_correction(poses, i, j, new_pose,
                                                  rel_Rs, rel_ts, cfg)
        stats.refined.append((i, j))
        max_transfer = cfg.max_transfer_frames
        i = j
    return poses, stats


def _apply_correction(poses, i, j, new_pose, rel_Rs, rel_ts,
                      cfg: RefineConfig):
    """Apply an accepted span correction: distribute it over (i, j] when
    ``cfg.backward_distribute`` (the reference's disabled
    ``BackwardUpdatePoses``, live here), then re-chain the tail."""
    if cfg.backward_distribute and j - i > 1:
        try:
            poses, rel_Rs, rel_ts = backward_update(poses, i, j, new_pose,
                                                    rel_Rs, rel_ts)
        except BackwardUpdateInexact as e:
            # distribution is a smoothing nicety; the endpoint-only update
            # below is always exact
            import warnings

            warnings.warn(str(e))
    return forward_update(poses, j, new_pose, rel_Rs, rel_ts)


def plan_spans(poses_len: int, inlier_idx_pairs: Sequence | None,
               max_transfer: int):
    """Greedy keyframe-span partition [(i, j), ...] over the trajectory —
    the span starts the sequential ``refine_odometry`` would visit on its
    accept path (each accepted span advances ``i`` to ``j``)."""
    spans = []
    i = 0
    end_limit = poses_len - 2
    while i < end_limit:
        if inlier_idx_pairs is not None:
            j, _ = transfer_pair_chain(inlier_idx_pairs, i,
                                       max_frames=max_transfer)
        else:
            j = i + 1
        spans.append((i, j))
        i = j
    return spans


def span_trusted_pre(span, pair_trusted, cfg: RefineConfig) -> bool:
    """True when every odometry pair inside ``span`` is trusted (and
    ``cfg.skip_trusted_spans`` is on)."""
    if pair_trusted is None or not cfg.skip_trusted_spans:
        return False
    i, j = span
    return bool(np.all(np.asarray(pair_trusted[i:j], bool)))


def refine_odometry_batched(poses, batched_icp_fn: Callable,
                            rel_lidar_fn: Callable, apply_rel_fn: Callable,
                            inlier_idx_pairs: Sequence | None = None,
                            cfg: RefineConfig = RefineConfig(),
                            pair_trusted=None):
    """Jacobi-style batched refinement: identical decisions to
    ``refine_odometry`` on its accept path, with the expensive hybrid-ICP
    solves batched across ALL keyframe spans in two device passes.

    This exploits two invariances: (a) the relative pose between span
    endpoints is unchanged by ``forward_update`` at earlier frames (the
    update re-chains later poses with the stored relative motions), and
    (b) the accept gate compares the ICP-corrected relative pose against the
    odometry one — absolute poses never enter.  So every span's decision is
    computable from the batched ICP outputs alone, and the sequential
    forward-propagation reduces to applying accepted corrections in frame
    order.

    Fallback semantics differ slightly from the sequential version: a
    failed/rejected multi-frame span falls back to batched single-step
    refinement over ALL its steps (pass 2), where the sequential loop
    retries one step and re-plans from ``i+1``.  This is strictly more work
    done, in one extra device call.

    Args:
      batched_icp_fn: ``(idx_i, idx_j, relRs (S,3,3), relTs (S,3)) ->
        (dRs, dts, oks)`` — batched ICP corrections
        (``refine_runner.make_batched_icp_fn``).
    """
    poses = np.asarray(poses, np.float64).copy()
    rel_Rs, rel_ts = _all_rels(poses)
    stats = RefineStats()
    spans = plan_spans(len(poses), inlier_idx_pairs, cfg.max_transfer_frames)
    # Trusted spans are left untouched: below the sensor's resampling floor
    # ICP has no unbiased signal (the resampled surfaces genuinely align
    # better at a slightly wrong pose), so "corrections" there inject
    # compounding rotation error (measured on the hard benchmark: ATE
    # 0.32 m raw -> 2-11 m after refining trusted spans, depending on
    # gates).  Refinement's real job — rescuing spans whose odometry pairs
    # failed or were weak — is untouched.
    skipped = [s for s in spans if span_trusted_pre(s, pair_trusted, cfg)]
    spans = [s for s in spans if not span_trusted_pre(s, pair_trusted, cfg)]
    stats.skipped.extend(skipped)
    if pair_trusted is not None:
        # A span containing UNTRUSTED pairs is refined pair-by-pair: the
        # span formulation corrects only the endpoint relative pose and
        # interpolates the interior, which leaves a wrong-but-confident
        # burst (e.g. sensor degradation through a turn) essentially
        # uncorrected (measured: 43 span refinements moved ATE 49.5 ->
        # 46.9 m; single-step re-registration of the same region is the
        # actual repair).  Chains exist in the reference for CPU economy —
        # batched device ICP pays little for the extra spans.
        out = []
        for (i, j) in spans:
            if j - i > 1 and not np.all(np.asarray(pair_trusted[i:j], bool)):
                out.extend((a, a + 1) for a in range(i, j)
                           if not span_trusted_pre((a, a + 1), pair_trusted,
                                                   cfg))
            else:
                out.append((i, j))
        spans = out
    if not spans:
        return poses, stats

    def decide(i, j, relR, relT, dR, dt, ok, r0=None, r1=None):
        """Replicates the sequential accept gate (RefinePoses.py:304-310),
        plus the residual-gain requirement: the correction must EXPLAIN the
        geometry materially better than the incoming relative pose, else
        ICP merely found a nearby sensor-locked optimum and applying it
        turns refinement into a seed-dependent random walk (see
        RefineConfig.residual_gain_frac)."""
        if not ok:
            return None
        if (r0 is not None and cfg.residual_gain_frac > 0.0
                and (r0 - r1) < max(cfg.residual_gain_frac * r0,
                                    cfg.residual_gain_floor_m)):
            return None
        newR = dR @ relR
        newT = dR @ relT + dt
        d_eul = np.linalg.norm(_euler_deg(relR) - _euler_deg(newR))
        d_tr = np.linalg.norm(relT - newT)
        if d_eul > cfg.accept_euler_deg or d_tr > cfg.accept_trans_m:
            return None
        return newR, newT

    def solve(span_list, thr_scale=1.0):
        idx_i = np.array([s[0] for s in span_list], np.int32)
        idx_j = np.array([s[1] for s in span_list], np.int32)
        rels = [rel_lidar_fn(poses[a], poses[b]) for a, b in span_list]
        relRs = np.stack([r for r, _ in rels])
        relTs = np.stack([t for _, t in rels])
        out = batched_icp_fn(idx_i, idx_j, relRs, relTs,
                             thr_scale=thr_scale)
        if len(out) == 5:
            dRs, dts, oks, r0s, r1s = out
        else:   # legacy 3-tuple contract (no residuals -> gain gate off)
            dRs, dts, oks = out
            r0s = r1s = None
        return relRs, relTs, dRs, dts, oks, r0s, r1s

    # pass 1: all planned spans in one batched call
    relRs, relTs, dRs, dts, oks, r0s, r1s = solve(spans)
    accepted = {}           # j -> (i, newR, newT), applied in frame order
    fallback_steps = []
    for k, (i, j) in enumerate(spans):
        res = decide(i, j, relRs[k], relTs[k], dRs[k], dts[k], bool(oks[k]),
                     None if r0s is None else r0s[k],
                     None if r1s is None else r1s[k])
        if res is not None:
            accepted[j] = (i, *res)
            stats.refined.append((i, j))
        elif j - i > 1:
            fallback_steps.extend(
                (a, a + 1) for a in range(i, j)
                if not span_trusted_pre((a, a + 1), pair_trusted, cfg))
        else:
            (stats.failed if not bool(oks[k]) else stats.rejected).append((i, j))

    # pass 2: single-step fallback for failed/rejected long spans
    if fallback_steps:
        relRs, relTs, dRs, dts, oks, r0s, r1s = solve(fallback_steps)
        for k, (i, j) in enumerate(fallback_steps):
            res = decide(i, j, relRs[k], relTs[k], dRs[k], dts[k],
                         bool(oks[k]),
                         None if r0s is None else r0s[k],
                         None if r1s is None else r1s[k])
            if res is not None:
                accepted[j] = (i, *res)
                stats.refined.append((i, j))
            else:
                (stats.failed if not bool(oks[k])
                 else stats.rejected).append((i, j))

    # pass 3: coarse-to-fine retry ladder for FAILED steps (the rescue
    # path).  A step whose initial guess is a constant-velocity fallback
    # through a turn starts meters off; the 0.5 m inlier gate starves ICP
    # of correspondences before it can pull the clouds together (measured
    # on the degraded hard benchmark: every failed-front-end span also
    # failed rung-1 ICP).  The ladder widens the INITIAL gate (the decay
    # schedule still tightens it on convergence) — the ICP analog of the
    # RANSAC 0.4/0.8/1.6 threshold ladder (``Match.py:207-214``).  Rejected
    # (not failed) steps are NOT retried: they produced a confident answer
    # past the accept gate, and a wider gate only loosens it.
    for rung in (2.0, 4.0, 8.0):
        retry = [s for s in stats.failed]
        if not retry:
            break
        stats.failed = []
        relRs, relTs, dRs, dts, oks, r0s, r1s = solve(retry, thr_scale=rung)
        for k, (i, j) in enumerate(retry):
            res = decide(i, j, relRs[k], relTs[k], dRs[k], dts[k],
                         bool(oks[k]),
                         None if r0s is None else r0s[k],
                         None if r1s is None else r1s[k])
            if res is not None:
                accepted[j] = (i, *res)
                stats.refined.append((i, j))
            elif bool(oks[k]):
                stats.rejected.append((i, j))
            else:
                stats.failed.append((i, j))

    # apply accepted corrections in frame order (cheap host chain)
    for j in sorted(accepted):
        i, newR, newT = accepted[j]
        new_pose = apply_rel_fn(poses[i], newR, newT)
        poses, rel_Rs, rel_ts = _apply_correction(poses, i, j, new_pose,
                                                  rel_Rs, rel_ts, cfg)
    return poses, stats
