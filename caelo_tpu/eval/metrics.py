"""Evaluation metrics: RRE/RTE/success-rate, ATE, keypoint repeatability.

Matches the reference's metric definitions so pose files are comparable
bit-for-bit with its golden artifact (``Evaluation Result/
EvaluationResults.mat``):

* per-pair errors are computed on *lidar-frame relative* poses
  (``Visualization.GetErrorRTs``, ``Visualization.py:164-248``);
* RRE = sum of |XYZ Euler error components| in degrees, RTE = ||t error||
  (``EvaluationOnRegistration.py:108-130``);
* success = RRE < 1 deg AND RTE < 0.5 m (``EvaluationOnRegistration.py:23-24``);
* keypoint repeatability histograms (``EvaluationOnKeypts.py:68-140``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from ..geometry.kitti_pose import poses_to_rt, rel_pose_lidar


class RegistrationErrors(NamedTuple):
    rre_deg: jnp.ndarray       # (N-1,) sum-abs Euler error
    rte_m: jnp.ndarray         # (N-1,) translation error norm
    euler_err: jnp.ndarray     # (N-1, 3)
    t_err: jnp.ndarray         # (N-1, 3)


def relative_pose_errors(poses_gt, poses_est, R_tr, t_tr) -> RegistrationErrors:
    """Frame-to-frame lidar-frame relative-pose errors between two
    trajectories (both as (N, 12) KITTI rows).

    Host float64 numpy, deliberately: evaluation must not run through
    reduced-precision device matmuls (default f32 precision may be bf16
    passes or TF32), which quantize the pose products and inject APPARENT
    per-pair error at sequence scale (see chain_poses docstring)."""
    def rels(poses):
        P = np.asarray(poses, np.float64).reshape(-1, 3, 4)
        Rtr = np.asarray(R_tr, np.float64)
        ttr = np.asarray(t_tr, np.float64)
        # cam rel: inv(P0) @ P1; conjugate into lidar: Tr^-1 rel Tr
        R0, t0 = P[:-1, :, :3], P[:-1, :, 3]
        R1, t1 = P[1:, :, :3], P[1:, :, 3]
        Rc = np.einsum("nji,njk->nik", R0, R1)
        tc = np.einsum("nji,nj->ni", R0, t1 - t0)
        Rl = np.einsum("ji,njk,kl->nil", Rtr, Rc, Rtr)
        tl = np.einsum("ji,nj->ni", Rtr, np.einsum("nij,j->ni", Rc, ttr)
                       + tc - ttr)
        return Rl, tl

    Rg, tg = rels(poses_gt)
    Re, te = rels(poses_est)
    # errorR = inv(R_est) @ R_gt, expressed as XYZ Euler degrees
    errR = np.einsum("nji,njk->nik", Re, Rg)
    ay = np.degrees(np.arctan2(-errR[:, 2, 0],
                               np.hypot(errR[:, 2, 1], errR[:, 2, 2])))
    ax = np.degrees(np.arctan2(errR[:, 2, 1], errR[:, 2, 2]))
    az = np.degrees(np.arctan2(errR[:, 1, 0], errR[:, 0, 0]))
    euler_err = np.stack([ax, ay, az], axis=1)
    t_err = te - tg
    return RegistrationErrors(
        rre_deg=np.sum(np.abs(euler_err), axis=-1),
        rte_m=np.linalg.norm(t_err, axis=-1),
        euler_err=euler_err,
        t_err=t_err,
    )


def registration_summary(errors: RegistrationErrors,
                         rre_threshold: float = 1.0,
                         rte_threshold: float = 0.5,
                         n_inliers=None, n_keypoints: int | None = None,
                         thresholds=None) -> dict:
    """The 7-column row of ``EvaluationResults.mat``: RRE, stdRRE, RTE,
    stdRTE, success rate, and — when front-end stats are passed — the inlier
    ratio and the threshold-escalation stat (our batched-RANSAC analog of
    the reference's mean trial count, ``EvaluationOnRegistration.py:
    108-130``).

    Args:
      n_inliers: optional ``(N-1,)`` per-pair RANSAC inlier counts
        (``OdometryResult.n_inliers``).
      n_keypoints: keypoint count per frame (denominator of the inlier
        ratio; the reference uses the fixed 1024).
      thresholds: optional ``(N-1,)`` accepted residual rung per pair.
    """
    rre = np.asarray(errors.rre_deg)
    rte = np.asarray(errors.rte_m)
    ok = (rre < rre_threshold) & (rte < rte_threshold)
    out = {
        "rre_deg": float(rre.mean()),
        "rre_std": float(rre.std()),
        "rte_m": float(rte.mean()),
        "rte_std": float(rte.std()),
        "success_rate": float(ok.mean()),
        "n_pairs": int(rre.shape[0]),
    }
    if n_inliers is not None and n_keypoints:
        out["inlier_ratio"] = float(
            np.asarray(n_inliers, np.float64).mean() / n_keypoints)
    if thresholds is not None:
        t = np.asarray(thresholds, np.float64)
        out["mean_threshold_m"] = float(t.mean())
        out["escalation_rate"] = float((t > t.min()).mean())
    return out


def absolute_trajectory_error(poses_gt, poses_est) -> dict:
    """ATE on trajectory translations (after rigid alignment of the two
    trajectories — the standard SLAM ATE; the reference plots trajectories
    but never computes ATE, the driver's north star requires it).

    Host float64 (same rationale as ``relative_pose_errors``)."""
    tg = np.asarray(poses_gt, np.float64).reshape(-1, 3, 4)[:, :, 3]
    te = np.asarray(poses_est, np.float64).reshape(-1, 3, 4)[:, :, 3]
    mg, me = tg.mean(0), te.mean(0)
    H = (te - me).T @ (tg - mg)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    te_aligned = (te - me) @ R.T + mg
    err = np.linalg.norm(te_aligned - tg, axis=-1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(np.mean(err)),
        "ate_max": float(np.max(err)),
    }


def keypoint_repeatability(kp0, mask0, kp1, mask1, R01, t01,
                           bins=None) -> dict:
    """Repeatability of consecutive-frame keypoints: transform frame-1
    keypoints into frame 0 with the GT relative pose, histogram NN distances
    (``EvaluationOnKeypts.py:68-81,111-140``; bins 0.1..6.4 m doubling)."""
    from ..backend.icp import nearest_neighbors

    kp1w = se3.apply(jnp.asarray(R01), jnp.asarray(t01), kp1[None])[0]
    _, dist = nearest_neighbors(kp1w, mask1, kp0, mask0)
    d = np.asarray(dist)[np.asarray(mask1)]
    if bins is None:
        bins = [0.1 * 2**i for i in range(7)]  # 0.1 .. 6.4
    counts = [(d < b).mean() for b in bins]
    return {"bins_m": list(bins), "fraction_within": counts,
            "median_m": float(np.median(d)) if d.size else float("nan")}


def keypoint_dispersion(kp, mask, bins=None) -> dict:
    """Within-frame keypoint dispersion: each keypoint's distance to its
    nearest *other* keypoint in the same frame, histogrammed like
    repeatability (``ComputeDispersionOfKeypoints``,
    ``EvaluationOnKeypts.py:83-94``).  The reference fits sklearn 1-NN on the
    set itself so every query returns itself at distance 0 (its own comment
    flags this); here self-matches are excluded so the metric is the
    intended nearest-neighbor spacing.
    """
    kp = jnp.asarray(kp)
    m = jnp.asarray(mask)
    d2 = jnp.sum((kp[:, None, :] - kp[None, :, :]) ** 2, axis=-1)
    K = kp.shape[0]
    eye = jnp.eye(K, dtype=bool)
    bad = eye | ~m[None, :]
    d2 = jnp.where(bad, jnp.inf, d2)
    d = np.asarray(jnp.sqrt(jnp.min(d2, axis=1)))[np.asarray(m)]
    d = d[np.isfinite(d)]
    if bins is None:
        bins = [0.1 * 2**i for i in range(7)]  # 0.1 .. 6.4
    counts = [float((d < b).mean()) if d.size else float("nan") for b in bins]
    return {"bins_m": list(bins), "fraction_within": counts,
            "median_m": float(np.median(d)) if d.size else float("nan")}


def loop_closure_pr(edge_i, edge_j, positions, min_gap: int = 50,
                    revisit_m: float = 5.0, window: int = 10) -> dict:
    """Precision/recall of detected loop closures against ground truth.

    The reference has no loop-closure evaluation (its loop pipeline is a
    disabled skeleton, ``RefinePoses.py:477-518``); this scores ours.  A GT
    *revisit* is a frame pair (i < j) with ``|i-j| >= min_gap`` whose GT
    positions are within ``revisit_m``.  An accepted edge is a true positive
    if a GT revisit exists within ``window`` frames of both endpoints; a
    revisit *event* (a frame j with any qualifying earlier i) counts as
    recalled if some accepted edge's later endpoint is within ``window`` of
    j.

    Args:
      edge_i/edge_j: accepted closure endpoints (any order per edge).
      positions: ``(N, 3)`` GT frame positions.
    """
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    ei = np.minimum(np.asarray(edge_i, int), np.asarray(edge_j, int))
    ej = np.maximum(np.asarray(edge_i, int), np.asarray(edge_j, int))
    dist = np.linalg.norm(pos[None, :] - pos[:, None], axis=-1)
    idx = np.arange(n)
    gt = (dist <= revisit_m) & ((idx[None, :] - idx[:, None]) >= min_gap)

    tp = 0
    for a, b in zip(ei, ej):
        ia = slice(max(a - window, 0), min(a + window + 1, n))
        jb = slice(max(b - window, 0), min(b + window + 1, n))
        if gt[ia, jb].any():
            tp += 1
    precision = tp / len(ei) if len(ei) else float("nan")

    revisit_frames = np.where(gt.any(axis=0))[0]
    # merge adjacent revisit frames into events
    events = []
    for j in revisit_frames:
        if events and j - events[-1][-1] <= window:
            events[-1].append(j)
        else:
            events.append([j])
    recalled = sum(
        1 for ev in events
        if any(abs(b - j) <= window for b in ej for j in ev)
    )
    recall = recalled / len(events) if events else float("nan")
    return {
        "precision": precision,
        "recall": recall,
        "n_edges": int(len(ei)),
        "n_true_positive": int(tp),
        "n_revisit_events": int(len(events)),
    }


def kitti_drift(poses_gt, poses_est,
                lengths=(100, 200, 300, 400, 500, 600, 700, 800)) -> dict:
    """KITTI odometry devkit-style translational/rotational drift: average
    error of subsequences of fixed path lengths.  (The reference defers this
    to the KITTI server, ``README.md:19``; we compute it locally.)"""
    Rg, tg = (np.asarray(a) for a in poses_to_rt(jnp.asarray(poses_gt)))
    Re, te = (np.asarray(a) for a in poses_to_rt(jnp.asarray(poses_est)))
    # cumulative GT path length
    step = np.linalg.norm(np.diff(tg, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(step)])
    t_errs, r_errs = [], []
    for L in lengths:
        starts = range(0, len(cum) - 1, 10)
        for i in starts:
            js = np.searchsorted(cum, cum[i] + L)
            if js >= len(cum):
                break
            j = int(js)
            dRg = Rg[i].T @ Rg[j]
            dtg = Rg[i].T @ (tg[j] - tg[i])
            dRe = Re[i].T @ Re[j]
            dte = Re[i].T @ (te[j] - te[i])
            errR = dRe.T @ dRg
            ang = np.degrees(
                np.arccos(np.clip((np.trace(errR) - 1) / 2, -1, 1))
            )
            t_errs.append(np.linalg.norm(dte - dtg) / L)
            r_errs.append(ang / L)
    if not t_errs:
        return {"t_rel_pct": float("nan"), "r_rel_deg_per_m": float("nan")}
    return {
        "t_rel_pct": float(np.mean(t_errs) * 100.0),
        "r_rel_deg_per_m": float(np.mean(r_errs)),
    }
