"""Full odometry stack: front end -> de-jump -> refinement -> loop closure
-> pose-graph solve.

The reference runs this as four hand-sequenced scripts communicating through
pose text files (``PoseEstimation.py`` -> ``poses_``, ``RefinePoses.py``
de-jump -> ``poses__``, refinement -> ``poses___``, loop closure ->
``poses____``; naming convention ``Dirs.py:19-24``), each stage re-runnable
from per-frame files (stage toggles ``RefinePoses.py:526-531``,
``Match.py:287-291``).  Here every stage is a function over explicit inputs;
``run_full_pipeline`` chains them in memory, while ``preprocess_to_store`` /
``load_stage_inputs`` persist and reload the same inputs through
``data.artifacts.ArtifactStore`` so de-jump, refinement, and loop closure
can re-run from disk without touching raw scans — the reference's
operational contract, one .npz tree instead of five .mat trees.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .backend import refine
from .backend.loopclosure import detect_and_close
from .backend.posegraph import (concat_graphs, odometry_graph, optimize,
                                optimize_host)
from .backend.refine_runner import (RefinementFeatures,
                                    extract_refinement_features,
                                    make_batched_icp_fn, make_icp_fn)
from .config import PipelineConfig
from .data.artifacts import ArtifactStore
from .frontend.odometry import OdometryResult, run_odometry
from .frontend.registration import FrameFeatures, register_pair
from .geometry.kitti_pose import lidar_rel_to_cam, poses_to_rt, rt_to_poses
from .utils.telemetry import MetricsLog, StageTimer


@dataclasses.dataclass
class FullPipelineResult:
    poses_raw: np.ndarray        # poses_     — chained odometry
    poses_dejumped: np.ndarray   # poses__    — after de-jump
    poses_refined: np.ndarray    # poses___   — after ICP refinement
    poses_final: np.ndarray      # poses____  — after loop closure + graph solve
    odometry: OdometryResult
    dejumped_frames: List
    refine_stats: "refine.RefineStats"
    n_loop_closures: int
    # accepted closure endpoints (frame indices) — score with
    # eval.metrics.loop_closure_pr against GT positions
    loop_edge_i: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    loop_edge_j: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    # multi-frame burst rescue diagnostics (backend.burst.BurstStats) —
    # None when the stage did not run (no unhealthy frames)
    burst_stats: object = None


# --------------------------------------------------------------- stage fns
def extract_refinement_features_batched(scans, respond_params,
                                        cfg: PipelineConfig,
                                        chunk: int = 16
                                        ) -> List[RefinementFeatures]:
    """Per-frame refinement features, one dispatch per ``chunk`` frames."""
    vext = jax.jit(jax.vmap(
        lambda p, m: extract_refinement_features(respond_params, p, m, cfg)
    ))
    out: List[RefinementFeatures] = []
    chunk = min(chunk, len(scans))
    for s in range(0, len(scans), chunk):
        grp = scans[s:s + chunk]
        pad = chunk - len(grp)
        grp = grp + [grp[-1]] * pad
        pts = jnp.stack([jnp.asarray(p) for p, _ in grp])
        msk = jnp.stack([jnp.asarray(m) for _, m in grp])
        batched = vext(pts, msk)
        for j in range(chunk - pad):
            out.append(jax.tree.map(lambda x: x[j], batched))
    return out


def stage_refinement(poses_dj, ref_feats, inlier_pairs, R_tr, t_tr,
                     cfg: PipelineConfig, batched: bool = True,
                     pair_trusted=None, devices=None):
    """Keyframe-transfer ICP refinement: poses__ -> poses___
    (``RefineOdometry``, ``RefinePoses.py:338-464``).  The batched solves
    shard over ``devices`` (default: every visible device) when there is
    more than one."""
    def rel_lidar_fn(p0, p1):
        from .geometry.kitti_pose import rel_pose_lidar

        R, t = rel_pose_lidar(
            jnp.asarray(p0), jnp.asarray(p1),
            jnp.asarray(R_tr, jnp.float64), jnp.asarray(t_tr, jnp.float64),
        )
        return np.asarray(R), np.asarray(t)

    def apply_rel_fn(pose0, relR, relT):
        dR, dt = lidar_rel_to_cam(
            jnp.asarray(relR), jnp.asarray(relT),
            jnp.asarray(R_tr, jnp.float64), jnp.asarray(t_tr, jnp.float64),
        )
        R0, t0 = refine._rt(pose0)
        return refine._row(R0 @ np.asarray(dR), R0 @ np.asarray(dt) + t0)

    if batched:
        # Jacobi-style: all keyframe-span ICP solves in two batched passes.
        # On a multi-device mesh the span axis shards over 'data'
        # (SURVEY section 2.4 keyframe-span partitioning; bit-identical to
        # the single-device path — see test_multichip).
        devs = jax.devices() if devices is None else list(devices)
        if len(devs) > 1:
            from .parallel.mesh import make_mesh
            from .parallel.pipeline import make_sharded_icp_fn

            mesh = make_mesh(n_data=len(devs), n_model=1, devices=devs)
            icp_fn = make_sharded_icp_fn(ref_feats, mesh, cfg)
        else:
            icp_fn = make_batched_icp_fn(ref_feats, cfg)
        return refine.refine_odometry_batched(
            poses_dj, icp_fn,
            rel_lidar_fn, apply_rel_fn,
            inlier_idx_pairs=inlier_pairs, cfg=cfg.refine,
            pair_trusted=pair_trusted,
        )
    return refine.refine_odometry(
        poses_dj, make_icp_fn(ref_feats, cfg), rel_lidar_fn,
        apply_rel_fn, inlier_idx_pairs=inlier_pairs, cfg=cfg.refine,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _verify_loop_candidates(key, feats, idx_i, idx_j, yaws, allow_prior,
                            cfg: PipelineConfig):
    """Geometric verification of all loop candidates in ONE device call:
    plain registration per pair, then a ScanContext-yaw-prior retry (wide
    gate: the prior carries no translation) selected only where the plain
    pass failed AND ``allow_prior`` is set.  Each pair gets its own
    fold_in-derived PRNG key.

    ``allow_prior`` must be False for the sequence-consistency NEIGHBOR
    pairs: a prior derived from the candidate's own alignment hypothesis
    biases the independent check toward confirming that hypothesis
    (measured: the prior-rescued neighbor verification admitted an aliased
    parallel-canyon edge the prior-free check rejects)."""
    from .backend.scancontext import yaw_rotation
    from .frontend.registration import register_pair_with_prior

    n = idx_i.shape[0]
    f_i = jax.tree.map(lambda x: x[idx_i], feats)
    f_j = jax.tree.map(lambda x: x[idx_j], feats)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.arange(n, dtype=jnp.uint32))
    regs = jax.vmap(lambda k, a, b: register_pair(k, a, b, cfg))(
        keys, f_i, f_j)
    keys2 = jax.vmap(jax.random.fold_in)(
        keys, jnp.full((n,), 1, jnp.uint32))
    regs2 = jax.vmap(
        lambda k, a, b, y: register_pair_with_prior(
            k, a, b, yaw_rotation(y), jnp.zeros(3, jnp.float32), cfg,
            gate_m=15.0)
    )(keys2, f_i, f_j, yaws)
    use2 = allow_prior & (~regs.success) & regs2.success
    sel = lambda r2, r1: jax.tree.map(
        lambda a, b: jnp.where(
            use2.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), r2, r1)
    out = sel(regs2, regs)
    return out.R, out.t, out.success, out.n_inliers


def stage_loop_closure(poses_ref, feats, rel_Rs, rel_ts, R_tr, t_tr,
                       cfg: PipelineConfig, min_loop_gap: int = 100,
                       seed: int = 0, frame_healthy=None,
                       candidate_source: str = "descriptor"):
    """Loop closure + pose-graph solve: poses___ -> poses____.

    ``rel_Rs``/``rel_ts`` are accepted for API compatibility but unused:
    every chain and graph edge derives from ``poses_ref`` so the solve
    preserves the de-jump/refinement corrections (see note below).

    ``candidate_source``: ``"descriptor"`` (default, the validated benchmark
    configuration) or ``"scancontext"`` — propose candidates from the full
    rotation-searched correlation matrix
    (``loopclosure.loop_candidates_scancontext``), which survives
    reverse-traversal revisits and repeated-texture descriptor aliasing.

    Returns ``(poses_final, n_loops, loop_edge_i, loop_edge_j)``.
    """
    from .backend.loopclosure import stack_frame_features

    key = jax.random.key(seed + 7)
    stacked = stack_frame_features(feats)
    # Loop verification matches distant-in-time frames with NO motion prior,
    # so descriptor-ambiguous structure (street-canyon wall speckle — every
    # wall patch looks alike) can assemble a 100+ inlier consensus between
    # two different but parallel corridors.  The Lowe ratio gate kills
    # exactly those near-tied matches while genuine revisit correspondences
    # (distinctive corners) survive — so it is forced ON here even when the
    # odometry front end (which has temporal coherence) runs without it.
    loop_cfg = dataclasses.replace(cfg, match_ratio=max(cfg.match_ratio, 0.85))

    # Sequence-consistency gate (SeqSLAM-style): a genuine revisit is not a
    # single-frame coincidence — the NEIGHBOR pair (i+d, j+d) must register
    # too, and its relative pose must agree with the candidate's chained
    # through local odometry:  rel(i+d, j+d) = rel(i,i+d)^-1 rel(i,j)
    # rel(j,j+d).  Registrations between LOOK-ALIKE places (aliased street
    # corners: 100+ RANSAC inliers, perfect-looking geometry) break this
    # chain as soon as the viewpoint moves.  A plain drift-magnitude bound
    # cannot separate the two once heading drift makes genuine loop
    # corrections map-scale as well (measured at 520 frames).
    #
    # Seq-scale engineering: local odometry rels come from prefix
    # compositions (O(1) per lookup), and the neighbor registrations ride
    # in the SAME batched device call as the candidates themselves — the
    # per-candidate dispatch + O(N) chain walk of the r3 design cost ~80 s
    # at 520 frames and scales as O(N * C).
    #
    # All chains/graph edges derive from the INPUT poses (poses_ref: after
    # de-jump + refinement), not the raw odometry rels: building the pose
    # graph's odometry edges from raw rels silently DISCARDS the earlier
    # stages' corrections in the solve (measured on the degraded benchmark:
    # de-jump took ATE 43.3 -> 11.3 m, then the raw-edge graph pulled the
    # solution back toward the corrupted chain).
    P = np.asarray(poses_ref, np.float64).reshape(-1, 3, 4)
    W_R = np.einsum("nij,jk->nik", P[:, :, :3], np.asarray(R_tr))
    W_t = (np.einsum("nij,j->ni", P[:, :, :3], np.asarray(t_tr))
           + P[:, :, 3])
    n_frames = W_R.shape[0]
    rel_Rs64 = np.einsum("nji,njk->nik", W_R[:-1], W_R[1:])
    rel_ts64 = np.einsum("nji,nj->ni", W_R[:-1], W_t[1:] - W_t[:-1])

    def chain_rel(a, b):
        """Trajectory rel pose mapping frame b into frame a (prefix-
        composed: rel(a,b) = W_a^-1 W_b)."""
        R = W_R[a].T @ W_R[b]
        t = W_R[a].T @ (W_t[b] - W_t[a])
        return R, t

    # odometry path length prefix (for the drift-plausibility bound)
    step_len = np.linalg.norm(rel_ts64, axis=1)
    path_prefix = np.concatenate([[0.0], np.cumsum(step_len)])

    GATE_D = 10
    DRIFT_FLOOR_M = 12.0
    DRIFT_FRAC = 0.15
    # Degraded bursts break the drift-plausibility premise (drift ~
    # fraction of path): a 40-frame sensor-degradation burst injects a
    # DISCRETE kink of many metres that no path-proportional bound
    # predicts, so every genuine closure spanning a burst gets rejected
    # (measured: 38/48 drift_bound rejects and zero accepted pins on the
    # degraded benchmark).  Each unhealthy frame crossed adds a per-frame
    # allowance instead.
    BURST_ALLOW_M = 0.5
    unhealthy_prefix = np.concatenate(
        [[0], np.cumsum(~np.asarray(frame_healthy, bool))]
    ) if frame_healthy is not None else None
    neighbor_regs = {}

    def register_batch_fn(idx_i, idx_j, yaws):
        n = len(idx_i)
        # candidate pairs + their consistency-gate neighbor pairs (i+d, j+d),
        # verified together in ONE device call; the neighbor block runs
        # WITHOUT the yaw-prior rescue (see _verify_loop_candidates)
        d_arr = np.minimum(GATE_D, n_frames - 1 - np.maximum(idx_i, idx_j))
        d_arr = np.maximum(d_arr, 0)
        all_i = np.concatenate([idx_i, idx_i + d_arr])
        all_j = np.concatenate([idx_j, idx_j + d_arr])
        all_y = np.concatenate([yaws, yaws])
        allow = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])
        Rs, ts, oks, nis = _verify_loop_candidates(
            key, stacked,
            jnp.asarray(all_i, jnp.int32), jnp.asarray(all_j, jnp.int32),
            jnp.asarray(all_y, jnp.float32), jnp.asarray(allow), loop_cfg,
        )
        Rs, ts = np.asarray(Rs), np.asarray(ts)
        oks, nis = np.asarray(oks), np.asarray(nis)
        for k in range(n):
            neighbor_regs[(int(idx_i[k]), int(idx_j[k]))] = (
                int(d_arr[k]), Rs[n + k], ts[n + k], bool(oks[n + k]))
        return Rs[:n], ts[:n], oks[:n], nis[:n]

    gate_rejects = {"drift_bound": 0, "neighbor_failed": 0,
                    "inconsistent": 0}

    def edge_gate_fn(i, j, R, t, tol_t=1.5, tol_deg=3.0):
        A_R = np.asarray(R, np.float64)
        A_t = np.asarray(t, np.float64)
        # Drift-plausibility bound: the correction a loop edge implies
        # (odometry-chained rel(i,j) vs the measured one) cannot exceed
        # plausible odometry drift over the i..j path — a generous 15% of
        # path length (real drift here is ~2%; KITTI-class odometry ~1%).
        # An aliased match between PARALLEL street canyons implies a
        # map-scale correction (measured: 83 m over a 318 m path = 26% from
        # the [171, 460] false edge) that no amount of genuine drift
        # explains, while the true circuit closure implied 13.5 m over
        # 570 m = 2.4%.
        Rij, tij = chain_rel(i, j)
        path = float(path_prefix[j] - path_prefix[i])
        allow = DRIFT_FRAC * path
        if unhealthy_prefix is not None:
            allow += BURST_ALLOW_M * float(
                unhealthy_prefix[j] - unhealthy_prefix[i])
        if np.linalg.norm(A_t - tij) > max(DRIFT_FLOOR_M, allow):
            gate_rejects["drift_bound"] += 1
            return False
        # Sequence-consistency (SeqSLAM) gate against the prior-free
        # neighbor registration
        d, R2, t2, ok2 = neighbor_regs[(i, j)]
        if d <= 0:
            return True
        if not ok2:
            gate_rejects["neighbor_failed"] += 1
            return False
        Ri, ti = chain_rel(i, i + d)
        Rj, tj = chain_rel(j, j + d)
        # predicted rel(i+d, j+d) = inv(rel(i,i+d)) o A o rel(j,j+d)
        pR = Ri.T @ A_R @ Rj
        pt = Ri.T @ (A_R @ tj + A_t - ti)
        R2 = np.asarray(R2, np.float64)
        t2 = np.asarray(t2, np.float64)
        ang = np.degrees(np.arccos(np.clip(
            (np.trace(R2.T @ pR) - 1.0) / 2.0, -1.0, 1.0)))
        ok = bool(np.linalg.norm(t2 - pt) <= tol_t and ang <= tol_deg)
        if not ok:
            gate_rejects["inconsistent"] += 1
        return ok

    # candidate/accept budgets scale with sequence length so a multi-lap
    # trajectory gets pins distributed along the WHOLE sequence — a fixed
    # 32/16 budget at 4,541 frames concentrated every pin at one circuit
    # region and left 1,000-frame chain spans unconstrained
    max_cand = int(max(32, min(256, 3 * n_frames // 32)))
    max_acc = int(max(16, n_frames // 64))
    loops = detect_and_close(stacked, register_batch_fn=register_batch_fn,
                             min_gap=min_loop_gap, use_scan_context=True,
                             max_candidates=max_cand, max_accept=max_acc,
                             edge_gate_fn=edge_gate_fn,
                             frame_valid=frame_healthy,
                             candidate_source=candidate_source)
    loop_edges = loops.edges
    n_prop = 0
    if loops.n_accepted > 0:
        # Loop PROPAGATION: an accepted, gated revisit (i, j) implies
        # candidate co-locations (i+D, j+D) at the same frame offset along
        # the whole shared segment (the vehicle retraces the path).  Place
        # recognition cannot surface these on self-similar scenes (the
        # pooled descriptor aliases, so the gates reject its proposals —
        # measured 219/231 at 4,541 frames), but as PROPAGATED hypotheses
        # they only need the geometric verification + the same
        # drift/consistency gates.  Without them the pin set stays
        # concentrated and multi-lap drift cannot collapse.
        STRIDE = max(20, min_loop_gap // 2)
        seen_pairs = set(
            (int(a), int(b)) for a, b in zip(
                np.asarray(loops.edges.edge_i), np.asarray(loops.edges.edge_j)))
        offsets = sorted(set(b - a for a, b in seen_pairs))
        cand = []
        for off in offsets:
            for i2 in range(0, n_frames - off - 1, STRIDE):
                j2 = i2 + off
                if any(abs(i2 - a) < STRIDE // 2 and abs(j2 - b) < STRIDE // 2
                       for a, b in seen_pairs):
                    continue
                cand.append((i2, j2))
                seen_pairs.add((i2, j2))
        # cap: each candidate costs 2 batched registrations (itself + its
        # consistency neighbor); 256 keeps the verification call's
        # activation memory ~2 GB
        cand = cand[:256]
        if cand:
            ci = np.asarray([a for a, _ in cand], np.int32)
            cj = np.asarray([b for _, b in cand], np.int32)
            Rs, ts, oks, nis = register_batch_fn(
                ci, cj, np.zeros(len(cand), np.float32))
            pei, pej, pR, pt_, pw = [], [], [], [], []
            for k in range(len(cand)):
                if not bool(oks[k]):
                    continue
                if not edge_gate_fn(int(ci[k]), int(cj[k]), Rs[k], ts[k]):
                    continue
                pei.append(int(ci[k]))
                pej.append(int(cj[k]))
                pR.append(np.asarray(Rs[k]))
                pt_.append(np.asarray(ts[k]))
                pw.append(float(nis[k]))
            n_prop = len(pei)
            if n_prop:
                from .backend.posegraph import PoseGraph

                prop_edges = PoseGraph(
                    edge_i=jnp.asarray(pei, jnp.int32),
                    edge_j=jnp.asarray(pej, jnp.int32),
                    rel_R=jnp.asarray(np.stack(pR)),
                    rel_t=jnp.asarray(np.stack(pt_)),
                    weight=jnp.asarray(np.asarray(pw) / 100.0),
                    rot_info=jnp.full((n_prop,), 100.0),
                )
                loop_edges = concat_graphs(loops.edges, prop_edges)

    n_loops = loops.n_accepted + n_prop
    loop_ei = np.asarray(loop_edges.edge_i, np.int32)
    loop_ej = np.asarray(loop_edges.edge_j, np.int32)
    poses_final = poses_ref
    if n_loops > 0:
        # lidar-frame world poses of the refined trajectory (computed above
        # via the calib conjugation T_world_lidar = pose @ Tr); odometry
        # edges are the refined trajectory's own rels — see note above
        R_w, t_w = W_R, W_t
        g = concat_graphs(odometry_graph(rel_Rs64, rel_ts64), loop_edges)
        if os.environ.get("CAELO_DEBUG_GRAPH"):
            np.savez(os.environ["CAELO_DEBUG_GRAPH"],
                     R_w=R_w, t_w=t_w,
                     edge_i=np.asarray(g.edge_i), edge_j=np.asarray(g.edge_j),
                     rel_R=np.asarray(g.rel_R), rel_t=np.asarray(g.rel_t),
                     weight=np.asarray(g.weight),
                     rot_info=np.asarray(g.rot_info))
        # Exact host-f64 GN (direct sparse factorization).  The matrix-free
        # device CG path needs ~N iterations on a chain-conditioned graph
        # (cond ~ N^2): at 520 frames, 8x60 CG iterations recovered <10% of
        # the loop correction (ATE 13.5 -> 12.3 m) where the exact solve
        # collapses it (measured 10.1 -> 0.30 m on the drift experiment).
        # Pose bookkeeping in host f64 is also the repo accuracy invariant.
        Ro, to, _ = optimize_host(R_w, t_w, g)
        # Sanity fallback: a diverged/degenerate solve must never replace a
        # finite trajectory with garbage (the solve is step-controlled, but
        # defense in depth — the whole downstream metric chain NaNs
        # otherwise)
        if not (np.all(np.isfinite(Ro)) and np.all(np.isfinite(to))):
            import sys

            print("pose-graph solve returned non-finite poses; keeping the "
                  "refined trajectory", file=sys.stderr)
            return poses_ref, n_loops, loop_ei, loop_ej
        # back to camera pose rows: pose = T_world_lidar @ Tr^-1
        Rti = np.asarray(R_tr).T
        tti = -Rti @ np.asarray(t_tr)
        Rc = np.einsum("nij,jk->nik", np.asarray(Ro, np.float64), Rti)
        tc = (
            np.einsum("nij,j->ni", np.asarray(Ro, np.float64), tti)
            + np.asarray(to, np.float64)
        )
        poses_final = np.asarray(rt_to_poses(jnp.asarray(Rc), jnp.asarray(tc)))
    import sys
    print(f"loop closure: {loops.n_accepted} accepted / "
          f"{loops.candidates_checked} checked + {n_prop} propagated, "
          f"rejects {loops.rejects} gate={gate_rejects}",
          file=sys.stderr)
    return poses_final, n_loops, loop_ei, loop_ej


# ----------------------------------------------------- artifact persistence
def save_stage_outputs(store: ArtifactStore, seq: str, odo: OdometryResult,
                       feats: FrameFeatures,
                       ref_feats: RefinementFeatures,
                       R_tr, t_tr) -> None:
    """Persist everything the back-end stages need: per-frame front-end
    features (the reference's ``Features/``), per-frame refinement features
    (``KeyPts/`` extended keypoints), per-pair RANSAC inliers + relative
    poses (``InliersIdx/`` + the ``poses_`` ingredients), and the calib.

    ``feats`` / ``ref_feats`` are stacked pytrees with leading axis N (the
    windowed front end's output); each field is fetched to host ONCE and
    sliced in numpy (per-frame device slicing would cost one dispatch per
    frame per field)."""
    fh = jax.tree.map(np.asarray, feats)
    rh = jax.tree.map(np.asarray, ref_feats)
    n = fh.key_pts.shape[0]
    for i in range(n):
        store.save("features", seq, i,
                   key_pts=fh.key_pts[i],
                   descriptors=fh.descriptors[i],
                   mask=fh.mask[i],
                   key_pixels=fh.key_pixels[i])
        store.save("refine_features", seq, i,
                   ext_pts=rh.ext_pts[i],
                   ext_mask=rh.ext_mask[i],
                   planar=rh.planar[i],
                   planar_mask=rh.planar_mask[i])
    for k, (i0, i1) in enumerate(odo.inlier_pairs):
        store.save("inliers", seq, k, idx0=i0, idx1=i1,
                   rel_R=odo.rel_Rs[k], rel_t=odo.rel_ts[k],
                   success=np.asarray(odo.successes[k]),
                   n_inliers=np.asarray(odo.n_inliers[k]))
    store.save("meta", seq, "calib", R_tr=np.asarray(R_tr),
               t_tr=np.asarray(t_tr), n_frames=np.asarray(n))


def load_stage_inputs(store: ArtifactStore, seq: str):
    """Reload what ``save_stage_outputs`` wrote.  Returns a dict with
    ``feats`` / ``ref_feats`` as *stacked* pytrees (leading axis N — the
    same layout the windowed front end produces; one host->device transfer
    per field), plus ``inlier_pairs``, ``rel_Rs``, ``rel_ts``,
    ``successes``, ``R_tr``, ``t_tr``, ``n_frames``."""
    calib = store.load("meta", seq, "calib")
    n = int(calib["n_frames"])
    fcols = {k: [] for k in ("key_pts", "descriptors", "mask", "key_pixels")}
    rcols = {k: [] for k in ("ext_pts", "ext_mask", "planar", "planar_mask")}
    pairs, rel_Rs, rel_ts, succ = [], [], [], []
    for i in range(n):
        z = store.load("features", seq, i)
        for k in fcols:
            fcols[k].append(z[k])
        z = store.load("refine_features", seq, i)
        for k in rcols:
            rcols[k].append(z[k])
    feats = FrameFeatures(
        **{k: jnp.asarray(np.stack(v)) for k, v in fcols.items()})
    ref_feats = RefinementFeatures(
        **{k: jnp.asarray(np.stack(v)) for k, v in rcols.items()})
    for k in range(n - 1):
        z = store.load("inliers", seq, k)
        pairs.append((z["idx0"], z["idx1"]))
        rel_Rs.append(z["rel_R"])
        rel_ts.append(z["rel_t"])
        succ.append(bool(z["success"]))
    return dict(
        feats=feats, ref_feats=ref_feats, inlier_pairs=pairs,
        rel_Rs=np.asarray(rel_Rs).reshape(-1, 3, 3),
        rel_ts=np.asarray(rel_ts).reshape(-1, 3),
        successes=np.asarray(succ, bool),
        R_tr=calib["R_tr"], t_tr=calib["t_tr"], n_frames=n,
    )


def preprocess_to_store(scans, respond_params, encoder_params, R_tr, t_tr,
                        cfg: PipelineConfig, store: ArtifactStore, seq: str,
                        seed: int = 0, window: int = 16,
                        progress=None) -> OdometryResult:
    """Front-end pass that persists every artifact the back end needs
    (the reference's ``BatchPreprocess`` + ``PoseEstimation`` stages)."""
    from .frontend.odometry import run_odometry_windowed

    scans = list(scans)
    odo, feats, ref_feats = run_odometry_windowed(
        scans, respond_params, encoder_params, R_tr, t_tr, cfg,
        window=min(window, len(scans)), seed=seed,
        keep_refine_features=True, progress=progress,
    )
    save_stage_outputs(store, seq, odo, feats, ref_feats, R_tr, t_tr)
    return odo


# ------------------------------------------------------------ full pipeline
def run_full_pipeline(scans: Iterable, respond_params, encoder_params,
                      R_tr=None, t_tr=None,
                      cfg: PipelineConfig = PipelineConfig(),
                      enable_refinement: bool = True,
                      enable_loop_closure: bool = True,
                      min_loop_gap: int = 100,
                      seed: int = 0,
                      batched_refine: bool = True,
                      timer: Optional[StageTimer] = None,
                      metrics: Optional[MetricsLog] = None,
                      window: int = 16,
                      candidate_source: str = "descriptor",
                      ) -> FullPipelineResult:
    """End-to-end odometry stack.  ``window`` is the fused front-end window
    size (frames per jitted device program); the degraded-rescue benchmark
    must be re-validated across seeds before changing the default (the
    per-window RNG re-rolls with the window size — see CLAUDE.md)."""
    if R_tr is None:
        R_tr = np.eye(3)
    if t_tr is None:
        t_tr = np.zeros(3)
    # A disk-backed sequence (data.scancache.NpyScanReader) is consumed
    # in place — forcing a list would materialize the whole sequence
    # (~9.5 GB at 4,541 frames) in host RAM
    if not (hasattr(scans, "__getitem__") and hasattr(scans, "__len__")):
        scans = list(scans)
    timer = timer or StageTimer(sync=False)

    # Per-frame sensor-health gate: a frame with far fewer returns than the
    # sequence median (dropout burst, occluded sector, sensor fault) can
    # still produce a high-inlier RANSAC consensus — on sparse aliased
    # structure the consensus is confidently WRONG (measured on the
    # degraded 520-frame benchmark: front-end self-reported success 97.1%
    # vs 85.0% true).  Unhealthy frames therefore cannot confer "trusted"
    # status on their pairs (so refinement re-registers them) and are
    # excluded from loop-closure place recognition.
    if hasattr(scans, "mask"):
        n_valid = np.array([int(scans.mask(i).sum())
                            for i in range(len(scans))])
    else:
        n_valid = np.array([int(np.asarray(m).sum()) for _, m in scans])
    healthy = n_valid >= 0.5 * np.median(n_valid)

    # ---- stage 1: odometry front end (windowed: one jitted program per
    # 16-frame window; features kept for loop closure; refinement features
    # produced by the SAME window program — no second front-end pass)
    from .frontend.odometry import run_odometry_windowed

    with timer.stage("frontend"):
        if enable_refinement:
            odo, feats, ref_feats = run_odometry_windowed(
                scans, respond_params, encoder_params, R_tr, t_tr, cfg,
                window=min(window, len(scans)), seed=seed,
                keep_refine_features=True,
            )
        else:
            odo, feats = run_odometry_windowed(
                scans, respond_params, encoder_params, R_tr, t_tr, cfg,
                window=min(window, len(scans)), seed=seed,
                keep_features=True,
            )
            ref_feats = None
    poses_raw = odo.poses
    if metrics:
        metrics.log("frontend", frames=len(scans),
                    pair_success_rate=float(odo.successes.mean()),
                    mean_inliers=float(odo.n_inliers.mean()))

    pair_trusted = odo.successes & healthy[:-1] & healthy[1:]

    # ---- stage 2: de-jump (FixJumpPoses), gated on the front end's own
    # per-pair evidence: successful high-inlier registrations on HEALTHY
    # frames are real motion, not jumps (see fix_jump_poses docstring)
    with timer.stage("dejump"):
        poses_dj, dejumped = refine.fix_jump_poses(
            poses_raw, cfg.refine, pair_trusted=pair_trusted)
    if metrics:
        metrics.log("dejump", fixed=len(dejumped))

    # ---- stage 3: keyframe-transfer ICP refinement (features reused from
    # stage 1's window program — the reference reloads KeyPts/*.mat here,
    # RefinePoses.py:276-277)
    # Pairs inside qualifying degradation bursts are EXCLUDED from the
    # pairwise refine pass: consecutive burst frames see the same
    # sensor-locked wedge, so pairwise re-registration there is degenerate
    # — it can corrupt a front-end chain that SURVIVED the burst (measured
    # at one RNG seed: the refine pass dragged the span chain 20 m /
    # 30 deg off the verified anchor closure while the dejumped global ATE
    # sat at the clean-circuit bound).  Stage 3b (burst rescue) owns those
    # spans: scan-to-local-map solves plus anchor-closure evidence.
    refine_trusted = pair_trusted
    if enable_refinement and not np.all(healthy):
        from .backend.burst import find_burst_spans

        bspans = find_burst_spans(healthy)
        if bspans:
            refine_trusted = pair_trusted.copy()
            for (_a, _b) in bspans:
                refine_trusted[_a:_b] = True
    if enable_refinement:
        with timer.stage("refine"):
            poses_ref, stats = stage_refinement(
                poses_dj, ref_feats, odo.inlier_pairs, R_tr, t_tr, cfg,
                batched=batched_refine, pair_trusted=refine_trusted,
            )
        if metrics:
            metrics.log("refine", refined=len(stats.refined),
                        failed=len(stats.failed),
                        rejected=len(stats.rejected))
    else:
        poses_ref, stats = poses_dj, refine.RefineStats()

    # ---- stage 3b: multi-frame burst rescue.  Long unhealthy runs (a
    # degradation burst through a turn) are informationally marginal for
    # PAIRWISE registration — consecutive degraded frames see nearly the
    # same sensor-locked wedge — so re-register each burst frame against a
    # progressively accumulated local map anchored at the healthy entry
    # frame (backend.burst); acceptance uses the same residual-gain
    # evidence gate as pairwise refinement.
    burst_stats = None
    if enable_refinement and not np.all(healthy):
        from .backend.burst import rescue_bursts

        def rel_lidar_fn(p0, p1):
            from .geometry.kitti_pose import rel_pose_lidar

            R, t = rel_pose_lidar(
                jnp.asarray(p0), jnp.asarray(p1),
                jnp.asarray(R_tr, jnp.float64),
                jnp.asarray(t_tr, jnp.float64))
            return np.asarray(R), np.asarray(t)

        def apply_rel_fn(pose0, relR, relT):
            dR, dt = lidar_rel_to_cam(
                jnp.asarray(relR), jnp.asarray(relT),
                jnp.asarray(R_tr, jnp.float64),
                jnp.asarray(t_tr, jnp.float64))
            R0, t0 = refine._rt(pose0)
            return refine._row(R0 @ np.asarray(dR), R0 @ np.asarray(dt) + t0)

        # Anchor-to-anchor closure via the descriptor front end: a
        # prior-seeded RANSAC registration of the two healthy full-view
        # anchors (precise + inlier-verified; the map-ICP endpoint can
        # drift laterally on long straight spans while "converging")
        akey = jax.random.key(seed + 31)

        # anchors sit a full burst apart (~30-50 m): fewer co-visible
        # keypoints than consecutive frames, so the absolute inlier floor
        # relaxes to 60 — the result is additionally chain-agreement
        # checked in rescue_bursts
        anchor_cfg = dataclasses.replace(
            cfg, ransac=dataclasses.replace(cfg.ransac, min_inlier_abs=60))

        def anchor_register_fn(i, j, R_prior, t_prior):
            from .frontend.registration import register_pair_with_prior

            f_i = jax.tree.map(lambda x: x[int(i)], feats)
            f_j = jax.tree.map(lambda x: x[int(j)], feats)
            reg = register_pair_with_prior(
                jax.random.fold_in(akey, int(i)), f_i, f_j,
                jnp.asarray(R_prior, jnp.float32),
                jnp.asarray(t_prior, jnp.float32), anchor_cfg, gate_m=5.0)
            return (np.asarray(reg.R, np.float64),
                    np.asarray(reg.t, np.float64), bool(reg.success),
                    int(reg.n_inliers))

        from .backend.refine_runner import make_batched_icp_fn

        with timer.stage("burst_rescue"):
            poses_ref, burst_stats = rescue_bursts(
                poses_ref, ref_feats, healthy, rel_lidar_fn, apply_rel_fn,
                cfg, anchor_register_fn=anchor_register_fn,
                pair_icp_fn=make_batched_icp_fn(ref_feats, cfg))
        if burst_stats.spans:
            import sys

            print(f"burst rescue: spans {burst_stats.spans} accepted "
                  f"{burst_stats.accepted} closures {burst_stats.closures}",
                  file=sys.stderr)
        if metrics and burst_stats.spans:
            metrics.log("burst_rescue", spans=len(burst_stats.spans),
                        accepted=len(burst_stats.accepted))

    # ---- stage 4: loop closure + pose-graph solve (lidar-frame graph)
    n_loops = 0
    poses_final = poses_ref
    loop_ei = np.zeros(0, np.int32)
    loop_ej = np.zeros(0, np.int32)
    if enable_loop_closure and len(scans) > min_loop_gap:
        with timer.stage("loop_closure"):
            poses_final, n_loops, loop_ei, loop_ej = stage_loop_closure(
                poses_ref, feats, odo.rel_Rs, odo.rel_ts, R_tr, t_tr, cfg,
                min_loop_gap=min_loop_gap, seed=seed,
                frame_healthy=healthy, candidate_source=candidate_source,
            )
        if metrics:
            metrics.log("loop_closure", accepted=n_loops)

    return FullPipelineResult(
        poses_raw=poses_raw,
        poses_dejumped=poses_dj,
        poses_refined=poses_ref,
        poses_final=poses_final,
        odometry=odo,
        dejumped_frames=dejumped,
        refine_stats=stats,
        n_loop_closures=n_loops,
        loop_edge_i=loop_ei,
        loop_edge_j=loop_ej,
        burst_stats=burst_stats,
    )
