"""Multi-frame burst rescue: scan-to-local-map registration over degraded
sensor spans.

The pairwise rescue ladder (``refine.refine_odometry_batched`` pass 3) is
informationally marginal when a heavy degradation burst (0.8 dropout + a
140 deg occluded wedge) crosses a turn: CONSECUTIVE degraded frames see
nearly the same narrow sensor-locked wedge, so descriptor RANSAC and dense
pairwise ICP converge to the same biased optimum (measured: 82
re-registrations moved ATE only 49.5 -> 45.8 m).  This module uses the
information the pairwise path cannot: across the burst the visible wedge
SWEEPS different world structure (the sensor turns), so the union of the
burst's frames — anchored by the healthy frame before it — covers a far
wider field of view than any single frame.

``burst_map_icp`` registers each burst frame against a progressively
accumulated local map in the entry anchor's frame (the classic
scan-to-submap odometry formulation, as fixed-shape batched programs):

* the whole span solves in ONE jitted ``lax.scan`` over a static
  ``max_span`` — per-frame ICP is a fixed-trip ``fori_loop`` whose
  correspondence search is the chunked distance matmul of ``backend.icp``;
* the map is a fixed-capacity point buffer; each registered frame scatters
  a fixed-size subsample at its own slot (no dynamic shapes);
* each frame's result carries the same ``init_res``/``final_res``
  saturated-residual pair as the pairwise ICP, so the caller applies the
  SAME evidence-based residual-gain acceptance
  (``RefineConfig.residual_gain_frac``).

The reference has no analog — its hybrid ICP (``MyICP.py:127-201``) is
strictly pairwise; this extends the same machinery to the regime where
pairwise evidence is degenerate (VERDICT r4 item 2).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import IcpConfig, PipelineConfig
from ..geometry import se3
from .icp import _RES_CAP, _sat_mean, nearest_neighbors


@functools.partial(jax.jit, static_argnames=("icp_cfg", "max_span",
                                             "frame_budget"))
def burst_map_icp(ext_pts: jnp.ndarray, ext_mask: jnp.ndarray,
                  rel_Rs: jnp.ndarray, rel_ts: jnp.ndarray,
                  span_len: jnp.ndarray,
                  icp_cfg: IcpConfig = IcpConfig(),
                  max_span: int = 64, frame_budget: int = 2048,
                  thr_scale=2.0):
    """Joint registration of frames 1..span_len against a growing local map
    in frame 0's coordinates.

    Args:
      ext_pts: ``(max_span + 1, E, 3)`` extended refinement clouds — frame 0
        is the healthy ENTRY anchor, frames ``1..span_len`` the burst
        interior plus the healthy EXIT anchor as the last active frame.
      ext_mask: ``(max_span + 1, E)`` validity.
      rel_Rs/rel_ts: ``(max_span, 3, 3) / (max_span, 3)`` initial relative
        poses (lidar frame, k -> k+1 mapping frame k+1 into frame k) from
        the current trajectory.
      span_len: traced int — number of ACTIVE pairs (<= max_span); inactive
        tail slots pass their input rels through untouched.
      thr_scale: coarse initial-gate widening (the burst entered this path
        because its initial guess may be meters off through a turn).

    Returns ``(new_rel_Rs, new_rel_ts, ok, init_res, final_res)``: per-pair
    corrected rels (input rels where inactive or failed), per-frame ICP
    success, and per-frame saturated map residuals at the initial vs final
    pose for the residual-gain acceptance gate.
    """
    E = ext_pts.shape[1]
    # map layout: [anchor frame 0, full resolution E][frame k slots of
    # frame_budget each, k = 1..max_span] — regions never overlap
    map_cap = E + frame_budget * max_span

    map_pts = jnp.zeros((map_cap, 3), ext_pts.dtype)
    map_msk = jnp.zeros((map_cap,), bool)
    map_pts = jax.lax.dynamic_update_slice(map_pts, ext_pts[0], (0, 0))
    map_msk = jax.lax.dynamic_update_slice(map_msk, ext_mask[0], (0,))

    # fixed even subsample of each frame's VALID prefix for map insertion
    def subsample(pts, msk):
        n_valid = jnp.maximum(jnp.sum(msk), 1)
        ridx = (jnp.arange(frame_budget, dtype=jnp.int32)
                * n_valid.astype(jnp.int32)) // jnp.int32(frame_budget)
        uniq = jnp.concatenate([jnp.ones((1,), bool),
                                ridx[1:] != ridx[:-1]])
        return pts[ridx], msk[ridx] & uniq

    def icp_vs_map(pc, msk, mpts, mmsk, R0, t0):
        """Fixed-trip point-to-point ICP of cloud (R0,t0)-transformed onto
        the map; returns the composed pose + residual diagnostics.

        The inlier gate is RANGE-PROPORTIONAL: ``dist < max(thr,
        range * thr/GATE_RANGE)``.  A narrow-wedge degraded frame observes
        rotation mostly through its far points (a yaw error d maps to a
        range*d offset), but a flat metric gate excludes exactly those
        correspondences while the rotation error is still large — the
        solve then absorbs the rotation error into translation (measured
        on the wedge probe: 6 deg init stuck at 4.3 deg / 0.5 m with the
        flat gate; recovered with the proportional one).  The decay
        schedule shrinks both terms together, so convergence is as tight
        as the flat gate's."""
        pc_w = se3.apply(R0, t0, pc)
        # sensor-frame ranges are pose-invariant: compute once
        ranges = jnp.linalg.norm(pc, axis=-1)
        GATE_RANGE = 10.0     # metres at which the angular term = thr

        def body(i, st):
            R, t, pcc, thr, done, n_in, r0m, rlast = st
            idx, dist = nearest_neighbors(pcc, msk, mpts, mmsk)
            res = _sat_mean(dist, msk)
            r0m = jnp.where(i == 0, res, r0m)
            rlast = jnp.where(done, rlast, res)
            gate = jnp.maximum(thr, ranges * (thr / GATE_RANGE))
            w = ((dist < gate) & msk).astype(jnp.float32)
            n = jnp.sum(w).astype(jnp.int32)
            enough = n >= icp_cfg.min_inliers
            Rd, td = se3.solve_rigid_horn(mpts[idx], pcc, w)
            step_ok = (~done) & enough
            Rd = jnp.where(step_ok, Rd,
                           jnp.eye(3, dtype=R.dtype)).astype(R.dtype)
            td = jnp.where(step_ok, td, 0.0).astype(t.dtype)
            pcc = se3.apply(Rd, td, pcc)
            R, t = se3.compose(Rd, td, R, t)
            d_ang = jnp.linalg.norm(se3.rotmat_to_euler_xyz_deg(Rd))
            d_t = jnp.linalg.norm(td)
            converged = ((i >= icp_cfg.max_iters // 2)
                         & (d_ang < icp_cfg.epsilon)
                         & (d_t < icp_cfg.epsilon))
            small = ((d_ang < icp_cfg.small_shift_threshold)
                     & (d_t < icp_cfg.small_shift_threshold))
            thr = jnp.where(step_ok & small, thr * icp_cfg.decay, thr)
            n_in = jnp.where(step_ok, n, n_in)
            done = done | converged | (~enough)
            return (R, t, pcc, thr, done, n_in, r0m, rlast)

        st = (jnp.eye(3, dtype=pc.dtype), jnp.zeros((3,), pc.dtype),
              pc_w,
              jnp.asarray(icp_cfg.inlier_threshold * thr_scale, pc.dtype),
              jnp.asarray(False), jnp.asarray(0, jnp.int32),
              jnp.float32(0.0), jnp.float32(0.0))
        Rd, td, _, _, _, n_in, r0m, rlast = jax.lax.fori_loop(
            0, icp_cfg.max_iters, body, st)
        ok = n_in >= icp_cfg.min_inliers
        # composed frame->map pose, re-projected to SO(3): the whole span
        # chains these on DEVICE, so bf16-matmul-pass drift must be
        # squashed per frame (see se3.compose)
        Rn, tn = se3.compose(Rd, td, R0, t0)
        return se3.project_so3(Rn), tn, ok, r0m, rlast

    def insert(map_pts, map_msk, k, pc, msk, Rn, tn, active):
        """Write frame k's transformed subsample at its fixed slot."""
        sub, submsk = subsample(pc, msk)
        sub_w = se3.apply(Rn, tn, sub)
        off = E + (k - 1) * frame_budget
        map_pts = jax.lax.dynamic_update_slice(map_pts, sub_w, (off, 0))
        map_msk = jax.lax.dynamic_update_slice(
            map_msk, submsk & active, (off,))
        return map_pts, map_msk

    # ---- sweep 1: forward accumulation — frame k registers against the
    # map built from frames 0..k-1, then joins it
    def build_step(carry, k):
        map_pts, map_msk, R_prev, t_prev, R_all, t_all = carry
        active = k <= span_len
        pc = ext_pts[k]
        msk = ext_mask[k] & active
        # initial guess: previous solved pose composed with the input rel
        R0, t0 = se3.compose(R_prev, t_prev, rel_Rs[k - 1], rel_ts[k - 1])
        Rn, tn, ok, r0m, rlast = icp_vs_map(pc, msk, map_pts, map_msk,
                                            R0, t0)
        use = ok & active
        Rn = jnp.where(use, Rn, R0)
        tn = jnp.where(use, tn, t0)
        map_pts, map_msk = insert(map_pts, map_msk, k, pc, ext_mask[k],
                                  Rn, tn, active)
        R_all = R_all.at[k].set(Rn)
        t_all = t_all.at[k].set(tn)
        return ((map_pts, map_msk, Rn, tn, R_all, t_all),
                (use, r0m, rlast))

    R_all = jnp.tile(jnp.eye(3, dtype=ext_pts.dtype),
                     (max_span + 1, 1, 1))
    t_all = jnp.zeros((max_span + 1, 3), ext_pts.dtype)
    init = (map_pts, map_msk, jnp.eye(3, dtype=ext_pts.dtype),
            jnp.zeros((3,), ext_pts.dtype), R_all, t_all)
    carry, (oks, _, _) = jax.lax.scan(
        build_step, init, jnp.arange(1, max_span + 1))
    map_pts, map_msk, _, _, R_all, t_all = carry

    # ---- sweep 2: polish against the COMPLETE map.  Early burst frames
    # registered against a sparse map (just the entry anchor); now every
    # frame sees the union of all frames' wedges — the cross-burst
    # information pairwise registration cannot use.  Each frame's own slot
    # is masked out of the reference (a cloud trivially matches its own
    # copy at zero residual), and its slot is rewritten at the updated
    # pose afterwards.
    ii = jnp.arange(map_cap, dtype=jnp.int32)
    slot_ids = jnp.where(ii < E, 0, 1 + (ii - E) // frame_budget)

    # input-trajectory pose chain (for the residual-gain gate: both sides
    # of the gain must be measured against the SAME reference — the
    # complete map — else the gain conflates pose improvement with map
    # densification)
    def chain(carry, rt):
        Rp, tp = carry
        Rn, tn = se3.compose(Rp, tp, rt[0], rt[1])
        return (Rn, tn), (Rn, tn)

    _, (Rin_all, tin_all) = jax.lax.scan(
        chain, (jnp.eye(3, dtype=ext_pts.dtype),
                jnp.zeros((3,), ext_pts.dtype)), (rel_Rs, rel_ts))

    def polish_step(carry, k):
        map_pts, map_msk, R_all, t_all = carry
        active = k <= span_len
        pc = ext_pts[k]
        msk = ext_mask[k] & active
        ref_msk = map_msk & (slot_ids != k)
        # residual at the INPUT pose vs the same complete map
        pc_in = se3.apply(Rin_all[k - 1], tin_all[k - 1], pc)
        _, dist0 = nearest_neighbors(pc_in, msk, map_pts, ref_msk)
        r0m = _sat_mean(dist0, msk)
        Rn, tn, ok, _, rlast = icp_vs_map(
            pc, msk, map_pts, ref_msk, R_all[k], t_all[k])
        use = ok & active
        Rn = jnp.where(use, Rn, R_all[k])
        tn = jnp.where(use, tn, t_all[k])
        map_pts, map_msk = insert(map_pts, map_msk, k, pc, ext_mask[k],
                                  Rn, tn, active)
        R_all = R_all.at[k].set(Rn)
        t_all = t_all.at[k].set(tn)
        return (map_pts, map_msk, R_all, t_all), (use, r0m, rlast)

    (map_pts, map_msk, R_all, t_all), (oks2, r0s, _) = jax.lax.scan(
        polish_step, (map_pts, map_msk, R_all, t_all),
        jnp.arange(1, max_span + 1))

    # ---- mid-closure: register the exit anchor against the entry-anchor
    # reference NOW, distribute the endpoint delta smoothly over the span
    # ON DEVICE (rotation-vector interpolation), rebuild the map at the
    # corrected poses, and polish once more.  The first polish leaves the
    # span internally consistent but smoothly bowed (each frame's absolute
    # evidence is its biased wedge); polishing against a globally-anchored
    # map straightens the interior, which endpoint-only distribution
    # cannot.
    frac = (jnp.clip(jnp.arange(max_span + 1, dtype=jnp.float32)
                     / jnp.maximum(span_len.astype(jnp.float32), 1.0),
                     0.0, 1.0))
    r1s = None
    for _round in range(2):
        Rl_m, tl_m, okl_m, _, _ = icp_vs_map(
            ext_pts[span_len], ext_mask[span_len],
            map_pts, map_msk & (slot_ids == 0),
            R_all[span_len], t_all[span_len])
        RL, tL = R_all[span_len], t_all[span_len]
        d_rotvec = se3.log_so3(jnp.einsum(
            "ji,jk->ik", RL, Rl_m, precision=jax.lax.Precision.HIGHEST))
        d_t = tl_m - tL
        Rcorr = jax.vmap(se3.exp_so3)(d_rotvec[None, :] * frac[:, None])
        R_dist = se3.project_so3(jnp.einsum(
            "kij,kjl->kil", R_all, Rcorr,
            precision=jax.lax.Precision.HIGHEST))
        t_dist = t_all + d_t[None, :] * frac[:, None]
        R_all = jnp.where(okl_m, R_dist, R_all)
        t_all = jnp.where(okl_m, t_dist, t_all)

        # rebuild the map at the corrected poses (insert-only scan)
        def rebuild_step(carry, k):
            map_pts, map_msk = carry
            active = k <= span_len
            map_pts, map_msk = insert(map_pts, map_msk, k, ext_pts[k],
                                      ext_mask[k], R_all[k], t_all[k],
                                      active)
            return (map_pts, map_msk), None

        (map_pts, map_msk), _ = jax.lax.scan(
            rebuild_step, (map_pts, map_msk), jnp.arange(1, max_span + 1))

        (map_pts, map_msk, R_all, t_all), (oks3, _, r1s) = jax.lax.scan(
            polish_step, (map_pts, map_msk, R_all, t_all),
            jnp.arange(1, max_span + 1))
        oks2 = oks2 | oks3

    # ---- sweep 3: healthy-to-healthy span closure.  The burst block can
    # end internally consistent but rigidly offset from the world (each
    # wedge frame's anchor evidence is individually biased, and the
    # self-map outvotes the anchors — measured: interior rels exact to
    # 0.02-0.08 deg while the block sat 1.8 m off).  The exit anchor and
    # the entry anchor are both FULL-VIEW healthy frames, so their direct
    # registration (exit cloud vs the anchor-only reference) is the one
    # unbiased absolute measurement available; the caller distributes the
    # chain-vs-closure mismatch smoothly over the span
    # (``rescue_bursts``, backward_update-style).
    anchor_ref = map_msk & (slot_ids == 0)
    exit_pc = ext_pts[span_len]
    exit_msk = ext_mask[span_len]
    R_cl, t_cl, ok_cl, _, cl_res = icp_vs_map(
        exit_pc, exit_msk, map_pts, anchor_ref,
        R_all[span_len], t_all[span_len])

    # rels from the solved pose chain: rel(k-1->k) = T_{k-1}^-1 T_k.
    # HIGHEST precision: default bf16 matmul passes put ~1e-2 of
    # non-orthogonality into the rels (see se3.compose)
    Rp, tp = R_all[:-1], t_all[:-1]
    Rn_, tn_ = R_all[1:], t_all[1:]
    rRs = jnp.einsum("kji,kjl->kil", Rp, Rn_,
                     precision=jax.lax.Precision.HIGHEST)
    rTs = jnp.einsum("kji,kj->ki", Rp, tn_ - tp,
                     precision=jax.lax.Precision.HIGHEST)
    # inactive pairs pass input rels through
    active = jnp.arange(max_span) < span_len
    rRs = jnp.where(active[:, None, None], rRs, rel_Rs)
    rTs = jnp.where(active[:, None], rTs, rel_ts)
    # r0s/r1s: residual at the input vs final pose, BOTH against the
    # complete self-excluded map (sweep 2) — the residual-gain evidence
    return (rRs, rTs, (oks | oks2) & active, r0s, r1s,
            R_cl, t_cl, ok_cl, cl_res)


@dataclasses.dataclass
class BurstStats:
    spans: List = dataclasses.field(default_factory=list)      # (a, b)
    accepted: List = dataclasses.field(default_factory=list)
    rejected: List = dataclasses.field(default_factory=list)
    gains: List = dataclasses.field(default_factory=list)      # (r0, r1)
    # per span: the accepted closure evidence ("descriptor(N)" /
    # "icp(res)" / None)
    closures: List = dataclasses.field(default_factory=list)


def find_burst_spans(healthy: np.ndarray, min_burst: int = 4,
                     max_span: int = 62):
    """Maximal runs of consecutive UNHEALTHY frames, extended by one
    healthy anchor on each side.  Returns [(a, b)] frame spans (b
    inclusive); runs longer than ``max_span - 1`` are split."""
    healthy = np.asarray(healthy, bool)
    n = len(healthy)
    spans = []
    i = 0
    while i < n:
        if healthy[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and not healthy[j + 1]:
            j += 1
        if j - i + 1 >= min_burst:
            a = max(i - 1, 0)
            b = min(j + 1, n - 1)
            while b - a > max_span:
                spans.append((a, a + max_span))
                a = a + max_span
            if b > a:
                spans.append((a, b))
        i = j + 1
    return spans


def rescue_bursts(poses, ref_feats, healthy, rel_lidar_fn, apply_rel_fn,
                  cfg: PipelineConfig, min_burst: int = 4,
                  max_span: int = 62, thr_scale: float = 2.0,
                  anchor_register_fn=None, pair_icp_fn=None):
    """Apply burst map-ICP rescue to every qualifying unhealthy span of a
    refined trajectory.  One device call per burst span; acceptance is the
    same residual-gain evidence gate as pairwise refinement
    (``RefineConfig.residual_gain_frac`` over the span's MEAN residuals).

    Returns ``(poses, BurstStats)`` — poses unchanged where no span
    qualifies or gains.
    """
    from .refine import _all_rels, _rt, _row

    spans = find_burst_spans(healthy, min_burst=min_burst,
                             max_span=max_span)
    stats = BurstStats(spans=list(spans))
    if not spans:
        return poses, stats
    poses = np.asarray(poses, np.float64).copy()
    rcfg = cfg.refine
    buckets = [b for b in (16, 32, 48, 62) if b <= max_span] or [max_span]
    frame_budget = min(2048, cfg.icp.max_points)
    for (a, b) in spans:
        L = b - a                       # active pairs
        # bucket the static span size so distinct bursts share compiles
        ms = next((m for m in buckets if m >= L), max_span)
        pad = ms + 1 - (L + 1)
        idx = np.concatenate([np.arange(a, b + 1),
                              np.full(pad, b)]).astype(np.int32)
        fp = jax.tree.map(lambda x: x[jnp.asarray(idx)], ref_feats)
        rels = [rel_lidar_fn(poses[k], poses[k + 1]) for k in range(a, b)]
        relR = np.stack([r for r, _ in rels]
                        + [np.eye(3)] * (ms - L)).astype(np.float32)
        relT = np.stack([t for _, t in rels]
                        + [np.zeros(3)] * (ms - L)).astype(np.float32)
        (rRs, rTs, oks, r0s, r1s,
         R_cl, t_cl, ok_cl, cl_res) = burst_map_icp(
            fp.ext_pts, fp.ext_mask, jnp.asarray(relR), jnp.asarray(relT),
            jnp.asarray(L, jnp.int32), icp_cfg=cfg.icp, max_span=ms,
            frame_budget=frame_budget, thr_scale=thr_scale)
        oks = np.asarray(oks)[:L]
        r0 = float(np.asarray(r0s)[:L][oks].mean()) if oks.any() else 0.0
        r1 = float(np.asarray(r1s)[:L][oks].mean()) if oks.any() else 0.0
        stats.gains.append((r0, r1))
        nR = np.asarray(rRs, np.float64)[:L]
        nT = np.asarray(rTs, np.float64)[:L]
        # Healthy-to-healthy closure: the block-offset repair's evidence.
        # Two sources, by precision:
        #   1. descriptor RANSAC between the two anchors, seeded with the
        #      solved chain as a motion prior — precise and independently
        #      verified by its inlier consensus (the map-ICP endpoint on a
        #      long straight span can drift metres laterally while still
        #      "converging": measured, it dragged a good input trajectory
        #      from ATE 13.2 to 20.2);
        #   2. the map-ICP exit registration, accepted only when its
        #      converged residual is tight (<= 0.35 m).
        # Either way the implied correction must stay within the
        # plausibility bound (20% of span path).
        closure_ok = False
        closure_src = None
        cum = [(np.eye(3), np.zeros(3))]
        for k in range(L):
            Ck, ck = cum[-1]
            cum.append((Ck @ nR[k], Ck @ nT[k] + ck))
        Rc, tc = cum[L]
        path = float(np.sum(np.linalg.norm(nT, axis=1)))
        bound = max(1.0, 0.2 * path)
        R_cl = np.asarray(R_cl, np.float64)
        t_cl = np.asarray(t_cl, np.float64)
        okd, n_inl, d_miss = False, 0, -1.0
        if anchor_register_fn is not None and oks.all():
            # prior = the best available absolute estimate of rel(a, b)
            pR, pt = (R_cl, t_cl) if bool(ok_cl) else (Rc, tc)
            Rd, td, okd, n_inl = anchor_register_fn(a, b, pR, pt)
            d_miss = float(np.linalg.norm(np.asarray(td) - tc))
            # the descriptor closure is self-verified by its inlier
            # consensus; the chain-agreement bound only needs to exclude
            # aliased matches (measured: a 72 m off-consensus at one
            # seed), not genuine block offsets on short spans — floor 3 m,
            # cap 12 m
            if okd and d_miss <= float(np.clip(0.2 * path, 3.0, 12.0)):
                R_cl = np.asarray(Rd, np.float64)
                t_cl = np.asarray(td, np.float64)
                closure_ok = True
                closure_src = f"descriptor({int(n_inl)})"
        if (not closure_ok and bool(ok_cl) and oks.all()
                and float(cl_res) <= 0.35
                and np.linalg.norm(t_cl - tc) <= bound):
            closure_ok = True
            closure_src = f"icp({float(cl_res):.2f})"
        if closure_ok and pair_icp_fn is not None:
            # Dense polish of the anchor closure.  The closure rel is the
            # rescue's referee AND becomes the span's endpoint — it
            # re-chains the whole downstream trajectory, so its ROTATION
            # precision is the lever (0.5 deg swings a 300 m tail metres;
            # measured: refined ATE varied 13.3-18.8 across RNG seeds
            # purely with the closure draw).  Both anchors are healthy
            # full-view frames, so hybrid pairwise ICP seeded at the
            # RANSAC estimate pins the rel far tighter than the sparse
            # descriptor consensus.  Small corrections only: it must
            # refine the closure, not re-register it.
            pdR, pdt, pok, _, _ = pair_icp_fn(
                np.array([a], np.int32), np.array([b], np.int32),
                R_cl[None].astype(np.float32),
                t_cl[None].astype(np.float32), thr_scale=2.0)
            pR0 = np.asarray(pdR[0], np.float64)
            pt0 = np.asarray(pdt[0], np.float64)
            pang = float(np.degrees(np.arccos(np.clip(
                (np.trace(pR0) - 1.0) / 2.0, -1.0, 1.0))))
            pmag = float(np.linalg.norm(pt0))
            if bool(pok[0]) and pang <= 2.0 and pmag <= 2.0:
                R_cl = pR0 @ R_cl
                t_cl = pR0 @ t_cl + pt0
                closure_src += f"+polish({pang:.2f}d,{pmag:.2f}m)"
        if closure_src is None:
            # diagnostic record of WHY both sources were refused
            closure_src = (f"none(desc_ok={bool(okd)},ni={int(n_inl)},"
                           f"dmiss={d_miss:.1f},icp_ok={bool(ok_cl)},"
                           f"res={float(cl_res):.2f},"
                           f"imiss={float(np.linalg.norm(t_cl - tc)):.1f})")
            stats.closures.append((a, b, closure_src))
            closure_src = None
        # Comparative acceptance (the closure referees the INCUMBENT too):
        # the map solution's residual gain only says it fits its own
        # progressively built map better than the incumbent did — on
        # sensor-locked wedges that map is itself biased, so the gain
        # cannot detect that the incumbent was already RIGHT.  The
        # verified full-view anchor closure can: if the incumbent chain's
        # endpoint already agrees with it, the incumbent's absolute
        # placement is correct and splicing in the map solution can only
        # inject interior bias (measured across RNG seeds: the same
        # replacement that repairs a 25.6 m trajectory to 18.8 drags a
        # lucky 13.2 m draw to 18.3).  Keep the incumbent rels and only
        # redistribute the (small) closure miss over the span.
        incumbent_kept = False
        RcI, tcI = np.eye(3), np.zeros(3)
        for k in range(L):
            RcI, tcI = (RcI @ np.asarray(relR[k], np.float64),
                        RcI @ np.asarray(relT[k], np.float64) + tcI)
        if closure_ok:
            missI = float(np.linalg.norm(t_cl - tcI))
            angI = float(np.degrees(np.arccos(np.clip(
                (np.trace(RcI.T @ R_cl) - 1.0) / 2.0, -1.0, 1.0))))
            import sys
            print(f"burst span ({a}, {b}): incumbent-vs-closure miss "
                  f"{missI:.2f} m / {angI:.2f} deg (keep bound "
                  f"{max(2.0, 0.04 * path):.1f} m / 1.0 deg)",
                  file=sys.stderr)
            if missI <= max(2.0, 0.04 * path) and angI <= 1.0:
                incumbent_kept = True
                nR = np.stack([np.asarray(relR[k], np.float64)
                               for k in range(L)])
                nT = np.stack([np.asarray(relT[k], np.float64)
                               for k in range(L)])
                closure_src = (closure_src or "") + \
                    f"|incumbent(miss={missI:.2f}m,{angI:.2f}deg)"
        elif okd:
            # The solve has NO verified closure, but the descriptor
            # anchor-to-anchor registration EXISTS and is inlier-verified
            # between two healthy full-view frames — it was refused above
            # only because the SOLVE disagreed with it (dmiss > cap),
            # which indicts the solve, not the referee.  Check the
            # incumbent against the descriptor rel directly: if they
            # agree, the incumbent's absolute placement is independently
            # confirmed and the unverified map solution must not replace
            # it (measured, window 64 / degraded seed 2: a gain-only
            # acceptance with dmiss 43.8 m dragged a healthy 13.2 m
            # dejumped trajectory to 22.2).  Keep the incumbent, pin its
            # endpoint to the descriptor closure.  Bounds are slightly
            # looser than the verified-closure keep (the raw descriptor
            # rel carries up to ~1.4 m before dense polish).
            tdv = np.asarray(td, np.float64)
            Rdv = np.asarray(Rd, np.float64)
            missI = float(np.linalg.norm(tdv - tcI))
            angI = float(np.degrees(np.arccos(np.clip(
                (np.trace(RcI.T @ Rdv) - 1.0) / 2.0, -1.0, 1.0))))
            import sys
            print(f"burst span ({a}, {b}): incumbent-vs-DESCRIPTOR miss "
                  f"{missI:.2f} m / {angI:.2f} deg (keep bound "
                  f"{max(3.0, 0.05 * path):.1f} m / 1.5 deg; solve "
                  f"unverified)", file=sys.stderr)
            if missI <= max(3.0, 0.05 * path) and angI <= 1.5:
                incumbent_kept = True
                closure_ok = True
                R_cl, t_cl = Rdv, tdv
                nR = np.stack([np.asarray(relR[k], np.float64)
                               for k in range(L)])
                nT = np.stack([np.asarray(relT[k], np.float64)
                               for k in range(L)])
                closure_src = (f"descriptor({int(n_inl)})|incumbent"
                               f"(miss={missI:.2f}m,{angI:.2f}deg,"
                               f"solve_refused)")
                # replace the refusal diagnostic recorded above
                if stats.closures and stats.closures[-1][:2] == (a, b):
                    stats.closures.pop()
        if closure_src is not None:
            stats.closures.append((a, b, closure_src))
        # Evidence-weighted acceptance: the residual-gain requirement
        # halves when the independent exit-anchor closure verified AND
        # sits within the plausibility bound — two agreeing measurements
        # (map residual gain + full-view anchor-to-anchor registration)
        # beat one (measured: a verified rescue at 9.9% gain was rejected
        # by the flat 10% gate at one RNG seed and accepted at another).
        gain_frac = rcfg.residual_gain_frac * (0.5 if closure_ok else 1.0)
        gain_ok = (oks.mean() >= 0.5
                   and (r0 - r1) >= max(gain_frac * r0,
                                        rcfg.residual_gain_floor_m))
        # Unverified solves (no anchor closure passed) may only apply a
        # PLAUSIBLE correction: the splice endpoint must stay within the
        # drift bound of the incumbent chain (same bound family as the
        # icp-closure gate).  Residual gain alone cannot referee a large
        # correction — the map it improves against is itself built from
        # the solve (measured, window 64 / degraded seed 2: a gain-only
        # acceptance moved the endpoint far off a healthy incumbent and
        # dragged ATE 13.2 -> 22.2 m; the descriptor, solve and incumbent
        # all mutually disagreed, so NOTHING was verified).
        if not closure_ok and not incumbent_kept:
            corr_t = float(np.linalg.norm(tc - tcI))
            corr_a = float(np.degrees(np.arccos(np.clip(
                (np.trace(RcI.T @ Rc) - 1.0) / 2.0, -1.0, 1.0))))
            import sys
            print(f"burst span ({a}, {b}): UNVERIFIED solve correction "
                  f"{corr_t:.2f} m / {corr_a:.2f} deg vs incumbent "
                  f"(plausibility bound {bound:.1f} m / 5.0 deg)",
                  file=sys.stderr)
            if corr_t > bound or corr_a > 5.0:
                stats.rejected.append((a, b))
                continue
        if not gain_ok and not incumbent_kept:
            stats.rejected.append((a, b))
            continue
        if closure_ok:
            from scipy.spatial.transform import Rotation

            Rt = R_cl
            tt = t_cl

            def redistribute(nR, nT):
                """Distribute the chain-vs-closure endpoint mismatch
                smoothly over the span (backward_update-style)."""
                cum = [(np.eye(3), np.zeros(3))]
                for k in range(L):
                    Ck, ck = cum[-1]
                    cum.append((Ck @ nR[k], Ck @ nT[k] + ck))
                Rc, tc = cum[L]
                d_rotvec = Rotation.from_matrix(Rc.T @ Rt).as_rotvec() / L
                d_t = (tt - tc) / L
                prev = (np.eye(3), np.zeros(3))
                for k in range(1, L + 1):
                    Rk = cum[k][0] @ Rotation.from_rotvec(
                        d_rotvec * k).as_matrix()
                    tk = cum[k][1] + d_t * k
                    nR[k - 1] = prev[0].T @ Rk
                    nT[k - 1] = prev[0].T @ (tk - prev[1])
                    prev = (Rk, tk)
                return nR, nT

            nR, nT = redistribute(nR, nT)
            # Smooth the span's rel sequence: at heavy degradation the
            # per-pair error is dominated by INDEPENDENT per-frame solve
            # noise (each frame registers against the map on ~5% of
            # returns), while real vehicle motion is smooth at frame rate
            # (a 20 deg/s turn is a steady 2 deg/frame).  A [1,2,1]/4
            # kernel on the rotation-vector/translation increments cuts
            # the independent noise ~1.6x and preserves the chain total
            # to first order; the closure is then re-distributed so the
            # verified endpoint stays exact.
            if L >= 4 and not incumbent_kept:
                def smooth(x):
                    y = x.copy()
                    y[1:-1] = 0.25 * x[:-2] + 0.5 * x[1:-1] + 0.25 * x[2:]
                    return y

                # two passes (~[1,4,6,4,1]/16): symmetric kernels are
                # exact for linear motion trends (a steady turn), so the
                # extra width only removes more independent solve noise
                for _ in range(2):
                    rv = Rotation.from_matrix(nR).as_rotvec()
                    nR = Rotation.from_rotvec(smooth(rv)).as_matrix()
                    nT = smooth(nT)
                    nR, nT = redistribute(nR, nT)
            # Per-pair polish: consecutive burst frames see the SAME wedge
            # (fully overlapping views), so pairwise hybrid ICP constrains
            # their REL precisely once the initialization is right — the
            # regime where it was degenerate was absolute placement, which
            # the map solve + closure just fixed.  Tight acceptance (the
            # correction must be small) keeps sensor-locked bias out; the
            # closure is re-distributed after, so the verified endpoint
            # stays exact.
            if pair_icp_fn is not None and not incumbent_kept:
                ii = np.arange(a, b, dtype=np.int32)
                dRs, dts, poks, _, _ = pair_icp_fn(
                    ii, ii + 1, nR.astype(np.float32),
                    nT.astype(np.float32), thr_scale=1.0)
                n_pol = 0
                for k in range(L):
                    if not bool(poks[k]):
                        continue
                    dR = np.asarray(dRs[k], np.float64)
                    dt = np.asarray(dts[k], np.float64)
                    ang = np.degrees(np.arccos(np.clip(
                        (np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
                    if ang <= 0.5 and np.linalg.norm(dt) <= 0.3:
                        nR[k] = dR @ nR[k]
                        nT[k] = dR @ nT[k] + dt
                        n_pol += 1
                if n_pol:
                    nR, nT = redistribute(nR, nT)
        import os
        if os.environ.get("CAELO_DEBUG_BURST"):
            np.savez(os.environ["CAELO_DEBUG_BURST"] + f"_{a}_{b}.npz",
                     nR=nR, nT=nT, oks=oks,
                     R_cl=np.asarray(R_cl), t_cl=np.asarray(t_cl),
                     ok_cl=np.asarray(ok_cl),
                     r0s=np.asarray(r0s)[:L], r1s=np.asarray(r1s)[:L],
                     poses=poses)
        # orthonormality guard: a corrupt rotation in the splice scales the
        # whole downstream chain EXPONENTIALLY (det != 1 compounds through
        # every later pose) — refuse the span instead
        orth = np.max(np.abs(
            np.einsum("kji,kjl->kil", nR, nR)
            - np.eye(3)[None]), axis=(1, 2))
        if np.any(orth > 1e-3):
            stats.rejected.append((a, b))
            import sys
            print(f"burst span ({a}, {b}): non-orthonormal solved rel "
                  f"(max dev {orth.max():.2e}) — span refused",
                  file=sys.stderr)
            continue
        # splice: replace the span's rels where solved, re-chain the tail
        rel_Rs, rel_ts = _all_rels(poses)
        for k in range(L):
            if not oks[k]:
                continue
            dR, dt = _cam_rel(nR[k], nT[k], rel_lidar_fn, apply_rel_fn,
                              poses[a + k])
            rel_Rs[a + k], rel_ts[a + k] = dR, dt
        for k in range(a + 1, len(poses)):
            R0, t0 = _rt(poses[k - 1])
            poses[k] = _row(R0 @ rel_Rs[k - 1], R0 @ rel_ts[k - 1] + t0)
        if os.environ.get("CAELO_DEBUG_BURST"):
            np.savez(os.environ["CAELO_DEBUG_BURST"] + f"_{a}_{b}_post.npz",
                     poses=poses, rel_Rs=rel_Rs, rel_ts=rel_ts)
        stats.accepted.append((a, b))
    return poses, stats


def _cam_rel(relR_lidar, relT_lidar, rel_lidar_fn, apply_rel_fn, pose0):
    """Convert a lidar-frame relative pose into the camera-frame rel used
    by the pose chain, via the caller's own apply function (which holds the
    calib): new_pose1 = apply(pose0, rel), then rel_cam = pose0^-1 pose1."""
    p1 = apply_rel_fn(pose0, relR_lidar, relT_lidar)
    P0 = np.asarray(pose0, np.float64).reshape(3, 4)
    P1 = np.asarray(p1, np.float64).reshape(3, 4)
    R = P0[:, :3].T @ P1[:, :3]
    t = P0[:, :3].T @ (P1[:, 3] - P0[:, 3])
    return R, t
