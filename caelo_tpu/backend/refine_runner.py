"""Device-side glue for the refinement back end.

Produces the per-frame refinement features (extended keypoints + planar
points with normals — the data the reference saves to ``KeyPts/*.mat`` in
``BatchPreprocess.py:119-152`` and reloads in ``RefinePoses.RefinementCore``
``:276-277``) and builds the ``icp_fn`` used by
``caelo_tpu.backend.refine.refine_odometry``: transform frame-j features by
the odometry-predicted relative pose, then hybrid ICP against frame i
(``RefinementCore``, ``RefinePoses.py:281-302``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..geometry import se3
from ..models.respond_net import RespondLayer
from ..ops.masking import compact
from ..ops.nms import select_keypoints
from ..projection.normals import extract_planar_points
from ..projection.spherical import (extend_keypoints, model_input,
                                    project_to_spherical_ring)
from .icp import IcpResult, icp_hybrid


class RefinementFeatures(NamedTuple):
    ext_pts: jnp.ndarray      # (E, 3) extended keypoints
    ext_mask: jnp.ndarray     # (E,)
    planar: jnp.ndarray       # (P, 6) planar points + normals
    planar_mask: jnp.ndarray  # (P,)


def extended_cloud(pts, mask, image, counter, key_pixels, key_mask,
                   cfg: PipelineConfig):
    """Extended-keypoint cloud for refinement ICP, with the degraded-frame
    fallback.  Shared by ``extract_refinement_features`` and the windowed
    front end's ``extract_frame_features_full``.

    Any slots the extended keypoints leave unfilled are topped up with an
    even subsample of the raw scan (the raw candidates sit BEHIND the
    extended keypoints; compact keeps front order).  Degraded frames NEED
    this: sector occlusion / heavy dropout leaves salient-point clouds so
    sparse and unrepeatable that consecutive frames barely overlap —
    measured on the degraded benchmark, refinement ICP on ext-only clouds
    either starved (ninl=0 at every retry rung, CI scale) or converged to
    biased optima that made ATE worse (full scale); dense raw fill fixed
    both.  Healthy frames usually fill the buffer with extended keypoints
    alone, and their spans are trusted and skip refinement anyway.
    """
    nbr_pts, nbr_mask = extend_keypoints(
        image, counter, key_pixels, key_mask, cfg.sensor,
        radius=cfg.keypoint.extend_radius,
    )
    flat_pts = nbr_pts.reshape(-1, 3)
    flat_mask = nbr_mask.reshape(-1)
    # even coverage of the VALID prefix (pad_points compacts valid points
    # to the front): index k -> floor(k * n_valid / max_points).  A plain
    # stride over the padded buffer mostly samples padding on sparse scans.
    n_valid = jnp.maximum(jnp.sum(mask), 1)
    S = cfg.icp.max_points
    ridx = (jnp.arange(S, dtype=jnp.int32)
            * n_valid.astype(jnp.int32)) // jnp.int32(S)
    raw = pts[ridx, 0:3]
    # dedup repeated indices (n_valid < S) so duplicate points can't
    # inflate the ICP inlier count
    uniq = jnp.concatenate([jnp.ones((1,), bool), ridx[1:] != ridx[:-1]])
    raw_m = mask[ridx] & uniq
    ext_pts, ext_mask, _ = compact(
        jnp.concatenate([flat_pts, raw]),
        jnp.concatenate([flat_mask, raw_m]),
        cfg.icp.max_points, fill=0.0,
    )
    return ext_pts, ext_mask


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_refinement_features(respond_params, pts: jnp.ndarray,
                                mask: jnp.ndarray,
                                cfg: PipelineConfig = PipelineConfig()
                                ) -> RefinementFeatures:
    image, counter = project_to_spherical_ring(pts, mask, cfg.sensor)
    respond = RespondLayer().apply(
        respond_params, model_input(image, cfg.sensor)[None]
    )[0]
    key_pts, key_pixels, key_mask, saliency = select_keypoints(
        image, counter, respond, cfg.sensor, cfg.keypoint
    )
    ext_pts, ext_mask = extended_cloud(
        pts, mask, image, counter, key_pixels, key_mask, cfg
    )
    planar, planar_mask = extract_planar_points(
        image, counter, saliency, cfg.sensor, max_planar=cfg.icp.max_planar
    )
    return RefinementFeatures(ext_pts, ext_mask, planar, planar_mask)


@functools.partial(jax.jit, static_argnames=("cfg",))
def refine_pair(f0: RefinementFeatures, f1: RefinementFeatures,
                relR: jnp.ndarray, relT: jnp.ndarray,
                cfg: PipelineConfig = PipelineConfig(),
                thr_scale=1.0) -> IcpResult:
    """ICP correction of an odometry-predicted relative pose: transform
    frame-1 refinement features by (relR, relT), then hybrid ICP against
    frame 0 (``RefinementCore``, ``RefinePoses.py:281-302``).  The returned
    (R, t) is the *correction*: refined_rel = R @ relR, R @ relT + t.
    ``thr_scale`` is the coarse-to-fine retry rung (see ``icp_hybrid``)."""
    p1 = se3.apply(relR, relT, f1.ext_pts[None])[0].astype(jnp.float32)
    pl1_xyz = se3.apply(relR, relT, f1.planar[None, :, 0:3])[0]
    pl1_n = jnp.einsum("ij,pj->pi", relR, f1.planar[:, 3:6])
    pl1 = jnp.concatenate([pl1_xyz, pl1_n], axis=1).astype(jnp.float32)
    return icp_hybrid(
        f0.ext_pts, f0.ext_mask, p1, f1.ext_mask,
        f0.planar, f0.planar_mask, pl1, f1.planar_mask, cfg.icp,
        thr_scale=thr_scale,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def refine_pairs_batched(f0s: RefinementFeatures, f1s: RefinementFeatures,
                         relRs: jnp.ndarray, relTs: jnp.ndarray,
                         cfg: PipelineConfig = PipelineConfig(),
                         thr_scale=1.0) -> IcpResult:
    """Vmapped ``refine_pair`` over a batch of keyframe spans.

    The reference refines spans strictly sequentially (``RefineOdometry``,
    ``RefinePoses.py:366-436``) because each acceptance forward-updates the
    trajectory.  On the device the expensive part — the hybrid ICP solves — can run
    for ALL candidate spans in one batched call from the current trajectory
    (a Jacobi-style pass); the cheap accept/propagate logic stays host-side.
    One pass over S spans costs about the same as one span.

    Args: ``f0s``/``f1s`` are RefinementFeatures with a leading span axis
    (stack with ``jax.tree.map``); relRs/relTs ``(S, 3, 3)`` / ``(S, 3)``.
    """
    return jax.vmap(
        lambda a, b, R, t: refine_pair(a, b, R, t, cfg, thr_scale=thr_scale)
    )(f0s, f1s, relRs, relTs)


def stack_features(features, idx) -> RefinementFeatures:
    """Gather RefinementFeatures at ``idx`` into a batched pytree.

    ``features`` is either a list of per-frame pytrees (legacy; stacked with
    one op per frame) or one stacked pytree with leading axis N (the
    windowed front end's layout; gathered with ONE device op per field)."""
    if isinstance(features, list) or (
            isinstance(features, tuple) and not hasattr(features, "_fields")):
        sel = [features[int(i)] for i in idx]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *sel)
    ii = jnp.asarray(np.asarray(idx), jnp.int32)
    return jax.tree.map(lambda x: x[ii], features)


def make_batched_icp_fn(features: list,
                        cfg: PipelineConfig = PipelineConfig(),
                        chunk: int = 16) -> Callable:
    """Adapt ``refine_pairs_batched`` to the
    ``refine.refine_odometry_batched`` contract:
    ``(idx_i, idx_j, relRs, relTs) -> (dRs, dts, oks)``.

    Spans are padded to fixed ``chunk``-sized batches so the vmapped hybrid
    ICP compiles exactly once regardless of how many spans a trajectory
    yields."""

    def batched(idx_i, idx_j, relRs, relTs, thr_scale=1.0):
        S = len(idx_i)
        dRs = np.zeros((S, 3, 3))
        dts = np.zeros((S, 3))
        oks = np.zeros((S,), bool)
        r0s = np.zeros((S,))
        r1s = np.zeros((S,))
        for s in range(0, S, chunk):
            sel = slice(s, min(s + chunk, S))
            n = sel.stop - sel.start
            pad = chunk - n
            ii = np.concatenate([idx_i[sel], np.repeat(idx_i[sel][-1:], pad)])
            jj = np.concatenate([idx_j[sel], np.repeat(idx_j[sel][-1:], pad)])
            rR = np.concatenate(
                [relRs[sel], np.repeat(relRs[sel][-1:], pad, axis=0)]
            ).astype(np.float32)
            rT = np.concatenate(
                [relTs[sel], np.repeat(relTs[sel][-1:], pad, axis=0)]
            ).astype(np.float32)
            f0s = stack_features(features, ii)
            f1s = stack_features(features, jj)
            res = refine_pairs_batched(f0s, f1s, jnp.asarray(rR),
                                       jnp.asarray(rT), cfg,
                                       thr_scale=jnp.float32(thr_scale))
            dRs[sel] = np.asarray(res.R, np.float64)[:n]
            dts[sel] = np.asarray(res.t, np.float64)[:n]
            oks[sel] = np.asarray(res.success)[:n]
            r0s[sel] = np.asarray(res.init_res, np.float64)[:n]
            r1s[sel] = np.asarray(res.final_res, np.float64)[:n]
        return dRs, dts, oks, r0s, r1s

    return batched


def make_icp_fn(features, cfg: PipelineConfig = PipelineConfig()
                ) -> Callable:
    """Adapt ``refine_pair`` to the host-side ``refine_odometry`` contract:
    ``icp_fn(i, j, relR, relT) -> (dR, dt, success)``."""

    def frame(i):
        if isinstance(features, list) or (
            isinstance(features, tuple) and not hasattr(features, "_fields")):
            return features[i]
        return jax.tree.map(lambda x: x[i], features)

    def icp_fn(i: int, j: int, relR: np.ndarray, relT: np.ndarray):
        res = refine_pair(
            frame(i), frame(j),
            jnp.asarray(relR, jnp.float32), jnp.asarray(relT, jnp.float32),
            cfg,
        )
        return (np.asarray(res.R, np.float64), np.asarray(res.t, np.float64),
                bool(res.success))

    return icp_fn
