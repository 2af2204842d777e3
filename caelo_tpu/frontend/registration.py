"""End-to-end frame feature extraction and pairwise registration.

The batched-device equivalent of the reference's per-frame front-end chain
(``Match.py`` demo ``:286-349`` / ``PoseEstimation.GetRelativePoseBetween2-
Frames`` ``:152-168``):

  scan -> spherical ring -> respond net -> NMS top-1024 -> voxel pyramid ->
  multi-scale patches -> encoder -> 60-dim descriptors -> NN matching ->
  batched RANSAC -> refit pose.

Unlike the reference (whose inter-stage contract is .mat files on disk),
``extract_frame_features`` is ONE jitted device function per frame and
``register_pair`` one more per pair — the stage boundary is device memory,
not the filesystem.  Artifact caching for restartability lives in
``caelo_tpu.data.artifacts`` instead of being baked into the pipeline.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..models.patch_encoder import PatchEncoder
from ..models.respond_net import RespondLayer
from ..ops.nms import select_keypoints
from ..projection.spherical import model_input, project_to_spherical_ring
from ..voxel.grid import extract_patches, voxelize
from .matching import match_descriptors
from .ransac import RansacResult, ransac_rigid


class FrameFeatures(NamedTuple):
    """Per-frame keypoints + descriptors (fixed shapes, mask-padded)."""

    key_pts: jnp.ndarray      # (K, 3)
    descriptors: jnp.ndarray  # (K, 60)
    mask: jnp.ndarray         # (K,) bool
    key_pixels: jnp.ndarray   # (K, 2) int32


class PairRegistration(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    success: jnp.ndarray
    inlier_idx0: jnp.ndarray   # (K,) int32 — frame-0 keypoint index per pair
    inlier_idx1: jnp.ndarray   # (K,) int32 — frame-1 keypoint index per pair
    inlier_mask: jnp.ndarray   # (K,) bool
    n_inliers: jnp.ndarray
    threshold: jnp.ndarray


def _extract(respond_params, encoder_params, pts: jnp.ndarray,
             mask: jnp.ndarray, cfg: PipelineConfig, with_refine: bool):
    """Shared front-end body: padded scan -> keypoints + descriptors, and
    (``with_refine``) the refinement features from the SAME projection /
    respond / NMS results — the reference saves these once to
    ``KeyPts/*.mat`` during preprocessing (``BatchPreprocess.py:119-152``)
    rather than re-running the front end for the refinement stage."""
    dt = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    cast = lambda tree: jax.tree.map(lambda x: x.astype(dt), tree)
    image, counter = project_to_spherical_ring(pts, mask, cfg.sensor)
    net_in = model_input(image, cfg.sensor)[None]
    respond = RespondLayer().apply(
        cast(respond_params), net_in.astype(dt)
    )[0].astype(jnp.float32)
    key_pts, key_pixels, key_mask, saliency = select_keypoints(
        image, counter, respond, cfg.sensor, cfg.keypoint
    )
    ref_feats = None
    if with_refine:
        from ..backend.refine_runner import (RefinementFeatures,
                                             extended_cloud)
        from ..projection.normals import extract_planar_points

        ext_pts, ext_mask = extended_cloud(
            pts, mask, image, counter, key_pixels, key_mask, cfg
        )
        planar, planar_mask = extract_planar_points(
            image, counter, saliency, cfg.sensor, max_planar=cfg.icp.max_planar
        )
        ref_feats = RefinementFeatures(ext_pts, ext_mask, planar, planar_mask)
    pyramid = voxelize(pts[:, :3], mask, cfg.voxel)
    patches = extract_patches(key_pts, key_mask, pyramid, cfg.voxel)
    enc = PatchEncoder(activation=cfg.encoder_activation,
                       code_activation=cfg.encoder_code_activation)
    enc_params = cast(encoder_params)
    # one encoder call over all 3 scales stacked on the batch axis (vs the
    # reference's three predict() calls, Match.py:130-135): same weights per
    # scale, 3x fewer kernel launches, a larger matmul batch
    K = patches[0].shape[0]
    stacked = jnp.concatenate([p.astype(dt) for p in patches], axis=0)
    ck = cfg.encoder_chunk
    if ck and stacked.shape[0] > ck and stacked.shape[0] % ck == 0:
        # chunked lax.map keeps the conv activations bounded (HBM), while
        # each chunk is still a large batch; chunks run back-to-back
        chunks = stacked.reshape(-1, ck, *stacked.shape[1:])
        codes_all = jax.lax.map(lambda c: enc.apply(enc_params, c), chunks)
        codes_all = codes_all.reshape(
            stacked.shape[0], -1).astype(jnp.float32)
    else:
        codes_all = enc.apply(enc_params, stacked).astype(jnp.float32)
    descriptors = jnp.concatenate(
        [codes_all[i * K:(i + 1) * K] for i in range(len(patches))], axis=-1
    )
    descriptors = jnp.where(key_mask[:, None], descriptors, 0.0)
    return FrameFeatures(key_pts, descriptors, key_mask, key_pixels), ref_feats


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_frame_features(respond_params, encoder_params, pts: jnp.ndarray,
                           mask: jnp.ndarray,
                           cfg: PipelineConfig = PipelineConfig()
                           ) -> FrameFeatures:
    """Full per-frame front end: padded scan -> keypoints + descriptors."""
    feats, _ = _extract(respond_params, encoder_params, pts, mask, cfg,
                        with_refine=False)
    return feats


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_frame_features_full(respond_params, encoder_params,
                                pts: jnp.ndarray, mask: jnp.ndarray,
                                cfg: PipelineConfig = PipelineConfig()):
    """``extract_frame_features`` + refinement features in one pass.

    Returns ``(FrameFeatures, RefinementFeatures)`` computed from a single
    projection / respond-net / NMS run — avoids the second front-end pass
    the naive pipeline would pay to feed the refinement back end (the
    reference's ``KeyPts/*.mat`` save-once contract,
    ``BatchPreprocess.py:119-152``; reloaded by ``RefinePoses.py:276-277``).
    """
    return _extract(respond_params, encoder_params, pts, mask, cfg,
                    with_refine=True)


def _register(key, f0, f1, cfg, prior_R=None, prior_t=None,
              gate_m: float = 0.0) -> PairRegistration:
    pair_idx, pair_mask, pair_dist = match_descriptors(
        f0.descriptors, f0.mask, f1.descriptors, f1.mask,
        pts0=f0.key_pts, pts1=f1.key_pts,
        prior_R=prior_R, prior_t=prior_t, gate_m=gate_m,
        ratio=cfg.match_ratio,
    )
    pairs0 = f0.key_pts[pair_idx]
    pairs1 = f1.key_pts
    res: RansacResult = ransac_rigid(
        key, pairs0, pairs1, pair_mask, cfg.ransac, pair_dist=pair_dist
    )
    return PairRegistration(
        R=res.R,
        t=res.t,
        success=res.success,
        inlier_idx0=pair_idx,
        inlier_idx1=jnp.arange(pairs1.shape[0], dtype=jnp.int32),
        inlier_mask=res.inlier_mask,
        n_inliers=res.n_inliers,
        threshold=res.threshold,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def register_pair(key: jax.Array, f0: FrameFeatures, f1: FrameFeatures,
                  cfg: PipelineConfig = PipelineConfig()) -> PairRegistration:
    """Estimate the rigid transform mapping frame-1 points into frame 0
    (``SolveRelativePose``, ``Match.py:241-283``)."""
    return _register(key, f0, f1, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "gate_m"))
def register_pair_with_prior(key: jax.Array, f0: FrameFeatures,
                             f1: FrameFeatures, prior_R: jnp.ndarray,
                             prior_t: jnp.ndarray,
                             cfg: PipelineConfig = PipelineConfig(),
                             gate_m: float | None = None
                             ) -> PairRegistration:
    """``register_pair`` with a constant-velocity motion prior: candidate
    matches are geometrically gated to ``cfg.prior_gate_m`` meters around
    the prior-predicted keypoint positions (the reference's MATLAB front end
    pre-transforms the new cloud by the previous relative motion the same
    way, ``GenerateTrajactory.m:210,232-237``).  Used as a retry when plain
    registration fails — e.g. under high yaw rates where descriptor-only
    matching aliases.  ``gate_m`` overrides the config radius (loop-closure
    verification uses a wider gate: the prior there is yaw-only)."""
    return _register(key, f0, f1, cfg, prior_R=prior_R, prior_t=prior_t,
                     gate_m=cfg.prior_gate_m if gate_m is None else gate_m)
