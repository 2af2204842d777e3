"""Keypoint saliency + NMS over the respond image.

Replacement for the reference's cupy CUDA kernel (``GetKeyPtsByAE``,
``SphericalRing.py:113-291`` — 1.8 s/frame in the reference's own timing,
the slowest stage of its pipeline).  The computation is:

* for each pixel, the minimum L2 feature difference to its *occupied* 5x5
  neighbors (24 offsets) in the 8-channel respond image;
* gates: pixel occupied, >=5 occupied neighbors (``:186``), min-diff > 0.2
  (``:126,199``), range >= 10 m (``:197-198``), edge crop 8 px (``:210-213``);
* top-1024 by saliency (``:124,216-218``).

The saliency map is 24 shifted slices (~22 MFLOP per frame) that XLA fuses
into one loop.  (A hand-written Pallas/Triton version was 1.8x faster alone
on an H100 but moved the window program by less than its run-to-run spread,
so it was not kept — see PERF.md.)

Deviation from the reference: its final slice ``[-n-1:-1]`` of the ascending
argsort (``SphericalRing.py:216-218``) silently *drops the single strongest
keypoint*; we keep the true top-k.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import KeypointConfig, SensorConfig


def saliency_map(respond: jnp.ndarray, occ: jnp.ndarray, rad: int = 2):
    """Min squared feature difference of each pixel of ``respond`` (H, W, C)
    to its occupied ``(2 rad + 1)^2`` neighbours (inf where none), and the
    number of them, as plain shifted slices."""
    H, W, C = respond.shape
    fpad = jnp.pad(respond, ((rad, rad), (rad, rad), (0, 0)))
    opad = jnp.pad(occ, ((rad, rad), (rad, rad)))
    min_d2 = jnp.full((H, W), jnp.inf, jnp.float32)
    n_occ = jnp.zeros((H, W), jnp.int32)
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            if dy == 0 and dx == 0:
                continue
            nf = jax.lax.dynamic_slice(fpad, (rad + dy, rad + dx, 0), (H, W, C))
            nocc = jax.lax.dynamic_slice(opad, (rad + dy, rad + dx), (H, W))
            d2 = jnp.sum((nf - respond) ** 2, axis=-1)
            min_d2 = jnp.minimum(min_d2, jnp.where(nocc, d2, jnp.inf))
            n_occ = n_occ + nocc.astype(jnp.int32)
    return min_d2, n_occ


@functools.partial(jax.jit, static_argnames=("sensor", "kp"))
def select_keypoints(image: jnp.ndarray, counter: jnp.ndarray,
                     respond: jnp.ndarray,
                     sensor: SensorConfig = SensorConfig(),
                     kp: KeypointConfig = KeypointConfig()):
    """Select the top-k salient keypoints from a respond image.

    Args:
      image: ``(ImgH, ImgW, 5)`` spherical-ring image (for 3D points/range).
      counter: ``(ImgH, ImgW)`` occupancy counter.
      respond: ``(n_lines, model_w, C)`` respond-layer feature map.

    Returns:
      key_pts: ``(n_keypoints, 3)`` 3D points.
      key_pixels: ``(n_keypoints, 2)`` (row, col) pixels.
      key_mask: ``(n_keypoints,)`` validity (saliency above threshold).
      saliency: ``(n_lines, model_w)`` min-neighbor-diff map (for debugging /
        evaluation).
    """
    H, W, C = respond.shape
    occ = (counter[:H, :W] > 0)
    with jax.named_scope("saliency"):
        min_d2, n_occ = saliency_map(respond, occ, kp.window // 2)

    saliency = jnp.sqrt(jnp.where(jnp.isfinite(min_d2), min_d2, 0.0))

    rng = image[:H, :W, 4]
    e = sensor.edge_filter
    rows = jnp.arange(H)[:, None]
    cols = jnp.arange(W)[None, :]
    in_crop = (
        (rows >= e) & (rows < sensor.n_lines - e)
        & (cols >= e) & (cols < sensor.model_w - e)
    )
    good = (
        occ
        & (n_occ >= kp.min_neighbors)
        & (saliency > kp.norm_diff_threshold)
        & (rng >= sensor.visible_bottom)
        & in_crop
        & jnp.isfinite(min_d2)
    )

    if kp.ground_z_max > -100.0:
        # Ground-speckle suppression (beyond the reference): the beam rings
        # on near-flat ground are sensor-locked — they sample DIFFERENT
        # physical points each frame at the SAME sensor-relative position,
        # so salient range-noise speckle there matches itself at zero
        # displacement and votes the consensus translation toward zero
        # (measured: 152/159 inliers at ground height with est |t| 0.2 m vs
        # true 1.1 m on the hard benchmark).  A candidate below
        # ``ground_z_max`` is kept only if its 5x5 window has real vertical
        # structure (z extent > ``ground_extent_m``) — curbs, poles, and
        # wall bases survive; flat-ground speckle does not.  The ground
        # still serves the refinement stage through the planar/normal
        # channel, where point-to-plane treats it correctly.
        # (An |n_z|-based horizontal-surface gate was measured strictly
        # worse at 520-frame scale — 73.8% -> 20-29% success: horizontal
        # surfaces ABOVE sensor-ground level stabilize rotation and must
        # stay; see ROADMAP r3.)
        z = image[:H, :W, 2] * occ.astype(image.dtype)
        zrad = kp.window // 2
        zpad = jnp.pad(z, ((zrad, zrad), (zrad, zrad)))
        opad_z = jnp.pad(occ, ((zrad, zrad), (zrad, zrad)))
        zmin = jnp.full((H, W), jnp.inf, jnp.float32)
        zmax = jnp.full((H, W), -jnp.inf, jnp.float32)
        for dy in range(-zrad, zrad + 1):
            for dx in range(-zrad, zrad + 1):
                nz = jax.lax.dynamic_slice(
                    zpad, (zrad + dy, zrad + dx), (H, W))
                no = jax.lax.dynamic_slice(opad_z, (zrad + dy, zrad + dx),
                                           (H, W))
                zmin = jnp.minimum(zmin, jnp.where(no, nz, jnp.inf))
                zmax = jnp.maximum(zmax, jnp.where(no, nz, -jnp.inf))
        zext = jnp.where(jnp.isfinite(zmin) & jnp.isfinite(zmax),
                         zmax - zmin, 0.0)
        low = image[:H, :W, 2] < kp.ground_z_max
        good = good & (~low | (zext > kp.ground_extent_m))

    score = jnp.where(good, saliency, -jnp.inf).reshape(-1)
    vals, idx = jax.lax.top_k(score, kp.n_keypoints)
    key_mask = jnp.isfinite(vals)
    r, c = idx // W, idx % W
    key_pixels = jnp.stack([r, c], axis=-1)
    key_pts = image[r, c, 0:3]
    key_pts = jnp.where(key_mask[:, None], key_pts, 0.0)
    return key_pts, key_pixels, key_mask, saliency
