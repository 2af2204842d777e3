"""Baseline keypoint detectors: ISS, Harris3D, SIFT3D — batched JAX.

The reference drives an external C++ PCL pybind wrapper (``PclKeyPts.py:
92-122``; parameters at ``:41-58``: ISS salient/NMS radius 2 m, gamma
0.975/0.975, >=5 neighbors; Harris radius 1 m, NMS threshold 1e-3; SIFT
min_scale 0.5, 4 octaves, 8 scales/octave, min contrast 0.1) purely as
*evaluation baselines* for the keypoint-comparison study.  Here all are
batched JAX ops over a fixed-size downsampled cloud:

* neighborhoods = K nearest points by ``approx_max_k`` over a distance
  matmul, radius-masked — no KD-trees;
* ISS: scatter covariance eigenvalues, saliency lambda3 with the
  gamma-ratio gates, radius NMS;
* Harris3D: normal-covariance response ``det - k trace^2`` (PCL's
  formulation) with the same NMS machinery;
* SIFT3D: difference-of-Gaussians scale space over the z field (PCL's
  ``SIFTKeypointFieldSelector<PointXYZ>`` smooths z), Gaussian KNN
  smoothing, scale+space extremum test, contrast gate.

``random_keypoints`` covers the reference's 'random' row.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _knn_neighbors(pts, mask, k: int, chunk: int = 512):
    """Indices of the k nearest points for every point (masked, approx)."""
    N = pts.shape[0]
    p2 = jnp.sum(pts * pts, axis=-1)
    p2m = jnp.where(mask, p2, 1e12)

    def one(qc):
        q2 = jnp.sum(qc * qc, axis=-1)
        score = (
            2.0 * jnp.dot(qc, pts.T, preferred_element_type=jnp.float32)
            - p2m[None, :]
            - q2[:, None]
        )
        _, idx = jax.lax.approx_max_k(score, k=k)
        return idx

    n_chunks = -(-N // chunk)
    qp = jnp.pad(pts, ((0, n_chunks * chunk - N), (0, 0)))
    idx = jax.lax.map(one, qp.reshape(n_chunks, chunk, 3))
    return idx.reshape(-1, k)[:N]


def _neighbor_cov(pts, mask, idx, radius):
    """Per-point neighbor covariance within ``radius`` (masked)."""
    nbr = pts[idx]                                    # (N, K, 3)
    ok = mask[idx] & mask[:, None]
    d = jnp.linalg.norm(nbr - pts[:, None, :], axis=-1)
    ok = ok & (d <= radius)
    w = ok.astype(jnp.float32)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(nbr * w, axis=1) / cnt
    c = (nbr - mean[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", c, c) / cnt[..., None]
    return cov, jnp.sum(ok, axis=1)


def _radius_nms(pts, mask, score, radius, n_keypoints, idx):
    """Keep points that are local maxima of ``score`` within ``radius``."""
    nbr_score = jnp.where(
        mask[idx] & (jnp.linalg.norm(pts[idx] - pts[:, None, :], axis=-1) <= radius),
        score[idx],
        -jnp.inf,
    )
    is_max = score >= jnp.max(nbr_score, axis=1)
    final = jnp.where(mask & is_max & jnp.isfinite(score), score, -jnp.inf)
    vals, top = jax.lax.top_k(final, n_keypoints)
    out_mask = jnp.isfinite(vals)
    return pts[top] * out_mask[:, None], out_mask


class KeypointResult(NamedTuple):
    key_pts: jnp.ndarray
    key_mask: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("n_keypoints", "k"))
def iss_keypoints(pts: jnp.ndarray, mask: jnp.ndarray,
                  salient_radius: float = 2.0, nms_radius: float = 2.0,
                  gamma_21: float = 0.975, gamma_32: float = 0.975,
                  min_neighbors: int = 5, n_keypoints: int = 1024,
                  k: int = 64) -> KeypointResult:
    """Intrinsic Shape Signatures (parameters per ``PclKeyPts.py:41-46``)."""
    idx = _knn_neighbors(pts, mask, k)
    cov, n_nbr = _neighbor_cov(pts, mask, idx, salient_radius)
    evals = jnp.linalg.eigh(cov)[0]                   # ascending l3<=l2<=l1
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]
    ok = (
        mask
        & (n_nbr >= min_neighbors)
        & (l2 / jnp.maximum(l1, 1e-12) < gamma_21)
        & (l3 / jnp.maximum(l2, 1e-12) < gamma_32)
    )
    score = jnp.where(ok, l3, -jnp.inf)
    kp, km = _radius_nms(pts, mask, score, nms_radius, n_keypoints, idx)
    return KeypointResult(kp, km)


@functools.partial(jax.jit, static_argnames=("n_keypoints", "k"))
def harris3d_keypoints(pts: jnp.ndarray, mask: jnp.ndarray,
                       radius: float = 1.0, nms_threshold: float = 1e-3,
                       harris_k: float = 0.04, n_keypoints: int = 1024,
                       k: int = 64) -> KeypointResult:
    """Harris3D (parameters per ``PclKeyPts.py:48-51``): response
    ``det(C) - k trace(C)^2`` on the covariance of neighborhood surface
    normals, as in PCL's HarrisKeypoint3D."""
    idx = _knn_neighbors(pts, mask, k)
    cov, n_nbr = _neighbor_cov(pts, mask, idx, radius)
    # surface normal = smallest eigvec of the point covariance
    _, evecs = jnp.linalg.eigh(cov)
    normals = evecs[:, :, 0]
    nbr_n = normals[idx]                              # (N, K, 3)
    ok = mask[idx] & (
        jnp.linalg.norm(pts[idx] - pts[:, None, :], axis=-1) <= radius
    )
    w = ok.astype(jnp.float32)[..., None]
    # UNnormalized covariance sum of unit normals (PCL-style): for K
    # isotropic normals det ~ (K/3)^3 >> k K^2, while coplanar/collinear
    # normal sets give det ~ 0 -> negative response.  A trace-normalized C
    # (trace == 1) could never beat k * tr^2 with the standard k = 0.04.
    C = jnp.einsum("nki,nkj->nij", nbr_n * w, nbr_n)
    det = jnp.linalg.det(C)
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    resp = det - harris_k * tr * tr
    score = jnp.where(mask & (n_nbr >= 5) & (resp > nms_threshold),
                      resp, -jnp.inf)
    kp, km = _radius_nms(pts, mask, score, radius, n_keypoints, idx)
    return KeypointResult(kp, km)


@functools.partial(jax.jit, static_argnames=("n_octaves",
                                             "n_scales_per_octave",
                                             "n_keypoints", "k"))
def sift3d_keypoints(pts: jnp.ndarray, mask: jnp.ndarray,
                     min_scale: float = 0.5, n_octaves: int = 4,
                     n_scales_per_octave: int = 8,
                     min_contrast: float = 0.1, n_keypoints: int = 1024,
                     k: int = 64) -> KeypointResult:
    """SIFT3D (parameters per ``PclKeyPts.py:53-57``).

    PCL's ``SIFTKeypoint<PointXYZ, ...>`` selects the z coordinate as the
    'intensity' field; the scale space is z Gaussian-smoothed at geometric
    scales ``min_scale * 2^(o + i/s)`` across ``n_octaves`` octaves.  Here
    the smoothing is a Gaussian-weighted mean over each point's K nearest
    neighbors — one (N, K) distance matrix reweighted per scale, so the
    whole pyramid is a handful of fused elementwise passes instead of PCL's
    per-octave KD-tree re-searches.  A keypoint is a point whose DoG
    response is a max/min both across the two adjacent scales and over its
    spatial neighbors within 2 sigma, with ``|DoG| > min_contrast``
    (PCL's extremum + contrast test).  K bounds the support of the largest
    octaves — acceptable for the comparison-row role this detector plays.
    """
    idx = _knn_neighbors(pts, mask, k)
    nbr = pts[idx]                                    # (N, K, 3)
    d2 = jnp.sum((nbr - pts[:, None, :]) ** 2, axis=-1)
    okn = mask[idx] & mask[:, None]
    zn = jnp.where(okn, nbr[..., 2], 0.0)
    wv = okn.astype(jnp.float32)

    n_levels = n_octaves * n_scales_per_octave + 1
    sigmas = min_scale * 2.0 ** (jnp.arange(n_levels, dtype=jnp.float32)
                                 / n_scales_per_octave)

    def smooth(sig):
        w = jnp.exp(-d2 / (2.0 * sig * sig)) * wv
        return jnp.sum(w * zn, axis=-1) / jnp.maximum(
            jnp.sum(w, axis=-1), 1e-12)

    smoothed = jax.lax.map(smooth, sigmas)            # (S, N)
    dog = smoothed[1:] - smoothed[:-1]                # (S-1, N)

    def level_score(ell):
        lo, mid, hi = dog[ell], dog[ell + 1], dog[ell + 2]
        sig = sigmas[ell + 1]
        okr = okn & (d2 <= (2.0 * sig) ** 2)
        nbr_mid = mid[idx]
        is_max = ((mid > lo) & (mid > hi)
                  & (mid >= jnp.max(jnp.where(okr, nbr_mid, -jnp.inf),
                                    axis=1)))
        is_min = ((mid < lo) & (mid < hi)
                  & (mid <= jnp.min(jnp.where(okr, nbr_mid, jnp.inf),
                                    axis=1)))
        ok = (mask & (is_max | is_min)
              & (jnp.abs(mid) > min_contrast)
              & (jnp.sum(okr, axis=1) >= 2))
        return jnp.where(ok, jnp.abs(mid), -jnp.inf)

    scores = jax.lax.map(level_score, jnp.arange(n_levels - 3))
    score = jnp.max(scores, axis=0)                   # best over levels
    vals, top = jax.lax.top_k(score, n_keypoints)
    out_mask = jnp.isfinite(vals)
    return KeypointResult(pts[top] * out_mask[:, None], out_mask)


def random_keypoints(key, pts, mask, n_keypoints: int = 1024):
    """The reference's 'random' baseline row (``PclKeyPts.py:127-129``)."""
    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits, shape=(n_keypoints,))
    return KeypointResult(pts[idx], jnp.ones(n_keypoints, bool) & mask[idx])
