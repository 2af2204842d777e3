"""Descriptor matching as a distance matmul.

Replaces the reference's ``scipy.spatial.distance.cdist`` + ``argmin``
(``Match.py:257-263``) with the matmul identity
``||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b`` — one 1024x1024x60 matrix
product.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def squared_distance_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``(N, D), (M, D) -> (N, M)`` squared euclidean distances via matmul."""
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    ab = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    return jnp.maximum(a2[:, None] + b2[None, :] - 2.0 * ab, 0.0)


def match_descriptors(codes0, mask0, codes1, mask1,
                      pts0=None, pts1=None, prior_R=None, prior_t=None,
                      gate_m: float = 0.0, ratio: float = 0.0):
    """For each frame-1 keypoint, the nearest frame-0 descriptor.

    Mirrors ``Match.py:257-263``: ``argmin`` over frame-0 codes per frame-1
    keypoint; invalid (padded) keypoints are masked to +inf distance.

    With a motion prior (``pts0``, ``pts1``, ``prior_R``, ``prior_t``,
    ``gate_m > 0``), candidate matches are additionally gated geometrically:
    frame-1 keypoints are transformed by the prior (the reference's MATLAB
    front end applies the previous relative motion the same way,
    ``GenerateTrajactory.m:210``) and only frame-0 keypoints within
    ``gate_m`` meters of the prediction are eligible.  This suppresses
    descriptor aliasing on repetitive structure; both distance matrices are
    matmuls.

    Returns:
      pair_idx: ``(K1,)`` index into frame 0 for each frame-1 keypoint.
      pair_mask: ``(K1,)`` both endpoints valid.
      pair_dist: ``(K1,)`` descriptor distance of each match.
    """
    d2 = squared_distance_matrix(codes0, codes1)           # (K0, K1)
    d2 = jnp.where(mask0[:, None], d2, jnp.inf)
    if gate_m > 0.0 and pts0 is not None:
        pred1 = pts1 @ prior_R.T + prior_t                 # (K1, 3) in frame 0
        g2 = squared_distance_matrix(pts0, pred1)          # (K0, K1)
        d2 = jnp.where(g2 <= gate_m * gate_m, d2, jnp.inf)
    pair_idx = jnp.argmin(d2, axis=0)
    pair_d2 = jnp.take_along_axis(d2, pair_idx[None, :], axis=0)[0]
    pair_mask = mask1 & jnp.isfinite(pair_d2)
    if ratio > 0.0:
        # Lowe-style distinctiveness gate: reject a match whose runner-up
        # descriptor distance is nearly as good — ambiguous features
        # (range-noise speckle on smooth surfaces, repetitive structure)
        # produce near-tied matches that vote for a sensor-locked zero
        # displacement and bias the consensus translation.  The reference's
        # plain argmin matching has no such gate (Match.py:257-263).
        neg2, _ = jax.lax.top_k(-d2.T, 2)              # (K1, 2)
        second = -neg2[:, 1]
        distinct = pair_d2 <= (ratio * ratio) * second
        pair_mask = pair_mask & (distinct | ~jnp.isfinite(second))
    return pair_idx, pair_mask, jnp.sqrt(jnp.where(pair_mask, pair_d2, 0.0))
