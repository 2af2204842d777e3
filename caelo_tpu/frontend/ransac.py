"""Batched RANSAC rigid-pose estimation on the device.

The reference runs 100-500 *sequential* trials of {sample 4 pairs, SVD
solve, 1024-point residual check} with an adaptive threshold ladder
(``RANSAC4RT``, ``Match.py:162-218``).  Here we instead:

* draw all hypotheses at once (``n_hypotheses`` x 4 masked categorical draws),
* solve every hypothesis in parallel with Horn's quaternion method (a
  batched 4x4 Jacobi eigensolver — always a proper rotation, no
  reflection branch),
* evaluate all hypotheses against all pairs AND all three threshold rungs
  (0.4 / 0.8 / 1.6 m, the reference's escalation ladder ``Match.py:207-214``)
  with a single broadcasted residual tensor,
* pick the smallest rung whose best hypothesis clears the inlier gate
  ``>= min(100, 20% of pairs)`` (``Match.py:166``), then least-squares refit
  on that hypothesis's inliers (``Match.py:280-283``).

Fixed trip count, fixed shapes, no host round-trips — one jitted call.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RansacConfig
from ..geometry import se3


def _horn_N_lanes(M):
    """Horn's symmetric 4x4 from 9 cross-covariance entry vectors:
    M[i][j] each (H,) -> (4, 4, H)."""
    tr = M[0][0] + M[1][1] + M[2][2]
    d0 = M[1][2] - M[2][1]
    d1 = M[2][0] - M[0][2]
    d2 = M[0][1] - M[1][0]
    row0 = jnp.stack([tr, d0, d1, d2])
    row1 = jnp.stack(
        [d0, 2 * M[0][0] - tr, M[0][1] + M[1][0], M[0][2] + M[2][0]]
    )
    row2 = jnp.stack(
        [d1, M[0][1] + M[1][0], 2 * M[1][1] - tr, M[1][2] + M[2][1]]
    )
    row3 = jnp.stack(
        [d2, M[0][2] + M[2][0], M[1][2] + M[2][1], 2 * M[2][2] - tr]
    )
    return jnp.stack([row0, row1, row2, row3])


def _quat_to_rot_entries(q):
    """(4, H) quaternion (w, x, y, z) -> 3x3 nested list of (H,) entries."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (y * w + z * x)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]


class RansacResult(NamedTuple):
    R: jnp.ndarray            # (3, 3)
    t: jnp.ndarray            # (3,)
    success: jnp.ndarray      # () bool
    inlier_mask: jnp.ndarray  # (K,) bool — over the input pairs
    n_inliers: jnp.ndarray    # () int32
    threshold: jnp.ndarray    # () float32 — accepted residual rung


@functools.partial(jax.jit, static_argnames=("cfg",))
def ransac_rigid(key: jax.Array, pairs0: jnp.ndarray, pairs1: jnp.ndarray,
                 pair_mask: jnp.ndarray,
                 cfg: RansacConfig = RansacConfig(),
                 pair_dist: jnp.ndarray | None = None) -> RansacResult:
    """Estimate the rigid transform mapping ``pairs1 -> pairs0``.

    Args:
      key: PRNG key.
      pairs0/pairs1: ``(K, 3)`` matched point pairs (padded).
      pair_mask: ``(K,)`` validity.
      pair_dist: optional ``(K,)`` match quality (descriptor distance);
        when given, hypothesis samples are drawn only from the best
        ``cfg.sample_top_frac`` of pairs (residuals still use all pairs).
    """
    K = pairs0.shape[0]
    H = cfg.n_hypotheses
    S = cfg.sample_size
    n_valid = jnp.sum(pair_mask)

    # --- sample S valid pair indices per hypothesis
    sample_ok = pair_mask
    if pair_dist is not None and cfg.sample_top_frac < 1.0:
        n_top = jnp.maximum(
            (cfg.sample_top_frac * n_valid).astype(jnp.int32), 4 * S
        )
        d = jnp.where(pair_mask, pair_dist, jnp.inf)
        cutoff = jnp.sort(d)[jnp.clip(n_top - 1, 0, K - 1)]
        sample_ok = pair_mask & (d <= cutoff)
    logits = jnp.where(sample_ok, 0.0, -jnp.inf)
    samp = jax.random.categorical(key, logits, shape=(H, S))

    # --- solve all hypotheses (batched Horn) and evaluate residuals, in a
    # structure-of-arrays layout: every array below is (H,)-, (S, H)- or
    # (H, K)-shaped so the large axis is the minor one, instead of the AoS
    # form ((H, S, 3) points, (H, 3, 3) rotations, einsum over j=3).
    p0T = pairs0.T                                   # (3, K)
    p1T = pairs1.T
    s0 = p0T[:, samp.T]                              # (3, S, H)
    s1 = p1T[:, samp.T]
    mean0 = jnp.mean(s0, axis=1)                     # (3, H)
    mean1 = jnp.mean(s1, axis=1)
    q0 = s0 - mean0[:, None, :]
    q1 = s1 - mean1[:, None, :]
    # cross covariance M[i][j] (H,) = sum_s q1_i q0_j
    M = [[jnp.sum(q1[i] * q0[j], axis=0) for j in range(3)] for i in range(3)]
    N = _horn_N_lanes(M)                             # (4, 4, H)
    quat = se3.max_eigvec_sym4x4_lanes(N)            # (4, H): (w, x, y, z)
    r = _quat_to_rot_entries(quat)                   # r[i][j]: (H,)
    # t = mean0 - R mean1  (3 entries of (H,))
    t_l = [
        mean0[i] - sum(r[i][j] * mean1[j] for j in range(3)) for i in range(3)
    ]

    # residuals of every hypothesis on every pair: 3 planes of (H, K)
    d2 = jnp.zeros((H, K), jnp.float32)
    for i in range(3):
        pred_i = (
            r[i][0][:, None] * p1T[0][None, :]
            + r[i][1][:, None] * p1T[1][None, :]
            + r[i][2][:, None] * p1T[2][None, :]
            + t_l[i][:, None]
        )
        diff = pred_i - p0T[i][None, :]
        d2 = d2 + diff * diff

    thresholds = jnp.array(cfg.residual_thresholds, jnp.float32)
    # per-rung inlier counts WITHOUT materializing a (T, H, K) tensor: the
    # compare fuses into each reduction; the winner's inlier mask is
    # recomputed from its d2 row at the end.
    d2m = jnp.where(pair_mask[None, :], d2, jnp.inf)
    counts = jnp.stack(
        [jnp.sum(d2m < th * th, axis=-1) for th in cfg.residual_thresholds]
    )                                                           # (T, H)
    # assemble (H, 3, 3) / (H, 3) for the (cheap) winner extraction below
    Rs = jnp.stack(
        [jnp.stack([r[i][j] for j in range(3)], -1) for i in range(3)], -2
    )
    ts = jnp.stack(t_l, -1)

    least = jnp.minimum(
        cfg.min_inlier_abs, (cfg.min_inlier_frac * n_valid).astype(jnp.int32)
    )
    least = jnp.maximum(least, S + 1)

    best_h = jnp.argmax(counts, axis=-1)                       # (T,)
    best_c = jnp.take_along_axis(counts, best_h[:, None], axis=-1)[:, 0]
    rung_ok = best_c >= least
    # smallest accepting rung; fall back to the last rung if none accept
    T = thresholds.shape[0]
    rung = jnp.where(jnp.any(rung_ok), jnp.argmax(rung_ok), T - 1)

    h = best_h[rung]
    success = rung_ok[rung]
    inlier_mask = d2m[h] < thresholds[rung] ** 2
    # --- final least-squares refit on the winning inlier set (Match.py:280-283)
    w = inlier_mask.astype(jnp.float32)
    R_fit, t_fit = se3.solve_rigid_horn(pairs0, pairs1, w)

    # --- iterative refit tightening (beyond the reference): re-gate the
    # inliers at the SMALLEST rung the refit pose still supports and refit
    # again.  When the hypothesis stage had to escalate (0.8/1.6 m rungs),
    # the wide gate admits consistently-displaced matches — e.g. points on
    # a moving car ~1 m off — and a single refit inherits their bias
    # (measured on the hard dynamic-scene benchmark: RTE spikes to 0.5-1 m
    # with rotation still sub-degree).  Tightening around the refit pose
    # keeps only the static structure.  No-op when the 0.4 m rung already
    # won and its inlier set is stable.
    def residuals(R, t):
        pred = jnp.einsum("ij,kj->ki", R, pairs1) + t
        d2p = jnp.sum((pred - pairs0) ** 2, axis=-1)
        return jnp.where(pair_mask, d2p, jnp.inf)

    def tighten(carry, _):
        R_c, t_c, rung_c, mask_c = carry
        d2p = residuals(R_c, t_c)
        counts_p = jnp.stack(
            [jnp.sum(d2p < th * th) for th in cfg.residual_thresholds])
        ok_p = counts_p >= least
        rung_n = jnp.where(jnp.any(ok_p), jnp.argmax(ok_p), rung_c)
        mask_n = d2p < thresholds[rung_n] ** 2
        R_n, t_n = se3.solve_rigid_horn(
            pairs0, pairs1, mask_n.astype(jnp.float32))
        return (R_n, t_n, rung_n, mask_n), None

    if cfg.refit_iters > 0:
        (R_t, t_t, rung_t, mask_t), _ = jax.lax.scan(
            tighten, (R_fit, t_fit, rung, inlier_mask),
            None, length=cfg.refit_iters)
        R_fit = jnp.where(success, R_t, R_fit)
        t_fit = jnp.where(success, t_t, t_fit)
        rung = jnp.where(success, rung_t, rung)
        inlier_mask = jnp.where(success, mask_t, inlier_mask)

    R = jnp.where(success, R_fit, Rs[h])
    t = jnp.where(success, t_fit, ts[h])
    return RansacResult(
        R=R,
        t=t,
        success=success,
        inlier_mask=inlier_mask,
        n_inliers=jnp.where(success, jnp.sum(inlier_mask), counts[rung, h]),
        threshold=thresholds[rung],
    )
