"""Iterative closest point: fixed-trip loops, matmul correspondence.

Replaces the reference ICP (``MyICP.py:28-71`` point-to-point and
``:127-201`` hybrid point-to-point + point-to-plane) whose inner loop is a
sklearn KD-tree query per iteration.  Design:

* correspondence = brute-force nearest neighbor via the squared-distance
  matmul identity, tiled over the source cloud so the full MxN matrix never
  materializes (a KD-tree's data-dependent traversal does not batch; a
  matmul does);
* the whole solve is ONE jitted ``lax.fori_loop`` with masked "done"
  freezing instead of data-dependent breaks (``MyICP.py:59-61``);
* threshold decay / small-shift logic follows ``MyICP.py:63-67``.

Point-to-plane correspondences use the reference's pedal-point projection
(``GetPlanarPtsInliners``, ``MyICP.py:87-113``): project the target point
onto the source point's tangent plane and feed the (pedal, source) pair to
the same rigid solver.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import IcpConfig
from ..geometry import se3


def nearest_neighbors(query: jnp.ndarray, query_mask: jnp.ndarray,
                      ref: jnp.ndarray, ref_mask: jnp.ndarray,
                      chunk: int = 1024):
    """For each query point, index + distance of nearest reference point.

    Tiled matmul argmin: ``(N, 3) x (M, 3)`` in chunks of ``chunk`` queries.
    Invalid reference points are pushed to +inf.
    """
    r2 = jnp.sum(ref * ref, axis=-1)
    r2 = jnp.where(ref_mask, r2, jnp.inf)
    N = query.shape[0]
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N
    qp = jnp.pad(query, ((0, pad), (0, 0)))

    def one(qc):
        q2 = jnp.sum(qc * qc, axis=-1)
        d2 = (
            q2[:, None]
            + r2[None, :]
            - 2.0 * jnp.dot(qc, ref.T, preferred_element_type=jnp.float32)
        )
        return jnp.argmin(d2, axis=-1).astype(jnp.int32)

    idx = jax.lax.map(one, qp.reshape(n_chunks, chunk, 3)).reshape(-1)[:N]
    # the expansion identity suffers catastrophic cancellation for near-zero
    # distances; recompute the winning distance exactly with one gather
    d2 = jnp.sum((query - ref[idx]) ** 2, axis=-1)
    dist = jnp.sqrt(jnp.maximum(jnp.where(query_mask, d2, jnp.inf), 0.0))
    return idx, dist


def _nn(query, query_mask, ref, ref_mask, cfg: IcpConfig):
    """Correspondence search: the chunked XLA distance matmul."""
    return nearest_neighbors(query, query_mask, ref, ref_mask)


class IcpResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    success: jnp.ndarray
    n_inliers: jnp.ndarray
    iters: jnp.ndarray
    # saturated mean point-to-nearest distance of the pt2pt source cloud at
    # the INITIAL pose and at convergence (same metric, same saturation cap
    # — comparable).  A correction that doesn't reduce this materially is a
    # sensor-locked biased optimum, not a repair; the refinement accept
    # gate uses the gain (see RefineConfig.residual_gain_frac).
    init_res: jnp.ndarray = jnp.float32(0.0)
    final_res: jnp.ndarray = jnp.float32(0.0)


_RES_CAP = 2.0   # metres; saturation bound for the residual metric


def _sat_mean(dist, mask):
    w = mask.astype(jnp.float32)
    return (jnp.sum(jnp.minimum(jnp.where(mask, dist, 0.0), _RES_CAP) * w)
            / jnp.maximum(jnp.sum(w), 1.0))


@functools.partial(jax.jit, static_argnames=("cfg",))
def icp_point_to_point(pc0: jnp.ndarray, mask0: jnp.ndarray,
                       pc1: jnp.ndarray, mask1: jnp.ndarray,
                       cfg: IcpConfig = IcpConfig()) -> IcpResult:
    """Classic ICP aligning ``pc1`` onto ``pc0`` (``MyICP.py:28-71``)."""

    def body(i, st):
        R, t, pc1c, thr, done, n_in, iters = st
        idx, dist = _nn(pc1c, mask1, pc0, mask0, cfg)
        w = ((dist < thr) & mask1).astype(jnp.float32)
        n = jnp.sum(w).astype(jnp.int32)
        enough = n >= cfg.min_inliers
        Rd, td = se3.solve_rigid_horn(pc0[idx], pc1c, w)
        # freeze updates once done or under-constrained
        step_ok = (~done) & enough
        Rd = jnp.where(step_ok, Rd, jnp.eye(3, dtype=R.dtype)).astype(R.dtype)
        td = jnp.where(step_ok, td, 0.0).astype(t.dtype)
        pc1c = se3.apply(Rd, td, pc1c)
        R, t = se3.compose(Rd, td, R, t)
        # convergence / decay bookkeeping (MyICP.py:56-67)
        d_ang = jnp.linalg.norm(se3.rotmat_to_euler_xyz_deg(Rd))
        d_t = jnp.linalg.norm(td)
        converged = (i >= cfg.max_iters // 2) & (d_ang < cfg.epsilon) & (d_t < cfg.epsilon)
        small = (d_ang < cfg.small_shift_threshold) & (d_t < cfg.small_shift_threshold)
        thr = jnp.where(step_ok & small, thr * cfg.decay, thr)
        n_in = jnp.where(step_ok, n, n_in)
        iters = jnp.where(step_ok, i + 1, iters)
        done = done | converged | (~enough)
        return (R, t, pc1c, thr, done, n_in, iters)

    st = (
        jnp.eye(3, dtype=pc0.dtype),
        jnp.zeros((3,), pc0.dtype),
        pc1,
        jnp.asarray(cfg.inlier_threshold, pc0.dtype),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    R, t, _, _, _, n_in, iters = jax.lax.fori_loop(0, cfg.max_iters, body, st)
    return IcpResult(R, t, n_in >= cfg.min_inliers, n_in, iters)


@functools.partial(jax.jit, static_argnames=("cfg",))
def icp_hybrid(pc0: jnp.ndarray, mask0: jnp.ndarray,
               pc1: jnp.ndarray, mask1: jnp.ndarray,
               planar0: jnp.ndarray, pmask0: jnp.ndarray,
               planar1: jnp.ndarray, pmask1: jnp.ndarray,
               cfg: IcpConfig = IcpConfig(),
               thr_scale=1.0) -> IcpResult:
    """Joint point-to-point + point-to-plane ICP
    (``ICP_Pt2PtAndPt2Plane``, ``MyICP.py:127-201``).

    ``planar*`` are ``(P, 6)`` rows of (x, y, z, nx, ny, nz).  The planar
    correspondences are pedal-point pairs: target point projected onto the
    matched source plane (``MyICP.py:104-113``), weighted into the same Horn
    solve as the point pairs.

    ``thr_scale`` (traced scalar) multiplies the INITIAL inlier thresholds:
    a coarse-to-fine retry rung for spans whose initial relative-pose guess
    is meters off (a constant-velocity fallback through a turn), where the
    default 0.5 m gate starves the solver of inliers before it can pull the
    clouds together.  The decay schedule still tightens the gate as the
    solve converges, so an accepted result is as precise as a rung-1 one.
    """
    p0_xyz, n0 = planar0[:, 0:3], planar0[:, 3:6]

    def body(i, st):
        R, t, pc1c, pl1c, thr0, thr1, done, n_in, iters, r0m, rlast = st
        # point-to-point correspondences
        idx, dist = _nn(pc1c, mask1, pc0, mask0, cfg)
        res = _sat_mean(dist, mask1)
        r0m = jnp.where(i == 0, res, r0m)
        rlast = res
        w_pt = ((dist < thr0) & mask1).astype(jnp.float32)
        tgt_pt = pc0[idx]
        # point-to-plane: match planar1 -> planar0 xyz, project to pedal
        pidx, pdist = _nn(pl1c, pmask1, p0_xyz, pmask0, cfg)
        nrm = n0[pidx]
        anchor = p0_xyz[pidx]
        d2pl = jnp.sum(nrm * (anchor - pl1c), axis=-1)
        pedal = pl1c + nrm * d2pl[:, None]
        w_pl = (
            (pdist < thr1) & (jnp.abs(d2pl) < thr0) & pmask1
        ).astype(jnp.float32)

        src = jnp.concatenate([pc1c, pl1c], axis=0)
        tgt = jnp.concatenate([tgt_pt, pedal], axis=0)
        w = jnp.concatenate([w_pt, w_pl], axis=0)
        n = jnp.sum(w).astype(jnp.int32)
        enough = n >= cfg.min_inliers
        Rd, td = se3.solve_rigid_horn(tgt, src, w)
        step_ok = (~done) & enough
        Rd = jnp.where(step_ok, Rd, jnp.eye(3, dtype=R.dtype)).astype(R.dtype)
        td = jnp.where(step_ok, td, 0.0).astype(t.dtype)
        pc1c = se3.apply(Rd, td, pc1c)
        pl1c = se3.apply(Rd, td, pl1c)
        R, t = se3.compose(Rd, td, R, t)
        d_ang = jnp.linalg.norm(se3.rotmat_to_euler_xyz_deg(Rd))
        d_t = jnp.linalg.norm(td)
        converged = (i >= cfg.max_iters // 2) & (d_ang < cfg.epsilon) & (d_t < cfg.epsilon)
        small = (d_ang < cfg.small_shift_threshold) & (d_t < cfg.small_shift_threshold)
        thr0 = jnp.where(step_ok & small, thr0 * cfg.decay, thr0)
        thr1 = jnp.where(step_ok & small, thr1 * cfg.plane_decay, thr1)
        n_in = jnp.where(step_ok, n, n_in)
        iters = jnp.where(step_ok, i + 1, iters)
        done = done | converged | (~enough)
        return (R, t, pc1c, pl1c, thr0, thr1, done, n_in, iters, r0m, rlast)

    st = (
        jnp.eye(3, dtype=pc0.dtype),
        jnp.zeros((3,), pc0.dtype),
        pc1,
        planar1[:, 0:3],
        jnp.asarray(cfg.inlier_threshold * thr_scale, pc0.dtype),
        jnp.asarray(cfg.plane_inlier_threshold * thr_scale, pc0.dtype),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.float32(0.0),
        jnp.float32(0.0),
    )
    out = jax.lax.fori_loop(0, cfg.max_iters, body, st)
    R, t, _, _, _, _, _, n_in, iters, r0m, rlast = out
    return IcpResult(R, t, n_in >= cfg.min_inliers, n_in, iters,
                     init_res=r0m, final_res=rlast)
