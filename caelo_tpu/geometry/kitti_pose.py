"""KITTI pose-row algebra: camera<->lidar conjugation and pose chaining.

The reference stores trajectories as KITTI 3x4 row-major pose rows and
conjugates lidar-frame relative motions with the camera-lidar calibration
``Tr`` (``Transformations.py:106-150``, ``PoseEstimation.py:259-267``).
This module provides the batched equivalents.

Definitions (matching the reference exactly):
* ``pose`` row = flattened ``[R | t]`` (3x4) mapping *camera-frame* points of
  frame k into the world frame of frame 0.
* ``rel_pose_cam(pose0, pose1)`` is the transform of frame-1 points into
  frame 0 (``GetRelRtBetween2Poses``, ``Transformations.py:106-113``).
* ``rel_pose_lidar`` additionally conjugates with ``Tr``
  (``GetLidarRelRtBetween2Poses``, ``Transformations.py:118-125``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import se3


def poses_to_rt(poses: jnp.ndarray):
    """``(..., 12)`` pose rows -> ``(R, t)`` (``GetRtFromOnePose``,
    ``Transformations.py:164-168``)."""
    P = poses.reshape(poses.shape[:-1] + (3, 4))
    return P[..., :, 0:3], P[..., :, 3]


def rt_to_poses(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    P = jnp.concatenate([R, t[..., :, None]], axis=-1)
    return P.reshape(P.shape[:-2] + (12,))


def rel_pose_cam(pose0: jnp.ndarray, pose1: jnp.ndarray):
    """Camera-frame relative transform frame1 -> frame0
    (``Transformations.py:106-113``)."""
    R0, t0 = poses_to_rt(pose0)
    R1, t1 = poses_to_rt(pose1)
    R0i, t0i = se3.inverse(R0, t0)
    return se3.compose(R0i, t0i, R1, t1)


def rel_pose_lidar(pose0, pose1, R_tr, t_tr):
    """Lidar-frame relative transform frame1 -> frame0, conjugated with the
    camera-lidar calibration (``GetLidarRelRtBetween2Poses``,
    ``Transformations.py:118-125``):  ``rel_l = Tr^-1 * pose0^-1 * pose1 * Tr``.
    """
    Rc, tc = rel_pose_cam(pose0, pose1)
    R_tri, t_tri = se3.inverse(R_tr, t_tr)
    R, t = se3.compose(Rc, tc, R_tr, t_tr)
    return se3.compose(R_tri, t_tri, R, t)


def lidar_rel_to_cam(relR, relT, R_tr, t_tr):
    """Conjugate a lidar-frame relative motion into the camera pose-delta used
    for chaining (``PoseEstimation.py:259-263``, ``AdjustPoses``
    ``Transformations.py:68-69``): ``delta_cam = Tr * rel_l * Tr^-1``."""
    R_tri, t_tri = se3.inverse(R_tr, t_tr)
    R, t = se3.compose(relR, relT, R_tri, t_tri)
    return se3.compose(R_tr, t_tr, R, t)


def chain_poses(rel_Rs, rel_ts, R_tr, t_tr, pose0=None):
    """Chain per-frame lidar relative motions into KITTI pose rows.

    Host float64 numpy, deliberately: the chain is a prefix product of
    thousands of 4x4 matrices, and running it on a device at default f32
    matmul precision (bf16 passes or TF32) quantizes every product — on the
    520-frame hard benchmark this alone once injected ~0.3 m / ~0.4 deg of
    apparent per-pair error into otherwise-excellent odometry.
    A few thousand 4x4 f64 products are microseconds on the host; this is
    pose bookkeeping (``PoseEstimation.py:254-267``), not device compute.

    Args:
      rel_Rs: ``(N, 3, 3)`` lidar-frame relative rotations (frame k+1 -> k).
      rel_ts: ``(N, 3)`` lidar-frame relative translations.
      R_tr, t_tr: camera-lidar calibration.
      pose0: optional ``(12,)`` starting pose row (defaults to identity).

    Returns:
      ``(N + 1, 12)`` float64 pose rows.
    """
    import numpy as np

    rel_Rs = np.asarray(rel_Rs, np.float64)
    rel_ts = np.asarray(rel_ts, np.float64)
    R_tr = np.asarray(R_tr, np.float64)
    t_tr = np.asarray(t_tr, np.float64)
    R_tri = R_tr.T
    t_tri = -R_tri @ t_tr
    N = rel_Rs.shape[0]
    # delta_cam = Tr * rel_l * Tr^-1
    dR = np.einsum("ij,njk,kl->nil", R_tr, rel_Rs, R_tri)
    dt = (np.einsum("ij,njk,k->ni", R_tr, rel_Rs, t_tri)
          + rel_ts @ R_tr.T + t_tr)
    out = np.empty((N + 1, 12))
    if pose0 is not None:
        P = np.asarray(pose0, np.float64).reshape(3, 4)
        R, t = P[:, :3].copy(), P[:, 3].copy()
    else:
        R, t = np.eye(3), np.zeros(3)
    out[0] = np.concatenate([R, t[:, None]], axis=1).reshape(12)
    for k in range(N):
        t = R @ dt[k] + t
        R = R @ dR[k]
        # re-orthonormalize as we chain: the device rels are f32 (det
        # 1 +- ~1e-6 each) and downstream bookkeeping RE-DERIVES rels from
        # these poses and re-chains — any accumulated det error compounds
        # multiplicatively there (see backend.refine._orth)
        r0 = R[0] / np.linalg.norm(R[0])
        r1 = R[1] - (r0 @ R[1]) * r0
        r1 = r1 / np.linalg.norm(r1)
        R = np.stack([r0, r1, np.cross(r0, r1)])
        out[k + 1] = np.concatenate([R, t[:, None]], axis=1).reshape(12)
    return out


def load_calib_tr(path: str):
    """Load the 3x4 lidar->camera ``Tr`` row from a KITTI ``calib.txt``.

    The reference reads a pre-stripped ``calib_.txt`` whose 5th row is ``Tr``
    (``Match.py:362-364``); we handle both the raw ``key: values`` format and
    the stripped numeric table.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                key, vals = line.split(":", 1)
                rows.append((key.strip(), np.fromstring(vals, sep=" ")))
            else:
                rows.append((None, np.fromstring(line, sep=" ")))
    for key, vals in rows:
        if key == "Tr":
            M = vals.reshape(3, 4)
            return M[:, :3].astype(np.float64), M[:, 3].astype(np.float64)
    # stripped format: 5th numeric row is Tr
    M = rows[4][1].reshape(3, 4)
    return M[:, :3].astype(np.float64), M[:, 3].astype(np.float64)
