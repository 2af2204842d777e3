"""Batched SE(3) / rotation algebra in JAX.

Batched replacement for the reference's per-matrix numpy loops in
``Transformations.py`` (Euler/quaternion/axis-angle converters at
:181-272, relative-pose algebra at :94-150).  Everything here is pure
``jnp``, shape-polymorphic over leading batch dimensions, and jit/vmap
friendly.

Conventions (matching the reference):
* A rigid transform is an ``(R, t)`` pair with ``R`` of shape ``(..., 3, 3)``
  and ``t`` of shape ``(..., 3)``; it maps points ``x -> R @ x + t``.
* Euler extraction is the XYZ convention in *degrees*
  (``Transformations.py:181-186``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

RADIAN2DEGREE = 180.0 / jnp.pi


def apply(R: jnp.ndarray, t: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply ``x -> R x + t`` to points of shape ``(..., N, 3)``."""
    return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def compose(R1, t1, R2, t2):
    """Return the transform equal to applying (R2, t2) first, then (R1, t1).

    HIGHEST matmul precision: device f32 matmuls default to reduced
    precision (TF32 on a GPU, ~1e-3 relative error), and pose composition
    CHAINS — a device-side
    chain of default-precision 3x3 products drifts off SO(3) measurably
    (observed: det 0.976 after ~30 composed ICP steps; a 41-frame
    burst-rescue chain reached ||R^T R - I|| ~ 1.5 and exploded the
    downstream pose chain exponentially).  These are 3x3s — precision is
    free."""
    R = jnp.matmul(R1, R2, precision=jax.lax.Precision.HIGHEST)
    t = (jnp.einsum("...ij,...j->...i", R1, t2,
                    precision=jax.lax.Precision.HIGHEST) + t1)
    return R, t


def project_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Nearest-ish rotation by Gram-Schmidt on rows (batched).  Cheap
    re-orthonormalization for long device-side pose chains (see
    :func:`compose`); exact for inputs already in SO(3)."""
    r0 = R[..., 0, :]
    r0 = r0 / jnp.maximum(jnp.linalg.norm(r0, axis=-1, keepdims=True), 1e-20)
    r1 = R[..., 1, :]
    r1 = r1 - jnp.sum(r0 * r1, axis=-1, keepdims=True) * r0
    r1 = r1 / jnp.maximum(jnp.linalg.norm(r1, axis=-1, keepdims=True), 1e-20)
    r2 = jnp.cross(r0, r1)
    return jnp.stack([r0, r1, r2], axis=-2)


def inverse(R, t):
    Rin = jnp.swapaxes(R, -1, -2)
    return Rin, -jnp.einsum("...ij,...j->...i", Rin, t)


def rotmat_to_euler_xyz_deg(R: jnp.ndarray) -> jnp.ndarray:
    """XYZ Euler angles in degrees (reference ``RotateMat2EulerAngle_XYZ``,
    ``Transformations.py:181-186``)."""
    ax = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    ay = jnp.arctan2(
        -R[..., 2, 0], jnp.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2)
    )
    az = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([ax, ay, az], axis=-1) * RADIAN2DEGREE


def euler_xyz_to_rotmat(angles_rad: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix R = Rz @ Ry @ Rx from XYZ Euler angles in radians
    (reference ``EulerAngle2RotateMat`` with sequence 'xyz',
    ``Transformations.py:188-211``)."""
    ax, ay, az = angles_rad[..., 0], angles_rad[..., 1], angles_rad[..., 2]
    cx, sx = jnp.cos(ax), jnp.sin(ax)
    cy, sy = jnp.cos(ay), jnp.sin(ay)
    cz, sz = jnp.cos(az), jnp.sin(az)
    one = jnp.ones_like(ax)
    zero = jnp.zeros_like(ax)
    Rx = jnp.stack(
        [
            jnp.stack([one, zero, zero], -1),
            jnp.stack([zero, cx, -sx], -1),
            jnp.stack([zero, sx, cx], -1),
        ],
        -2,
    )
    Ry = jnp.stack(
        [
            jnp.stack([cy, zero, sy], -1),
            jnp.stack([zero, one, zero], -1),
            jnp.stack([-sy, zero, cy], -1),
        ],
        -2,
    )
    Rz = jnp.stack(
        [
            jnp.stack([cz, -sz, zero], -1),
            jnp.stack([sz, cz, zero], -1),
            jnp.stack([zero, zero, one], -1),
        ],
        -2,
    )
    return Rz @ Ry @ Rx


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix
    (reference ``Quatern2RotMat``, ``Transformations.py:241-252``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (y * w + z * x)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], -1),
            jnp.stack([r10, r11, r12], -1),
            jnp.stack([r20, r21, r22], -1),
        ],
        -2,
    )


def rotmat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z) via the symmetric
    4x4 eigen method (reference ``RotMat2Quatern``,
    ``Transformations.py:213-239``; Bar-Itzhack method), via the batched
    Jacobi eigensolver."""
    K = _bar_itzhack_K(R)
    q = max_eigvec_sym4x4(K)  # eigenvector of the largest eigenvalue
    # stored order in K is (x, y, z, w) with the vector part conjugated
    # relative to our quat_to_rotmat convention; convert to (w, x, y, z)
    q = jnp.concatenate([q[..., 3:4], -q[..., 0:3]], axis=-1)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)


def _bar_itzhack_K(R):
    t = 1.0 / 3.0
    r = lambda i, j: R[..., i, j]
    K00 = t * (r(0, 0) - r(1, 1) - r(2, 2))
    K11 = t * (r(1, 1) - r(0, 0) - r(2, 2))
    K22 = t * (r(2, 2) - r(0, 0) - r(1, 1))
    K33 = t * (r(0, 0) + r(1, 1) + r(2, 2))
    K01 = t * (r(1, 0) + r(0, 1))
    K02 = t * (r(2, 0) + r(0, 2))
    K03 = t * (r(1, 2) - r(2, 1))
    K12 = t * (r(2, 1) + r(1, 2))
    K13 = t * (r(2, 0) - r(0, 2))
    K23 = t * (r(0, 1) - r(1, 0))
    row0 = jnp.stack([K00, K01, K02, K03], -1)
    row1 = jnp.stack([K01, K11, K12, K13], -1)
    row2 = jnp.stack([K02, K12, K22, K23], -1)
    row3 = jnp.stack([K03, K13, K23, K33], -1)
    return jnp.stack([row0, row1, row2, row3], -2)


def angle_axis_to_quat(angle: jnp.ndarray, axis: jnp.ndarray) -> jnp.ndarray:
    """(angle, unit axis) -> quaternion (w, x, y, z)
    (reference ``AngleAxis2Quatern``, ``Transformations.py:264-272``)."""
    half = angle / 2.0
    s = jnp.sin(half)
    return jnp.concatenate(
        [jnp.cos(half)[..., None], axis * s[..., None]], axis=-1
    )


def quat_to_angle_axis(q: jnp.ndarray):
    """Quaternion -> (angle, axis) (reference ``Quatern2AngleAndAxis``,
    ``Transformations.py:254-262``)."""
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    half = jnp.arccos(w)
    s = jnp.sin(half)
    safe = jnp.where(jnp.abs(s) < 1e-12, 1.0, s)
    axis = q[..., 1:4] / safe[..., None]
    axis = jnp.where(jnp.abs(s)[..., None] < 1e-12, jnp.zeros_like(axis), axis)
    return 2.0 * half, axis


def max_eigvec_sym4x4_lanes(A: jnp.ndarray, sweeps: int = 8) -> jnp.ndarray:
    """Like ``max_eigvec_sym4x4`` but with the batch on the LAST axis:
    ``A`` is ``(4, 4, B)``, returns ``(4, B)``.

    Every matrix entry ``A[p, q]`` is a contiguous ``(B,)`` vector, so all
    48 Givens rotations are elementwise math over the batch, instead of a
    batch of tiny ``(B, 4, 4) @ (B, 4, 4)`` matmuls with 4-wide minor
    dimensions.
    """
    B = A.shape[-1]
    V = jnp.zeros((4, 4, B), A.dtype) + jnp.eye(4, dtype=A.dtype)[..., None]
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

    for _ in range(sweeps):
        for p, q in pairs:
            theta = 0.5 * jnp.arctan2(2.0 * A[p, q], A[p, p] - A[q, q])
            c = jnp.cos(theta)
            s = jnp.sin(theta)
            # rows of A
            Ap = c * A[p] + s * A[q]
            Aq = -s * A[p] + c * A[q]
            A = A.at[p].set(Ap).at[q].set(Aq)
            # columns of A
            Ap = c * A[:, p] + s * A[:, q]
            Aq = -s * A[:, p] + c * A[:, q]
            A = A.at[:, p].set(Ap).at[:, q].set(Aq)
            # accumulate V G
            Vp = c * V[:, p] + s * V[:, q]
            Vq = -s * V[:, p] + c * V[:, q]
            V = V.at[:, p].set(Vp).at[:, q].set(Vq)

    diag = jnp.stack([A[i, i] for i in range(4)])          # (4, B)
    imax = jnp.argmax(diag, axis=0)                         # (B,)
    onehot = (jnp.arange(4)[:, None] == imax[None, :]).astype(A.dtype)
    v = jnp.einsum("ijb,jb->ib", V, onehot)                 # (4, B)
    return v / jnp.linalg.norm(v, axis=0, keepdims=True)


def max_eigvec_sym4x4(A: jnp.ndarray, sweeps: int = 8) -> jnp.ndarray:
    """Eigenvector of the largest eigenvalue of a symmetric 4x4, batched.

    Cyclic Jacobi with a fixed sweep count: 6 Givens rotations per sweep,
    pure elementwise math, no data-dependent control flow.  For 4x4
    symmetric matrices 8 sweeps reach float32 machine precision.

    This replaces ``jnp.linalg.eigh`` in the Horn solves: XLA lowers `eigh`
    to a sequential QR-style algorithm per matrix; the batched Jacobi is
    elementwise math over the whole batch.
    """
    V = jnp.broadcast_to(jnp.eye(4, dtype=A.dtype), A.shape)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    eye = jnp.eye(4, dtype=A.dtype)

    def rotate(A, V, p, q):
        app = A[..., p, p]
        aqq = A[..., q, q]
        apq = A[..., p, q]
        # Jacobi angle: theta = 0.5 atan2(2 apq, app - aqq)
        theta = 0.5 * jnp.arctan2(2.0 * apq, app - aqq)
        c = jnp.cos(theta)[..., None, None]
        s = jnp.sin(theta)[..., None, None]
        # Givens matrix G built from constant masks (scatter-free: unrolled
        # .at[] updates on traced values bloat compile time)
        P = jnp.zeros((4, 4), A.dtype).at[p, p].set(1).at[q, q].set(1)
        S = jnp.zeros((4, 4), A.dtype).at[q, p].set(1).at[p, q].set(-1)
        G = eye - P + c * P + s * S
        A = jnp.swapaxes(G, -1, -2) @ A @ G
        V = V @ G
        return A, V

    for _ in range(sweeps):
        for p, q in pairs:
            A, V = rotate(A, V, p, q)

    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    imax = jnp.argmax(diag, axis=-1)
    v = jnp.take_along_axis(
        V, imax[..., None, None].repeat(4, axis=-2), axis=-1
    )[..., 0]
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def solve_rigid_horn(
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    weights: jnp.ndarray | None = None,
):
    """Weighted least-squares rigid transform mapping ``p1 -> p0``.

    Batched replacement for the reference SVD Kabsch solver
    (``Match.py:138-158``) using Horn's closed-form quaternion method (the
    same family as the reference MATLAB ``estimateRigidTransform.m:6-8``):
    build the symmetric 4x4 N-matrix from the cross-covariance and take the
    eigenvector of its largest eigenvalue.  Unlike SVD, this always yields a
    *proper* rotation (no reflection branch, ``Match.py:151-155``), and a
    batched 4x4 ``eigh`` vmaps cleanly for the parallel RANSAC hypothesis
    solve.

    Args:
      p0: ``(..., N, 3)`` target points.
      p1: ``(..., N, 3)`` source points.
      weights: optional ``(..., N)`` nonnegative weights (inlier masks).

    Returns:
      ``(R, t)`` with shapes ``(..., 3, 3)`` and ``(..., 3)``.
    """
    if weights is None:
        weights = jnp.ones(p0.shape[:-1], p0.dtype)
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-9)
    mean0 = jnp.sum(p0 * w, axis=-2) / wsum
    mean1 = jnp.sum(p1 * w, axis=-2) / wsum
    q0 = p0 - mean0[..., None, :]
    q1 = p1 - mean1[..., None, :]
    # cross covariance M[i, j] = sum_n w_n * q1[n, i] * q0[n, j]
    M = jnp.einsum("...ni,...nj->...ij", q1 * w, q0)
    N = _horn_N(M)
    q = max_eigvec_sym4x4(N)  # (w, x, y, z), rotation taking q1 into q0
    R = quat_to_rotmat(q)
    t = mean0 - jnp.einsum("...ij,...j->...i", R, mean1)
    return R, t


def _horn_N(M):
    """Horn's symmetric 4x4 matrix from a 3x3 cross-covariance."""
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    m = lambda i, j: M[..., i, j]
    d0 = m(1, 2) - m(2, 1)
    d1 = m(2, 0) - m(0, 2)
    d2 = m(0, 1) - m(1, 0)
    row0 = jnp.stack([tr, d0, d1, d2], -1)
    row1 = jnp.stack(
        [d0, 2 * m(0, 0) - tr, m(0, 1) + m(1, 0), m(0, 2) + m(2, 0)], -1
    )
    row2 = jnp.stack(
        [d1, m(0, 1) + m(1, 0), 2 * m(1, 1) - tr, m(1, 2) + m(2, 1)], -1
    )
    row3 = jnp.stack(
        [d2, m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), 2 * m(2, 2) - tr], -1
    )
    return jnp.stack([row0, row1, row2, row3], -2)


def correct_beam_angle(pts: jnp.ndarray, angle_deg: float = 0.22) -> jnp.ndarray:
    """Velodyne beam-angle intrinsic correction: rotate each point by
    ``angle_deg`` about the axis ``p x z`` (reference ``CorrectPC``,
    ``Transformations.py:28-39`` — a per-point Python loop building a
    quaternion each; and ``Scripts/CorrectPts.m``).  Vectorized via Rodrigues
    on the per-point axis."""
    z = jnp.array([0.0, 0.0, 1.0], pts.dtype)
    axis = jnp.cross(pts, z)
    n = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.where(n < 1e-12, 1.0, n)
    w = axis * jnp.radians(angle_deg)
    R = exp_so3(w)                                   # (N, 3, 3)
    out = jnp.einsum("nij,nj->ni", R, pts)
    return jnp.where(n < 1e-12, pts, out)


def correct_beam_angle_np(pts: "np.ndarray", angle_deg: float = 0.22):
    """Host-side (numpy) twin of :func:`correct_beam_angle` for the scan
    loaders — scan IO is host code, so the per-scan intrinsic fix must not
    dispatch to the device.  Same math: rotate each point by ``angle_deg``
    about ``p x z`` (Rodrigues on the per-point axis).

    Parity deviation (deliberate): for points exactly on the z-axis the
    reference's normalize produces NaN which it then zeroes, collapsing the
    point to the origin (``CorrectPts.m``); here the degenerate axis leaves
    the point untouched — the rotation is undefined there and keeping the
    point is strictly better than destroying it."""
    import numpy as np

    pts = np.asarray(pts)
    z = np.array([0.0, 0.0, 1.0], pts.dtype)
    axis = np.cross(pts, z)
    n = np.linalg.norm(axis, axis=-1, keepdims=True)
    k = axis / np.where(n < 1e-12, 1.0, n)
    th = np.float32(np.radians(angle_deg))
    # Rodrigues rotation of p about unit axis k by angle th
    out = (pts * np.cos(th)
           + np.cross(k, pts) * np.sin(th)
           + k * np.sum(k * pts, axis=-1, keepdims=True) * (1 - np.cos(th)))
    return np.where(n < 1e-12, pts, out).astype(pts.dtype)


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: axis-angle vector ``(..., 3)`` -> rotation matrix.
    Taylor-safe near zero (needed for autodiff through the pose graph)."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    safe = theta2 > 1e-12
    # evaluate the trig branch at a safe argument so its gradient is finite
    # even where the Taylor branch is selected (nan-through-where guard)
    t2s = jnp.where(safe, theta2, 1.0)
    theta = jnp.sqrt(t2s)
    K = skew(w)
    A = jnp.where(safe, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    B = jnp.where(safe, (1.0 - jnp.cos(theta)) / t2s, 0.5 - theta2 / 24.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + A * K + B * (K @ K)


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle vector (principal branch), batched and
    differentiable away from theta = pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = jnp.clip((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(c)
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    safe = theta > 1e-7
    s = jnp.where(safe, 2.0 * jnp.sin(theta), 1.0)  # safe denominator
    scale = jnp.where(
        safe[..., None],
        (theta / s)[..., None],
        0.5 + theta[..., None] ** 2 / 12.0,
    )
    return v * scale


def skew(w: jnp.ndarray) -> jnp.ndarray:
    """``(..., 3)`` -> skew-symmetric ``(..., 3, 3)``."""
    z = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -w[..., 2], w[..., 1]], -1),
            jnp.stack([w[..., 2], z, -w[..., 0]], -1),
            jnp.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def rotation_geodesic_deg(R0: jnp.ndarray, R1: jnp.ndarray) -> jnp.ndarray:
    """Geodesic angle between two rotations, in degrees."""
    Rrel = jnp.swapaxes(R0, -1, -2) @ R1
    tr = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    c = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return jnp.arccos(c) * RADIAN2DEGREE
