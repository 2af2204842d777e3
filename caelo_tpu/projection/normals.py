"""Planar-point extraction with normals from the spherical-ring image.

The reference left this path dormant: ``GetKeyPtsByAE`` returns an empty
``PlanarPts`` array (``SphericalRing.py:219,285``) and the point-to-plane
half of the hybrid ICP therefore never fires with real data (the intended
computation survives as the commented block ``SphericalRing.py:268-276``:
5x5-window covariance eigendecomposition, keep near-vertical normals).
README.md:30 lists it as future work.  Here it is implemented for real, as
batched device ops:

* per-pixel 5x5 window covariance over the ring image (shifted-slice sums,
  same trick as the NMS saliency map — elementwise work);
* smallest-eigenvector normal via the closed-form symmetric 3x3
  eigensolver (Smith's trigonometric method) on scalar planes;
* planarity gate: smallest eigenvalue ratio + the reference's low-saliency
  criterion (min-diff < PlanarThreshold, ``SphericalRing.py:129``).

Layout note (r3): every intermediate is a structure-of-planes — separate
``(H, W)`` arrays per vector/matrix component — never ``(H, W, 3)`` or
``(H, W, 3, 3)``: the AoS formulation multiplies the memory of the fused
window program where the compiler pads narrow minor dimensions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SensorConfig


def _smallest_eigvec_sym3x3(axx, axy, axz, ayy, ayz, azz):
    """Closed-form smallest eigenpair of symmetric 3x3 matrices given as
    six scalar planes (Smith's trigonometric method).  Returns
    ``(lam0, lam1, nx, ny, nz)`` scalar planes with ``lam0 <= lam1`` the
    two smallest eigenvalues and ``n`` the (unnormalized-safe, normalized
    on output) eigenvector for ``lam0``."""
    q = (axx + ayy + azz) / 3.0
    p1 = axy * axy + axz * axz + ayz * ayz
    bxx, byy, bzz = axx - q, ayy - q, azz - q
    p2 = bxx * bxx + byy * byy + bzz * bzz + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2, 1e-30) / 6.0)
    ip = 1.0 / p
    cxx, cyy, czz = bxx * ip, byy * ip, bzz * ip
    cxy, cxz, cyz = axy * ip, axz * ip, ayz * ip
    detB = (cxx * (cyy * czz - cyz * cyz)
            - cxy * (cxy * czz - cyz * cxz)
            + cxz * (cxy * cyz - cyy * cxz))
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_hi = q + 2.0 * p * jnp.cos(phi)
    lam_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo

    # eigenvector for lam_lo: cross products of rows of (A - lam I); take
    # the best-conditioned pair
    d0, d1, d2 = axx - lam_lo, ayy - lam_lo, azz - lam_lo
    # rows: (d0, axy, axz), (axy, d1, ayz), (axz, ayz, d2)
    c01x = axy * ayz - d1 * axz
    c01y = axz * axy - d0 * ayz
    c01z = d0 * d1 - axy * axy
    c02x = axy * d2 - ayz * axz
    c02y = axz * axz - d0 * d2
    c02z = d0 * ayz - axy * axz
    c12x = d1 * d2 - ayz * ayz
    c12y = ayz * axz - axy * d2
    c12z = axy * ayz - d1 * axz
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use02 = n02 > n01
    bx = jnp.where(use02, c02x, c01x)
    by = jnp.where(use02, c02y, c01y)
    bz = jnp.where(use02, c02z, c01z)
    bn = jnp.where(use02, n02, n01)
    use12 = n12 > bn
    bx = jnp.where(use12, c12x, bx)
    by = jnp.where(use12, c12y, by)
    bz = jnp.where(use12, c12z, bz)
    bn = jnp.where(use12, n12, bn)
    inv = jax.lax.rsqrt(jnp.maximum(bn, 1e-30))
    return lam_lo, lam_mid, bx * inv, by * inv, bz * inv


@functools.partial(jax.jit, static_argnames=("sensor", "max_planar",
                                             "stride", "window"))
def extract_planar_points(image: jnp.ndarray, counter: jnp.ndarray,
                          saliency: jnp.ndarray,
                          sensor: SensorConfig = SensorConfig(),
                          max_planar: int = 4096,
                          planar_threshold: float = 0.4,
                          stride: int = 4,
                          window: int = 5):
    """Return ``(P, 6)`` rows of (x, y, z, nx, ny, nz) + mask.

    Args:
      image: ``(ImgH, ImgW, 5)`` ring image.
      counter: occupancy counter.
      saliency: ``(n_lines, model_w)`` NMS min-diff map (planar = LOW
        saliency, the complement of keypoints).
      stride: subsample the pixel grid to bound the candidate count.
    """
    H, W = saliency.shape
    rad = window // 2
    occ = (counter[:H, :W] > 0).astype(jnp.float32)
    px = image[:H, :W, 0] * occ
    py = image[:H, :W, 1] * occ
    pz = image[:H, :W, 2] * occ

    pad2 = lambda a: jnp.pad(a, ((rad, rad), (rad, rad)))
    pxp, pyp, pzp, op = pad2(px), pad2(py), pad2(pz), pad2(occ)

    # window sums of p, upper-triangle of p p^T, and count — all scalar
    # (H, W) planes via shifted slices
    sx = jnp.zeros((H, W))
    sy = jnp.zeros((H, W))
    sz = jnp.zeros((H, W))
    sxx = jnp.zeros((H, W))
    sxy = jnp.zeros((H, W))
    sxz = jnp.zeros((H, W))
    syy = jnp.zeros((H, W))
    syz = jnp.zeros((H, W))
    szz = jnp.zeros((H, W))
    cnt = jnp.zeros((H, W))
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            sl = lambda a: jax.lax.dynamic_slice(
                a, (rad + dy, rad + dx), (H, W))
            x, y, z, o = sl(pxp), sl(pyp), sl(pzp), sl(op)
            sx += x
            sy += y
            sz += z
            sxx += x * x
            sxy += x * y
            sxz += x * z
            syy += y * y
            syz += y * z
            szz += z * z
            cnt += o
    n = jnp.maximum(cnt, 1.0)
    mx, my, mz = sx / n, sy / n, sz / n
    axx = sxx / n - mx * mx
    axy = sxy / n - mx * my
    axz = sxz / n - mx * mz
    ayy = syy / n - my * my
    ayz = syz / n - my * mz
    azz = szz / n - mz * mz

    lam0, lam1, nx, ny, nz = _smallest_eigvec_sym3x3(
        axx, axy, axz, ayy, ayz, azz)
    # orient normals toward the sensor (origin)
    flip = (nx * px + ny * py + nz * pz) > 0
    nx = jnp.where(flip, -nx, nx)
    ny = jnp.where(flip, -ny, ny)
    nz = jnp.where(flip, -nz, nz)

    # planarity: smallest eigval much smaller than the window spread
    lam0c = jnp.maximum(lam0, 0.0)
    lam1c = jnp.maximum(lam1, 1e-12)
    planar = (
        (occ > 0)
        & (cnt >= 8)
        & (lam0c < 0.01)
        & (lam0c / lam1c < 0.1)
        & (saliency < planar_threshold)
    )
    # stride subsample for a bounded candidate set
    rows = jnp.arange(H)[:, None]
    cols = jnp.arange(W)[None, :]
    planar = planar & (rows % stride == 0) & (cols % stride == 0)

    score = jnp.where(planar.reshape(-1), -lam0c.reshape(-1), -jnp.inf)
    vals, idx = jax.lax.top_k(score, max_planar)
    mask = jnp.isfinite(vals)
    # only here do (P, 6) rows exist — P is small and gathered per plane
    out = jnp.stack([
        px.reshape(-1)[idx], py.reshape(-1)[idx], pz.reshape(-1)[idx],
        nx.reshape(-1)[idx], ny.reshape(-1)[idx], nz.reshape(-1)[idx],
    ], axis=1)
    return jnp.where(mask[:, None], out, 0.0), mask
