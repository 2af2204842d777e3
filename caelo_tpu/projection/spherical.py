"""Spherical-ring projection as a single jitted scatter.

Vectorized replacement for the reference's pure-Python per-point loop
(``ProjectPC2SphericalRing``, ``SphericalRing.py:72-94`` — the hot loop of
the preprocessing stage, ~120k trig-and-bin iterations per scan).  Here the
whole scan is binned with vectorized trig and three scatters.

Cell-collision rule: the reference keeps the *last-scanned* point per pixel;
we deterministically keep the *nearest-by-range* point instead (scatter-min on
range, then a winner-select scatter).  This is order-independent — required
for a parallel scatter — and physically the right occlusion rule.

Also hosts the inverse projections (``SphericalRing.py:338-357``) and the
extended-keypoint window gather (``ExtendKeyPtsInShpericalRing``,
``SphericalRing.py:294-317``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SensorConfig


@functools.partial(jax.jit, static_argnames=("cfg",))
def project_to_spherical_ring(pts: jnp.ndarray, mask: jnp.ndarray,
                              cfg: SensorConfig = SensorConfig()):
    """Project a padded scan into the (ImgH, ImgW, 5) spherical-ring image.

    Args:
      pts: ``(N, 4)`` float32 — x, y, z, reflectance; padded.
      mask: ``(N,)`` bool — validity of each point.
      cfg: sensor intrinsics (static).

    Returns:
      image: ``(ImgH, ImgW, 5)`` float32 — x, y, z, reflectance, range
        (channel layout per ``SphericalRing.py:91-92``).
      counter: ``(ImgH, ImgW)`` int32 — points per cell (``GridCounter``).
    """
    H, W = cfg.img_h, cfg.img_w
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = jnp.sqrt(x * x + y * y + z * z)
    valid = mask & (r > 0)
    rsafe = jnp.where(valid, r, 1.0)

    # per-point binning (SphericalRing.py:86-88)
    col = jnp.floor((jnp.pi - jnp.arctan2(y, x)) / cfg.azimuth_res).astype(jnp.int32)
    beta = jnp.arcsin(jnp.clip(z / rsafe, -1.0, 1.0))
    row = H - jnp.floor(beta / cfg.vertical_res + cfg.vertical_pixel_offset).astype(jnp.int32)

    col = jnp.clip(col, 0, W - 1)
    inb = valid & (row >= 0) & (row < H)
    flat = jnp.where(inb, row * W + col, H * W)  # H*W = trash slot

    # Winner election in ONE scatter-min of a packed (quantized-range,
    # point-index) key: range in the high bits at 1/64 m (1.56 cm)
    # resolution — far below the sensor noise floor — with the point index
    # breaking ties inside a bucket (lowest index wins); ranges beyond
    # 2^(30-idx_bits)/64 m (128 m for 131072-point scans — past every
    # consumer's gate) share the top bucket.  The two-pass
    # exact-min formulation this replaces (scatter-min range + gather +
    # scatter-max winner) costs two extra 131k-element scatter/gather
    # passes; r3 measured the hot stages bound by element-op COUNT.
    n = pts.shape[0]
    idx_bits = max(n - 1, 1).bit_length()
    rq = jnp.minimum((r * 64.0).astype(jnp.int32), (1 << (30 - idx_bits)) - 1)
    idx = jnp.arange(n, dtype=jnp.int32)
    big = jnp.iinfo(jnp.int32).max
    packed = jnp.where(inb, (rq << idx_bits) | idx, big)
    best = jnp.full((H * W + 1,), big, jnp.int32).at[flat].min(packed)
    win = best[: H * W]
    occupied = win != big
    winner = jnp.where(occupied, win & ((1 << idx_bits) - 1), 0)
    g = pts[winner, :4]
    # the range channel is recomputed from the winner's own x,y,z — the
    # same sqrt expression that produced ``r``, so bit-identical to it
    rw = jnp.sqrt(jnp.sum(g[:, 0:3] * g[:, 0:3], axis=1))
    image = jnp.where(occupied[:, None],
                      jnp.concatenate([g, rw[:, None]], axis=1), 0.0)
    image = image.reshape(H, W, 5)

    counter = jnp.zeros((H * W + 1,), jnp.int32).at[flat].add(
        inb.astype(jnp.int32)
    )[: H * W].reshape(H, W)
    return image, counter


@functools.partial(jax.jit, static_argnames=("cfg",))
def pixel_to_point(rows: jnp.ndarray, cols: jnp.ndarray, values: jnp.ndarray,
                   cfg: SensorConfig = SensorConfig()):
    """Inverse projection of (row, col, range) -> (x, y, z)
    (``ProjectPixel2Pt``, ``SphericalRing.py:338-345``)."""
    img_bottom = cfg.img_h - cfg.vertical_pixel_offset
    beta = (img_bottom - rows) * cfg.vertical_res
    alpha = jnp.pi - cols * cfg.azimuth_res
    z = values * jnp.sin(beta)
    rho = values * jnp.cos(beta)
    return jnp.stack([rho * jnp.cos(alpha), rho * jnp.sin(alpha), z], axis=-1)


def model_input(image: jnp.ndarray, cfg: SensorConfig = SensorConfig()):
    """Crop the ring image to the respond-net input window: rows [0, n_lines),
    cols [0, img_w - crop), channels x,y,z (``SphericalRing.py:405``)."""
    return image[: cfg.n_lines, : cfg.model_w, 0:3]


@functools.partial(jax.jit, static_argnames=("cfg", "radius"))
def extend_keypoints(image: jnp.ndarray, counter: jnp.ndarray,
                     key_pixels: jnp.ndarray, key_mask: jnp.ndarray,
                     cfg: SensorConfig = SensorConfig(), radius: int = 6):
    """Gather all occupied pixels in a (2r+1)^2 window around each key pixel.

    Fixed-shape version of ``ExtendKeyPtsInShpericalRing``
    (``SphericalRing.py:294-317``): returns ``(K, (2r+1)^2, 3)`` neighbor
    points plus a validity mask instead of a ragged concatenation.  Note the
    reference zeroes each window's counter after visiting it
    (``SphericalRing.py:307``) so pixels shared by overlapping windows are
    collected only once; we reproduce that dedup by electing, for every
    occupied pixel, the single *first* keypoint window that covers it.

    Returns:
      nbr_pts: ``(K, W2, 3)`` window points.
      nbr_mask: ``(K, W2)`` validity (occupied, in-image, deduped).
    """
    H, W = cfg.img_h, cfg.img_w
    K = key_pixels.shape[0]
    w = 2 * radius + 1
    dr = jnp.arange(-radius, radius + 1)
    offs = jnp.stack(jnp.meshgrid(dr, dr, indexing="ij"), axis=-1).reshape(-1, 2)
    rows = key_pixels[:, None, 0] + offs[None, :, 0]          # (K, W2)
    cols = key_pixels[:, None, 1] + offs[None, :, 1]
    inb = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    rc = jnp.where(inb, rows, 0)
    cc = jnp.where(inb, cols, 0)
    occ = (counter[rc, cc] > 0) & inb & key_mask[:, None]
    # dedup across overlapping windows: pixel belongs to the lowest keypoint
    # index whose window covers it (mirrors the reference's visit order).
    flat = jnp.where(occ, rc * W + cc, H * W)
    owner = jnp.full((H * W + 1,), K, jnp.int32).at[flat.reshape(-1)].min(
        jnp.repeat(jnp.arange(K, dtype=jnp.int32), w * w)
    )
    mine = occ & (owner[flat] == jnp.arange(K, dtype=jnp.int32)[:, None])
    nbr_pts = image[rc, cc, 0:3]
    return jnp.where(mine[..., None], nbr_pts, 0.0), mine
