"""Fixed-shape masking / compaction primitives.

Ragged data (variable point counts, variable inlier sets, variable occupied
voxel counts) is the central obstacle to a compiled LiDAR pipeline: XLA
wants static shapes.  The reference handles raggedness with Python lists and
boolean indexing; here every ragged quantity becomes a fixed-size buffer plus
a validity mask, and these helpers implement the common moves (pad, compact,
dedup) as jittable scatters/sorts.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pad_points(pts: np.ndarray, size: int, fill: float = 0.0):
    """Host-side: pad/truncate an ``(N, C)`` array to ``(size, C)`` and return
    the validity mask.  Used at the data-loading boundary only."""
    n = min(pts.shape[0], size)
    out = np.full((size, pts.shape[1]), fill, dtype=np.float32)
    out[:n] = pts[:n]
    mask = np.zeros((size,), dtype=bool)
    mask[:n] = True
    return out, mask


def compact(data: jnp.ndarray, mask: jnp.ndarray, size: int, fill=0):
    """Stable-compact masked rows to the front of a fixed-size buffer.

    Jittable replacement for ``data[mask][:size]``: computes each valid row's
    output rank with a cumulative sum and scatters.  Rows beyond ``size`` are
    dropped; unfilled rows get ``fill`` and a False mask.

    Returns ``(out, out_mask, count)`` where ``count`` is the (traced) number
    of valid inputs (possibly > ``size``).
    """
    mask = mask.astype(jnp.int32)
    ranks = jnp.cumsum(mask) - 1
    dest = jnp.where((mask > 0) & (ranks < size), ranks, size)  # size = trash
    out_shape = (size + 1,) + data.shape[1:]
    out = jnp.full(out_shape, fill, dtype=data.dtype).at[dest].set(data)
    out_mask = jnp.zeros((size + 1,), bool).at[dest].set(mask > 0)
    count = jnp.sum(mask)
    return out[:size], out_mask[:size], count


def dedup_int_rows(rows: jnp.ndarray, mask: jnp.ndarray, size: int,
                   n_keys: int | None = None):
    """Deduplicate integer rows (e.g. voxel coordinates) into a fixed-size
    buffer, jittably.

    Sorts rows lexicographically with ``lax.sort(num_keys=...)`` (invalid rows
    are pushed to the end with a +inf-like key), flags first occurrences, and
    compacts.  This replaces the reference's Python-dict voxel dedup
    (``Voxel.py:126-158``) with two sorts + a scatter — all fixed-shape.

    Args:
      rows: ``(N, K)`` int32 array, nonnegative entries for valid rows.
      mask: ``(N,)`` bool validity.
      size: static output capacity.

    Returns ``(out_rows, out_mask, count)``; ``count`` = number of unique
    valid rows (may exceed ``size``; excess is dropped).
    """
    N, K = rows.shape
    n_keys = K if n_keys is None else n_keys
    big = jnp.iinfo(jnp.int32).max
    keyed = jnp.where(mask[:, None], rows, big)
    cols = [keyed[:, i] for i in range(K)]
    sorted_cols = jax.lax.sort(cols, num_keys=n_keys)
    srows = jnp.stack(sorted_cols, axis=1)
    first = jnp.ones((N,), bool).at[1:].set(
        jnp.any(srows[1:] != srows[:-1], axis=1)
    )
    valid = first & (srows[:, 0] < big)
    return compact(srows, valid, size, fill=0)
