"""Three-scale sparse voxelization and patch extraction in fixed shapes.

Replaces the reference's Python-dict block voxelizer (``Voxelization``,
``Voxel.py:100-173``) and its sklearn-KNN patch extractor (``GetPatchesList``,
``Voxel.py:177-216``) with fixed-shape JAX:

* **Voxelize**: vectorized coordinate binning + lexicographic-sort dedup
  (``ops.masking.dedup_int_rows``) per scale -> padded occupied-voxel lists.
  This is the exact information content of the reference's sparse artifacts
  (``AllVoxels0/1/2``); the CSR block structure (``avlBlocksList`` /
  ``cntVoxelsLength``) is recoverable via ``caelo_tpu.voxel.blocks``.
* **Patches**: for each keypoint and scale, the 512 nearest occupied voxels
  (in voxel-index space) are found with a distance *matmul* plus
  ``lax.approx_max_k`` — the fixed-shape analog of the reference's KD-tree
  496-NN (``Voxel.py:182-196``) — then box-filtered to the 16^3 window and
  scattered into the patch tensor.  No trees, no host round-trips.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import VoxelConfig
from ..ops.masking import compact


class VoxelPyramid(NamedTuple):
    """Per-scale padded occupied-voxel lists (coords in voxel-index space)."""

    coords: tuple       # per scale: (M_s, 3) int32
    masks: tuple        # per scale: (M_s,) bool
    counts: tuple       # per scale: () int32 — number of unique voxels


def _supercell_key(c: jnp.ndarray, ok: jnp.ndarray, cfg: VoxelConfig,
                   scale: int):
    """(supercell linear id, packed 4-bit local coords) for each voxel —
    the sort key that makes ONE sort serve both the dedup and the patch
    stage's supercell grouping.  Returns ``(lin, local, packable)`` where
    ``packable`` says the pair fits one int32 (``lin*P^3 + local``)."""
    P = cfg.patch_size
    pbits = P.bit_length() - 1
    pmask = P - 1
    g = cfg.grid_shape(scale)
    sgy = -(-g[1] // P)
    sgz = -(-g[2] // P)
    sgx = -(-g[0] // P)
    sc = c >> pbits
    lin = sc[:, 0] * (sgy * sgz) + sc[:, 1] * sgz + sc[:, 2]
    local = (((c[:, 0] & pmask) << (2 * pbits))
             | ((c[:, 1] & pmask) << pbits)
             | (c[:, 2] & pmask))
    big = jnp.iinfo(jnp.int32).max
    lin = jnp.where(ok, lin, big)
    local = jnp.where(ok, local, big)
    lbits = 3 * pbits
    packable = (sgx * sgy * sgz) < (1 << (31 - lbits))
    return lin, local, packable, lbits


@functools.partial(jax.jit, static_argnames=("cfg",))
def voxelize(pts: jnp.ndarray, mask: jnp.ndarray,
             cfg: VoxelConfig = VoxelConfig()) -> VoxelPyramid:
    """Build the 3-scale occupied-voxel pyramid from a padded scan.

    Args:
      pts: ``(N, 3)`` or ``(N, >=3)`` float32 points.
      mask: ``(N,)`` bool validity.

    Scene bounds and scales follow ``Voxel.py:14-52`` (+-100 x +-100 x +-15 m,
    voxel 0.02 m, ratios 1/8/32); out-of-bounds points are dropped
    (``FilterOutTooFarPts``, ``Voxel.py:89-97``).

    The occupied lists come back sorted by (16-aligned supercell id, packed
    local coords) rather than lexicographically: the same unique set, in the
    order the patch-gather stage needs — so its per-scale sort disappears
    (``cfg.presorted_pyramid``), and the dedup sort is a single packed int32
    key at coarse scales instead of a 3-column row sort.
    """
    p = pts[:, :3]
    half = jnp.array(
        [cfg.visible_length, cfg.visible_width, cfg.visible_height], jnp.float32
    )
    inb = mask & jnp.all(jnp.abs(p) <= half, axis=1)
    shifted = p + half

    coords, masks, counts = [], [], []
    big = jnp.iinfo(jnp.int32).max
    P = cfg.patch_size
    pbits = P.bit_length() - 1
    pmask = P - 1
    for s, vs in enumerate(cfg.voxel_sizes):
        c = jnp.floor(shifted / vs).astype(jnp.int32)
        g = jnp.array(cfg.grid_shape(s), jnp.int32)
        ok = inb & jnp.all((c >= 0) & (c < g), axis=1)
        c = jnp.where(ok[:, None], c, 0)
        gs = cfg.grid_shape(s)
        sgy = -(-gs[1] // P)
        sgz = -(-gs[2] // P)
        lin, local, packable, lbits = _supercell_key(c, ok, cfg, s)
        # sort + dedup + compact operate on packed KEYS only (1-2 int32
        # lanes per voxel), never on (N, 3) coordinate rows: row sorts and
        # row scatters move 3-5 columns and dominate voxelize runtime;
        # coords are re-derived from the compacted keys with pure vector ops
        if packable:
            key = jnp.where(ok, (lin << lbits) | local, big)
            skey = jnp.sort(key)
            first = jnp.ones_like(ok).at[1:].set(skey[1:] != skey[:-1])
            valid = first & (skey != big)
            ukey, m, n = compact(skey, valid, cfg.max_voxels[s], fill=0)
            ulin = ukey >> lbits
            ulocal = ukey & ((1 << lbits) - 1)
        else:
            k1, k2 = jax.lax.sort([lin, local], num_keys=2)
            first = jnp.ones_like(ok).at[1:].set(
                (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1]))
            valid = first & (k1 != big)
            upair, m, n = compact(
                jnp.stack([k1, k2], axis=1), valid, cfg.max_voxels[s], fill=0)
            ulin, ulocal = upair[:, 0], upair[:, 1]
        scx = ulin // (sgy * sgz)
        scy = (ulin // sgz) % sgy
        scz = ulin % sgz
        u = jnp.stack([
            (scx << pbits) | ((ulocal >> (2 * pbits)) & pmask),
            (scy << pbits) | ((ulocal >> pbits) & pmask),
            (scz << pbits) | (ulocal & pmask),
        ], axis=1)
        u = jnp.where(m[:, None], u, 0)
        coords.append(u)
        masks.append(m)
        counts.append(n)
    return VoxelPyramid(tuple(coords), tuple(masks), tuple(counts))


def keypoint_voxels(key_pts: jnp.ndarray, scale: int,
                    cfg: VoxelConfig = VoxelConfig()) -> jnp.ndarray:
    """Keypoint coordinates in scale-s voxel-index space
    (``Voxel.py:193``: ``int(Pts_/VoxelSizes[iScale])``)."""
    half = jnp.array(
        [cfg.visible_length, cfg.visible_width, cfg.visible_height], jnp.float32
    )
    return jnp.floor((key_pts + half) / cfg.voxel_sizes[scale]).astype(jnp.int32)


def _patches_one_scale(key_vox, key_mask, vox, vox_mask, cfg: VoxelConfig,
                       chunk: int = 128):
    """16^3 occupancy patches for one scale.

    key_vox: (K, 3) int32; vox: (M, 3) int32 occupied voxels (padded).
    Returns (K, P, P, P) float32.
    """
    K = key_vox.shape[0]
    P = cfg.patch_size
    R = cfg.patch_radius
    knn = min(cfg.patch_knn, vox.shape[0])

    v = vox.astype(jnp.float32)
    v2 = jnp.sum(v * v, axis=1)
    # push padded voxels far away so they never make the top-k
    v2 = jnp.where(vox_mask, v2, 1e12)

    def one_chunk(kc):
        kcf = kc.astype(jnp.float32)                       # (chunk, 3)
        k2 = jnp.sum(kcf * kcf, axis=1)                    # (chunk,)
        # -||v - k||^2 = 2 k.v - ||v||^2 - ||k||^2  (MXU matmul)
        score = (
            2.0 * jnp.dot(kcf, v.T, preferred_element_type=jnp.float32)
            - v2[None, :]
            - k2[:, None]
        )
        _, idx = jax.lax.approx_max_k(score, k=knn)        # (chunk, knn)
        return idx

    n_chunks = -(-K // chunk)
    kpad = jnp.pad(key_vox, ((0, n_chunks * chunk - K), (0, 0)))
    idx = jax.lax.map(one_chunk, kpad.reshape(n_chunks, chunk, 3))
    idx = idx.reshape(n_chunks * chunk, knn)[:K]           # (K, knn)

    nbr = vox[idx]                                          # (K, knn, 3)
    nbr_ok = vox_mask[idx]
    off = nbr - key_vox[:, None, :]
    in_box = jnp.all((off >= -R) & (off < R), axis=-1) & nbr_ok & key_mask[:, None]
    cell = (off[..., 0] + R) * P * P + (off[..., 1] + R) * P + (off[..., 2] + R)
    flat = jnp.where(
        in_box,
        jnp.arange(K, dtype=jnp.int32)[:, None] * (P * P * P) + cell,
        K * P * P * P,
    )
    occ = jnp.zeros((K * P * P * P + 1,), jnp.float32).at[flat.reshape(-1)].max(
        in_box.reshape(-1).astype(jnp.float32)
    )
    return occ[:-1].reshape(K, P, P, P)


def _patches_one_scale_window(kv, key_mask, vox, vox_mask,
                              cfg: VoxelConfig, scale: int):
    """16^3 occupancy patches via supercell range queries (no KNN).

    Voxels are sorted by the id of their 16-voxel-aligned *supercell*; a
    keypoint's patch window [kv-8, kv+8) overlaps at most 2x2x2 supercells,
    so the candidate set is 8 contiguous runs of the sorted array found with
    vectorized binary search.  This replaces the distance-matmul +
    ``approx_max_k`` KNN (the reference's sklearn 496-NN, ``Voxel.py:
    182-196``) with a sort + gather + scatter — and is *more* faithful: no
    nearest-k truncation, only a generous per-supercell cap.

    Keypoints are processed in ``cfg.patch_query_chunk`` chunks under
    ``lax.map`` so the candidate gather temp stays bounded — unchunked it is
    ``(K, 8, C)`` int32 per frame, which under a 64-frame window vmap is a
    multi-GB temp per scale.

    Layout choices:
    * candidates are gathered as ONE packed int32 per voxel (4-bit local
      coords within the 16-aligned supercell) instead of a ``(M, 3)`` row
      gather;
    * every non-dropped scatter index is unique by construction (distinct
      voxels -> distinct cells; dropped candidates get *distinct*
      out-of-range ids), so the scatter runs with ``unique_indices=True``;
    * ``cfg.supercell_caps`` sized from measured per-supercell occupancy
      (max 64/195/439 on KITTI-like scans) — cost is linear in the cap.
    """
    K = kv.shape[0]
    P = cfg.patch_size
    R = cfg.patch_radius
    M = vox.shape[0]
    C = min(cfg.supercell_caps[scale], M)
    g = cfg.grid_shape(scale)
    sgy = -(-g[1] // P)
    sgz = -(-g[2] // P)
    sgx = -(-g[0] // P)
    pbits = P.bit_length() - 1                        # log2(P); P power of 2

    sc = vox >> pbits                                 # (M, 3) supercell coords
    lin = sc[:, 0] * (sgy * sgz) + sc[:, 1] * sgz + sc[:, 2]
    lin = jnp.where(vox_mask, lin, jnp.iinfo(jnp.int32).max)
    # packed 4-bit local coords: one int32 gather per candidate
    pmask = P - 1
    local = (((vox[:, 0] & pmask) << (2 * pbits))
             | ((vox[:, 1] & pmask) << pbits)
             | (vox[:, 2] & pmask))                   # (M,) int32
    if cfg.presorted_pyramid:
        # voxelize() already emitted the list in (supercell, local) order
        # with padding at the end (masked rows -> lin = int32 max above)
        lin_sorted, local_sorted = lin, local
    else:
        order = jnp.argsort(lin)
        lin_sorted = lin[order]
        local_sorted = local[order]
    sg = jnp.array([sgx, sgy, sgz], jnp.int32)
    dx = jnp.arange(2, dtype=jnp.int32)

    def chunk(args):
        kvc, kmc = args                               # (k, 3), (k,)
        k = kvc.shape[0]
        # the window's up-to-8 covering supercells
        base = (kvc - R) >> pbits                     # (k, 3), may be negative
        nb = (base[:, None, None, None, :]
              + jnp.stack(jnp.meshgrid(dx, dx, dx, indexing="ij"),
                          axis=-1)[None])             # (k, 2, 2, 2, 3)
        nb = nb.reshape(k, 8, 3)
        ok_nb = jnp.all((nb >= 0) & (nb < sg), axis=-1)   # (k, 8)
        qlin = nb[..., 0] * (sgy * sgz) + nb[..., 1] * sgz + nb[..., 2]
        qlin = jnp.where(ok_nb, qlin, -1)

        left = jnp.searchsorted(lin_sorted, qlin, side="left")
        right = jnp.searchsorted(lin_sorted, qlin, side="right")
        cnt = right - left                            # (k, 8)

        take = left[..., None] + jnp.arange(C, dtype=jnp.int32)  # (k, 8, C)
        valid = jnp.arange(C, dtype=jnp.int32)[None, None, :] < cnt[..., None]
        loc = local_sorted[jnp.clip(take, 0, M - 1)]  # (k, 8, C) int32

        # absolute voxel = supercell * P + local;  offsets per axis
        anchor = (nb << pbits) - kvc[:, None, :]      # (k, 8, 3)
        off_x = anchor[..., 0:1] + ((loc >> (2 * pbits)) & pmask)
        off_y = anchor[..., 1:2] + ((loc >> pbits) & pmask)
        off_z = anchor[..., 2:3] + (loc & pmask)
        in_box = ((off_x >= -R) & (off_x < R)
                  & (off_y >= -R) & (off_y < R)
                  & (off_z >= -R) & (off_z < R)
                  & valid & kmc[:, None, None])
        cell = ((off_x + R) * (P * P) + (off_y + R) * P + (off_z + R))
        # unique indices: in-box candidates map to distinct cells (voxels
        # are deduped); dropped ones get distinct out-of-range ids
        drop_ids = (k * P * P * P
                    + jnp.arange(k * 8 * C, dtype=jnp.int32).reshape(k, 8, C))
        flat = jnp.where(
            in_box,
            jnp.arange(k, dtype=jnp.int32)[:, None, None] * (P * P * P) + cell,
            drop_ids,
        )
        occ = jnp.zeros((k * P * P * P,), jnp.float32).at[
            flat.reshape(-1)
        ].set(1.0, mode="drop", unique_indices=True)
        return occ.reshape(k, P, P, P)

    kc = cfg.patch_query_chunk
    if kc and kc < K and K % kc == 0:
        occ = jax.lax.map(
            chunk, (kv.reshape(-1, kc, 3), key_mask.reshape(-1, kc))
        )
        return occ.reshape(K, P, P, P)
    return chunk((kv, key_mask))


def bitgrid_scatter_plan(vox, vox_mask, cfg: VoxelConfig, scale: int,
                         slots: int):
    """Per-voxel scatter plan for the presorted bit-table build:
    ``(idx, bits)`` where ``idx`` is the word index clamped to the drop
    word ``slots*P*P`` and ``bits`` the z-bit contribution.

    Exposed as a module function so the load-bearing
    ``indices_are_sorted=True`` invariant of the build scatter — ``idx``
    globally NONDECREASING under a ``voxelize()`` presorted pyramid,
    including padding and slot-overflow rows — is directly testable
    (XLA treats a violation as undefined behavior on its sorted-scatter
    path; see ``tests/test_voxel.py``)."""
    P = cfg.patch_size
    pbits = P.bit_length() - 1
    pmask = P - 1
    g = cfg.grid_shape(scale)
    sgy = -(-g[1] // P)
    sgz = -(-g[2] // P)
    sc = vox >> pbits
    lin = sc[:, 0] * (sgy * sgz) + sc[:, 1] * sgz + sc[:, 2]
    big = jnp.iinfo(jnp.int32).max
    lin = jnp.where(vox_mask, lin, big)
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), lin[1:] != lin[:-1]])
    is_first &= lin != big
    slot_of_sorted = jnp.cumsum(is_first.astype(jnp.int32)) - 1
    vslot = jnp.where(vox_mask & (slot_of_sorted < slots),
                      slot_of_sorted, slots)
    word_idx = (vslot * (P * P) + (vox[:, 0] & pmask) * P
                + (vox[:, 1] & pmask))
    bits = jnp.where(vox_mask, jnp.int32(1) << (vox[:, 2] & pmask), 0)
    idx = jnp.where(word_idx < slots * P * P, word_idx, slots * P * P)
    return idx, bits


def _patches_one_scale_bitgrid(kv, key_mask, vox, vox_mask,
                               cfg: VoxelConfig, scale: int, slots: int):
    """16^3 occupancy patches via dense bit-packed per-supercell tables.

    For coarse scales the number of occupied 16-aligned supercells is tiny
    (measured ~2.4k at scale 1, ~80 at scale 2 on KITTI-like scans), so a
    dense occupancy table is cheap: one int32 word per (supercell, x, y)
    column holding the 16 z-bits.  Build = M scatter-adds of ``1 << lz``
    (bits are unique per deduped voxel, so add == or).  Query = per patch
    column, gather the 2 straddled words and shift-combine — 512 word
    gathers per keypoint instead of ~4k per-candidate gathers (the
    windowed-gather path, ``_patches_one_scale_window``).

    ``slots`` is the static supercell-slot capacity; supercells beyond it
    are dropped (sized ~2x measured occupancy).
    """
    K = kv.shape[0]
    P = cfg.patch_size
    R = cfg.patch_radius
    M = vox.shape[0]
    g = cfg.grid_shape(scale)
    sgy = -(-g[1] // P)
    sgz = -(-g[2] // P)
    sgx = -(-g[0] // P)
    pbits = P.bit_length() - 1
    pmask = P - 1
    # P <= 16, not 32: at P=32 `1 << 31` sets the int32 sign bit (the >>
    # becomes an arithmetic shift), and `(1 << P) - 1` / `wB << (P - shift)`
    # overflow int32.  Matches the 4-bit packed-local-coord assumption in
    # _patches_one_scale_window.
    assert P <= 16, "z-bits must fit the low half of one int32 word"

    sc = vox >> pbits
    lin = sc[:, 0] * (sgy * sgz) + sc[:, 1] * sgz + sc[:, 2]
    big = jnp.iinfo(jnp.int32).max
    lin = jnp.where(vox_mask, lin, big)
    # voxelize() emits supercell order (cfg.presorted_pyramid); the slot
    # assignment below only needs lin grouped-and-ascending
    lin_sorted = lin if cfg.presorted_pyramid else jnp.sort(lin)
    n_ids = sgx * sgy * sgz
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), lin_sorted[1:] != lin_sorted[:-1]])
    is_first &= lin_sorted != big
    slot_of_sorted = jnp.cumsum(is_first.astype(jnp.int32)) - 1   # (M,)
    # supercell-id -> slot lookup for the (few) query supercells: a dense
    # map when the supercell grid is small (scales 1-2: ~75k ids); at scale
    # 0 the dense map would be 36M ids = 143 MB/frame, so instead keep the
    # sorted unique-id array and binary-search it — only 8 queries per
    # keypoint with the plane-gather query below (the per-COLUMN
    # searchsorted that sank the first bitgrid attempt was 512/keypoint)
    dense_map = n_ids <= (1 << 22)
    if dense_map:
        drop = n_ids + jnp.arange(M, dtype=jnp.int32)  # distinct OOB ids
        slotmap = jnp.full((n_ids,), -1, jnp.int32).at[
            jnp.where(is_first & (slot_of_sorted < slots), lin_sorted, drop)
        ].set(jnp.where(is_first, slot_of_sorted, 0), mode="drop",
              unique_indices=True)

        def lookup(qid, ok):
            s = slotmap[jnp.clip(jnp.where(ok, qid, 0), 0, n_ids - 1)]
            return jnp.where(ok & (s >= 0), s, slots)
    else:
        # Bitmap popcount-rank lookup (scale 0, where a dense id map would
        # be 143 MB/frame): occupied ids set bits in a dense bitmap
        # (n_ids/8 bytes = 4.6 MB at scale 0) and slot(qid) = rank of qid
        # among occupied ids = prefix popcount up to qid.  Per query: ONE
        # contiguous 16-word row gather + ONE block-prefix gather + VPU
        # popcounts — versus the 17 dependent gathers of the searchsorted
        # binary search this replaces.
        WPB = 16                       # words per rank block (512 ids)
        n_words = -(-n_ids // 32)
        n_blocks = -(-n_words // WPB)
        occ_first = is_first & (slot_of_sorted < slots)
        wi = jnp.where(occ_first, lin_sorted >> 5, n_blocks * WPB)
        bit = jnp.where(occ_first, lin_sorted & 31, 0)
        bitmap = jnp.zeros((n_blocks * WPB + 1,), jnp.int32).at[wi].add(
            jnp.where(occ_first, jnp.int32(1) << bit, 0),
            mode="drop",
            # ids unique & ascending => word indices nondecreasing
            indices_are_sorted=bool(cfg.presorted_pyramid))
        words = bitmap[:n_blocks * WPB].reshape(n_blocks, WPB)
        pc = jnp.sum(jax.lax.population_count(words), axis=1)
        prefix = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(pc, dtype=jnp.int32)[:-1]])

        def lookup(qid, ok):
            q = jnp.where(ok, qid, 0)
            w = q >> 5
            b = w // WPB
            widx = w % WPB
            qbit = q & 31
            row = words[b]                       # (..., WPB) contiguous
            below = jnp.arange(WPB, dtype=jnp.int32) < widx[..., None]
            full = jnp.sum(jnp.where(
                below, jax.lax.population_count(row), 0), axis=-1)
            word = jnp.sum(jnp.where(
                jnp.arange(WPB, dtype=jnp.int32) == widx[..., None],
                row, 0), axis=-1)
            # bits strictly below qbit: ~((-1) << qbit) is exact for
            # qbit in [0, 31] (qbit=31 -> bits 0..30)
            part = jax.lax.population_count(
                word & ~(jnp.int32(-1) << qbit))
            rank = prefix[b] + full + part
            hit = ok & (((word >> qbit) & 1) == 1)
            return jnp.where(hit & (rank < slots), rank, slots)

    # build the bit table: word = slot*P*P + lx*P + ly, bit = lz.  With a
    # presorted pyramid each voxel's slot is its run's rank directly — no
    # map gather needed, and the scatter indices are globally NONDECREASING
    # (slot is the ascending run rank; within a run the packed local order
    # makes lx*P+ly nondecreasing; padding/overflow rows sit at the end and
    # clamp to the drop id) — declared sorted so the scatter-add takes
    # XLA's sorted path instead of random-update.  The invariant is
    # load-bearing and pinned by a test on ``bitgrid_scatter_plan``.
    if cfg.presorted_pyramid:
        scatter_idx, bits = bitgrid_scatter_plan(vox, vox_mask, cfg, scale,
                                                 slots)
    else:
        vslot = lookup(lin, vox_mask)
        word_idx = (vslot * (P * P) + (vox[:, 0] & pmask) * P
                    + (vox[:, 1] & pmask))
        bits = jnp.where(vox_mask, jnp.int32(1) << (vox[:, 2] & pmask), 0)
        scatter_idx = jnp.where(word_idx < slots * P * P, word_idx,
                                slots * P * P)
    table = jnp.zeros((slots * P * P,), jnp.int32).at[
        scatter_idx
    ].add(bits, mode="drop",
          indices_are_sorted=bool(cfg.presorted_pyramid))  # bit-or via add

    # ---- query: gather the 2x2x2 covering supercells' WHOLE word planes
    # (8 contiguous 256-word row gathers per keypoint), then align with
    # shifts/slices.  The per-column formulation this replaces did 4
    # independent element gathers per (keypoint, column) = ~1M scattered
    # int32 gathers per frame.
    ox = kv - R                                       # (K, 3) window origin
    o = ox & pmask                                    # (K, 3) offset in cell A
    sA = ox >> pbits                                  # (K, 3) first supercell
    rng_ = jnp.arange(P, dtype=jnp.int32)
    dx = jnp.arange(2, dtype=jnp.int32)
    nb = (sA[:, None, None, None, :]
          + jnp.stack(jnp.meshgrid(dx, dx, dx, indexing="ij"),
                      axis=-1)[None])                 # (K, 2, 2, 2, 3)
    sgv = jnp.array([sgx, sgy, sgz], jnp.int32)
    okb = jnp.all((nb >= 0) & (nb < sgv), axis=-1) \
        & key_mask[:, None, None, None]
    nlin = nb[..., 0] * (sgy * sgz) + nb[..., 1] * sgz + nb[..., 2]
    slot = lookup(nlin, okb)                          # slots = zero plane
    table2 = jnp.concatenate(
        [table, jnp.zeros((P * P,), jnp.int32)]).reshape(slots + 1, P, P)
    planes = table2[slot]                             # (K, 2,2,2, P, P)

    # z: combine the two z-adjacent planes into 16-bit windows per column
    shift = (ox[:, 2] & pmask)[:, None, None, None, None]
    wA = planes[:, :, :, 0]                           # (K, 2, 2, P, P)
    wB = planes[:, :, :, 1]
    win = ((wA >> shift) | jnp.where(shift > 0, wB << (P - shift), 0)
           ) & ((1 << P) - 1)                         # (K, 2, 2, P, P)
    # x: concatenate the two x-supercells and slice the window's 16 rows
    winx = jnp.concatenate([win[:, 0], win[:, 1]], axis=2)  # (K, 2, 2P, P)
    zero = jnp.int32(0)
    winx = jax.vmap(
        lambda a, s: jax.lax.dynamic_slice(a, (zero, s, zero), (2, P, P))
    )(winx, o[:, 0])                                  # (K, 2, P, P)
    # y: same along the ly axis
    winy = jnp.concatenate([winx[:, 0], winx[:, 1]], axis=2)  # (K, P, 2P)
    winy = jax.vmap(
        lambda a, s: jax.lax.dynamic_slice(a, (zero, s), (P, P))
    )(winy, o[:, 1])                                  # (K, P, P)
    occ = ((winy[..., None] >> rng_[None, None, None, :]) & 1
           ).astype(jnp.float32)                      # (K, P, P, P)
    return occ


@functools.partial(jax.jit, static_argnames=("scale", "cfg"))
def decode_voxels(coords: jnp.ndarray, scale: int,
                  cfg: VoxelConfig = VoxelConfig()) -> jnp.ndarray:
    """Occupied-voxel coords (voxel-index space) -> world-space cell
    centers, ``(M, 3)`` float32.

    The explicit inverse of :func:`voxelize`'s binning — the reference
    ships four such rebuilders for visualization/debug
    (``RebuildPCFromVoxels`` / ``RebuildPCsFromVoxels*``,
    ``Voxel.py:220-469``); pair with the pyramid's mask to drop padding.
    Used by ``eval.viz.export_voxels_ply``.
    """
    origin = jnp.array(cfg.origin, jnp.float32)
    vs = jnp.float32(cfg.voxel_sizes[scale])
    return (coords.astype(jnp.float32) + 0.5) * vs + origin


@functools.partial(jax.jit, static_argnames=("scale", "cfg"))
def decode_patch(occ: jnp.ndarray, key_pt: jnp.ndarray, scale: int,
                 cfg: VoxelConfig = VoxelConfig()):
    """16^3 occupancy patch -> world-space centers of its occupied cells.

    Inverse of :func:`extract_patches` for one keypoint (the reference's
    ``RebuildPCFromVoxelLocations``-style patch debug view,
    ``Voxel.py:220-268``).  Returns ``(P^3, 3)`` centers + ``(P^3,)`` bool
    occupancy mask (fixed shape; mask selects the real points).
    """
    P = cfg.patch_size
    R = cfg.patch_radius
    kv = keypoint_voxels(key_pt[None], scale, cfg)[0]
    r = jnp.arange(P, dtype=jnp.int32) - R
    gx, gy, gz = jnp.meshgrid(r, r, r, indexing="ij")
    cells = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3) + kv
    return decode_voxels(cells, scale, cfg), occ.reshape(-1) > 0.5


@functools.partial(jax.jit, static_argnames=("cfg",))
def occupancy_stats(pyramid: VoxelPyramid, cfg: VoxelConfig = VoxelConfig()):
    """Saturation observability for the static patch-gather capacities.

    The window/bitgrid patch paths silently drop voxels beyond
    ``cfg.supercell_caps`` / supercells beyond ``cfg.bitgrid_slots`` —
    degradation that is measurable but otherwise invisible (silent
    saturation measurably hurt registration in the hard-benchmark tuning:
    RTE 0.25 m vs 0.06 m).  This returns, per scale:

    * ``n_voxels``        — unique occupied voxels (vs ``cfg.max_voxels``)
    * ``n_supercells``    — occupied 16-aligned supercells (vs
      ``cfg.bitgrid_slots`` where the bitgrid path is active)
    * ``max_supercell_occupancy`` — the densest supercell's voxel count
      (vs ``cfg.supercell_caps`` where the windowed path is active)

    One jitted call over the pyramid; wire the scalars into MetricsLog
    (bench.py / cli full do) so overflow on real data is observable.
    """
    P = cfg.patch_size
    pbits = P.bit_length() - 1
    out = {}
    for s in range(len(cfg.scale_ratios)):
        vox, msk, cnt = pyramid.coords[s], pyramid.masks[s], pyramid.counts[s]
        g = cfg.grid_shape(s)
        sgy = -(-g[1] // P)
        sgz = -(-g[2] // P)
        sc = vox >> pbits
        lin = sc[:, 0] * (sgy * sgz) + sc[:, 1] * sgz + sc[:, 2]
        lin = jnp.where(msk, lin, jnp.iinfo(jnp.int32).max)
        ls = jnp.sort(lin)
        is_first = jnp.concatenate(
            [jnp.ones((1,), bool), ls[1:] != ls[:-1]])
        real = ls != jnp.iinfo(jnp.int32).max
        is_first &= real
        n_sc = jnp.sum(is_first)
        # longest run of equal ids = max per-supercell occupancy
        pos = jnp.arange(ls.shape[0], dtype=jnp.int32)
        run_start = jnp.where(is_first, pos, -1)
        start_of_run = jax.lax.cummax(run_start)
        run_len = jnp.where(real, pos - start_of_run + 1, 0)
        out[f"scale{s}"] = {
            "n_voxels": cnt,
            "n_supercells": n_sc,
            "max_supercell_occupancy": jnp.max(run_len),
        }
    return out


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_patches(key_pts: jnp.ndarray, key_mask: jnp.ndarray,
                    pyramid: VoxelPyramid, cfg: VoxelConfig = VoxelConfig()):
    """Multi-scale 16^3 occupancy patches around each keypoint.

    Returns a tuple of three ``(K, 16, 16, 16)`` float32 tensors (scales
    0.02 / 0.16 / 0.64 m -> receptive fields 0.32 / 2.56 / 10.24 m), matching
    the reference's ``PatchesList`` (``Voxel.py:177-216``) minus the trailing
    singleton channel axis.

    ``cfg.patch_method`` selects the supercell window-query path (default;
    see ``_patches_one_scale_window``) or the legacy KNN path (``"knn"``,
    the direct analog of the reference's 496-NN + box filter).
    """
    out = []
    for s in range(len(cfg.scale_ratios)):
        kv = keypoint_voxels(key_pts, s, cfg)
        if cfg.patch_method == "window":
            if cfg.bitgrid_slots[s] > 0:
                out.append(_patches_one_scale_bitgrid(
                    kv, key_mask, pyramid.coords[s], pyramid.masks[s], cfg,
                    s, cfg.bitgrid_slots[s]
                ))
            else:
                out.append(_patches_one_scale_window(
                    kv, key_mask, pyramid.coords[s], pyramid.masks[s], cfg, s
                ))
        else:
            out.append(_patches_one_scale(
                kv, key_mask, pyramid.coords[s], pyramid.masks[s], cfg
            ))
    return tuple(out)
