"""Voxelization and patch extraction vs numpy oracles."""
import numpy as np
import jax.numpy as jnp

from caelo_tpu.config import VoxelConfig
from caelo_tpu.voxel.grid import extract_patches, keypoint_voxels, voxelize


CFG = VoxelConfig(max_voxels=(8192, 8192, 4096), patch_knn=256)


def _random_pts(rng, n=2000):
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-90, 90, n)
    pts[:, 1] = rng.uniform(-90, 90, n)
    pts[:, 2] = rng.uniform(-10, 10, n)
    return pts


def test_voxelize_matches_numpy_unique(rng):
    pts = _random_pts(rng)
    mask = np.ones(pts.shape[0], bool)
    mask[-100:] = False
    pyr = voxelize(jnp.asarray(pts), jnp.asarray(mask), CFG)
    half = np.array(
        [CFG.visible_length, CFG.visible_width, CFG.visible_height], np.float32
    )
    for s, vs in enumerate(CFG.voxel_sizes):
        # float32 binning to match device arithmetic exactly
        ref = np.unique(
            np.floor((pts[mask] + half) / np.float32(vs)).astype(np.int32),
            axis=0,
        )
        assert int(pyr.counts[s]) == ref.shape[0]
        got = np.asarray(pyr.coords[s])[np.asarray(pyr.masks[s])]
        # same unique set; the device list is in (supercell, local) order
        # (the patch stage's grouping), not np.unique's lexicographic order
        got_lex = got[np.lexsort(got.T[::-1])]
        np.testing.assert_array_equal(got_lex, ref)
        # and the advertised supercell ordering actually holds
        P = CFG.patch_size
        g = CFG.grid_shape(s)
        sgy, sgz = -(-g[1] // P), -(-g[2] // P)
        sc = got >> 4
        lin = sc[:, 0] * (sgy * sgz) + sc[:, 1] * sgz + sc[:, 2]
        assert np.all(np.diff(lin) >= 0)


def test_voxelize_filters_out_of_bounds(rng):
    pts = np.array([[150.0, 0, 0], [0, 0, 50.0], [5.0, 5.0, 1.0]], np.float32)
    pyr = voxelize(jnp.asarray(pts), jnp.ones(3, bool), CFG)
    assert int(pyr.counts[0]) == 1  # only the in-bounds point


def test_patches_match_bruteforce(rng):
    """Patch occupancy == brute-force box query (sparse neighborhoods)."""
    # cluster points around a few keypoints so each 16^3 box holds < knn voxels
    keypts = np.array(
        [[5.0, 3.0, 1.0], [-20.0, 14.0, -2.0], [33.0, -8.0, 0.5]], np.float32
    )
    pts = []
    for k in keypts:
        pts.append(k + rng.uniform(-2.0, 2.0, size=(300, 3)).astype(np.float32))
    pts = np.concatenate(pts, 0)
    mask = np.ones(pts.shape[0], bool)
    pyr = voxelize(jnp.asarray(pts), jnp.asarray(mask), CFG)
    kmask = jnp.ones(len(keypts), bool)
    patches = extract_patches(jnp.asarray(keypts), kmask, pyr, CFG)

    half = np.array(
        [CFG.visible_length, CFG.visible_width, CFG.visible_height], np.float32
    )
    R = CFG.patch_radius
    for s, vs in enumerate(CFG.voxel_sizes):
        vox = np.unique(np.floor((pts + half) / vs).astype(np.int32), axis=0)
        kv = np.floor((keypts + half) / vs).astype(np.int32)
        for i in range(len(keypts)):
            ref = np.zeros((16, 16, 16), np.float32)
            off = vox - kv[i]
            inb = np.all((off >= -R) & (off < R), axis=1)
            sel = off[inb] + R
            n_in_box = inb.sum()
            got = np.asarray(patches[s][i])
            if n_in_box <= CFG.patch_knn:
                ref[sel[:, 0], sel[:, 1], sel[:, 2]] = 1.0
                np.testing.assert_array_equal(got, ref)
            else:
                # capacity-limited: everything set must be a real voxel
                ref[sel[:, 0], sel[:, 1], sel[:, 2]] = 1.0
                assert np.all(ref[got > 0] == 1.0)


def test_patches_masked_keypoint_empty(rng):
    pts = _random_pts(rng, 500)
    pyr = voxelize(jnp.asarray(pts), jnp.ones(500, bool), CFG)
    keypts = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], jnp.float32)
    kmask = jnp.asarray([False, True])
    patches = extract_patches(keypts, kmask, pyr, CFG)
    for s in range(3):
        assert float(jnp.sum(patches[s][0])) == 0.0


def test_keypoint_voxels_truncation():
    cfg = CFG
    kp = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    kv = np.asarray(keypoint_voxels(kp, 0, cfg))
    # (0,0,0) + (100,100,15) = (100,100,15) / 0.02 = (5000,5000,750)
    np.testing.assert_array_equal(kv[0], [5000, 5000, 750])


def test_bitgrid_scatter_indices_sorted(rng):
    """The bit-table build declares ``indices_are_sorted=True`` under a
    presorted pyramid (ADVICE r4): XLA treats a violation as undefined
    behavior on its sorted-scatter path, so pin the invariant against
    REAL ``voxelize()`` output — padded rows, slot-overflow rows and all."""
    from caelo_tpu.voxel.grid import bitgrid_scatter_plan

    cfg = CFG
    assert cfg.presorted_pyramid
    pts = _random_pts(rng, 6000)
    mask = np.ones(6000, bool)
    mask[5500:] = False          # padding tail
    pyr = voxelize(jnp.asarray(pts), jnp.asarray(mask), cfg)
    for scale in range(3):
        vox = pyr.coords[scale]
        vox_mask = pyr.masks[scale]
        n_occ = int(pyr.counts[scale])
        assert n_occ > 100
        for slots in (8192, n_occ // 2):   # ample + overflowing caps
            idx, bits = bitgrid_scatter_plan(vox, vox_mask, cfg, scale,
                                             slots)
            idx = np.asarray(idx)
            assert np.all(np.diff(idx) >= 0), (scale, slots)
            # padding rows land on the drop word with zero bits
            assert np.all(idx[~np.asarray(vox_mask)] == slots * 16 * 16)
            assert np.all(np.asarray(bits)[~np.asarray(vox_mask)] == 0)
