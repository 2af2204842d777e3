"""Per-stage timing of the front-end pipeline on one device.

Times each stage as its own jitted program over a batch of frames; every
rep ends in ``jax.block_until_ready`` on that rep's output.  Inputs are
passed as jit arguments, never closure-captured, so no stage is timed with
its inputs folded in as constants.

Usage: python -u examples/profile_stages.py [--frames 16] [--reps 5]
"""
import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--stages", default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from caelo_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()

    from caelo_tpu.config import PipelineConfig
    from caelo_tpu.data.synthetic import (make_scene, range_filter,
                                          sample_scene_points)
    from caelo_tpu.cli import model_params
    from caelo_tpu.models.respond_net import RespondLayer
    from caelo_tpu.models.patch_encoder import PatchEncoder
    from caelo_tpu.ops.masking import pad_points
    from caelo_tpu.ops.nms import select_keypoints
    from caelo_tpu.projection.spherical import (model_input,
                                                project_to_spherical_ring)
    from caelo_tpu.voxel.grid import extract_patches, voxelize, \
        keypoint_voxels, _patches_one_scale_window, _patches_one_scale_bitgrid

    cfg = PipelineConfig(compute_dtype=args.dtype)
    B = args.frames
    respond, encoder = model_params(cfg)

    scene = make_scene(seed=0)
    world = sample_scene_points(scene, seed=0, n_points=cfg.max_points)
    rng = np.random.default_rng(0)
    pts_l, msk_l = [], []
    for i in range(B):
        t = np.array([1.2 * i, 0.05 * i, 0.0])
        local = range_filter((world - t).astype(np.float32), cfg.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        p, m = pad_points(np.concatenate([local, refl], 1), cfg.max_points)
        pts_l.append(p)
        msk_l.append(m)
    pts_b = jnp.asarray(np.stack(pts_l))
    msk_b = jnp.asarray(np.stack(msk_l))

    # ---------------- staged single-purpose programs (all vmapped over B)
    @jax.jit
    def s_project(pts, msk):
        img, cnt = jax.vmap(
            lambda p, m: project_to_spherical_ring(p, m, cfg.sensor)
        )(pts, msk)
        return img, cnt

    @jax.jit
    def s_respond(img):
        net_in = jax.vmap(lambda im: model_input(im, cfg.sensor))(img)
        return RespondLayer().apply(respond, net_in)

    @jax.jit
    def s_nms(img, cnt, resp):
        return jax.vmap(
            lambda i, c, r: select_keypoints(i, c, r, cfg.sensor, cfg.keypoint)
        )(img, cnt, resp)

    @jax.jit
    def s_voxelize(pts, msk):
        return jax.vmap(
            lambda p, m: voxelize(p[:, :3], m, cfg.voxel))(pts, msk)

    @jax.jit
    def s_patches(kp, km, pyr):
        return jax.vmap(
            lambda a, b, c: extract_patches(a, b, c, cfg.voxel))(kp, km, pyr)

    def patches_scale(s):
        @jax.jit
        def f(kp, km, pyr):
            def one(a, b, c):
                kv = keypoint_voxels(a, s, cfg.voxel)
                if cfg.voxel.bitgrid_slots[s] > 0:
                    return _patches_one_scale_bitgrid(
                        kv, b, c.coords[s], c.masks[s], cfg.voxel, s,
                        cfg.voxel.bitgrid_slots[s])
                return _patches_one_scale_window(
                    kv, b, c.coords[s], c.masks[s], cfg.voxel, s)
            return jax.vmap(one)(kp, km, pyr)
        return f

    @jax.jit
    def s_encoder(patches):
        enc = PatchEncoder()
        K = patches[0].shape[1]
        stacked = jnp.concatenate(patches, axis=1)   # (B, 3K, 16,16,16)

        def per_frame(x):
            ck = cfg.encoder_chunk
            if ck and x.shape[0] % ck == 0 and x.shape[0] > ck:
                chunks = x.reshape(-1, ck, *x.shape[1:])
                out = jax.lax.map(lambda c: enc.apply(encoder, c), chunks)
                return out.reshape(x.shape[0], -1)
            return enc.apply(encoder, x)

        codes = jax.vmap(per_frame)(stacked)
        return codes

    # precompute stage inputs (untimed)
    img, cnt = s_project(pts_b, msk_b)
    resp = s_respond(img)
    kp, kpx, km, sal = s_nms(img, cnt, resp)
    pyr = s_voxelize(pts_b, msk_b)
    patches = s_patches(kp, km, pyr)

    stages = {
        "project": (s_project, (pts_b, msk_b)),
        "respond": (s_respond, (img,)),
        "nms": (s_nms, (img, cnt, resp)),
        "voxelize": (s_voxelize, (pts_b, msk_b)),
        "patches": (s_patches, (kp, km, pyr)),
        "patches_s0": (patches_scale(0), (kp, km, pyr)),
        "patches_s1": (patches_scale(1), (kp, km, pyr)),
        "patches_s2": (patches_scale(2), (kp, km, pyr)),
        "encoder": (s_encoder, (patches,)),
    }
    want = [s for s in args.stages.split(",") if s]
    out = {}
    for name, (fn, inputs) in stages.items():
        if want and name not in want:
            continue
        jax.block_until_ready(fn(*inputs))          # warm-up
        times = []
        for r in range(args.reps):
            t0 = time.time()
            jax.block_until_ready(fn(*inputs))
            times.append(time.time() - t0)
        ms = sorted(times)[len(times) // 2] * 1e3
        out[name] = {"ms_total": round(ms, 2),
                     "ms_per_frame": round(ms / B, 3)}
        print(name, out[name], flush=True)
    print(json.dumps({"frames": B, "dtype": args.dtype, "stages": out}))


if __name__ == "__main__":
    main()
