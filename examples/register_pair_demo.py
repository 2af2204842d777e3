"""End-to-end demo: synthetic scan pair -> full CAE-LO front end -> pose.

The framework's equivalent of the reference's ``python Match.py`` demo
(``Match.py:286-373``): extract keypoints + descriptors for two scans with
the *shipped reference weights*, match, run batched RANSAC, and print the
pose error against ground truth.

Run on the GPU (default) or CPU:  JAX_PLATFORMS=cpu python examples/register_pair_demo.py
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from caelo_tpu.config import PipelineConfig
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.frontend.registration import extract_frame_features, register_pair
from caelo_tpu.geometry import se3
from caelo_tpu.models import weights_io


def main():
    from caelo_tpu.utils.compcache import enable_compilation_cache

    print("compilation cache:", enable_compilation_cache())
    print("devices:", jax.devices())
    cfg = PipelineConfig()
    print("generating synthetic scan pair...")
    scan0, mask0, scan1, mask1, R_gt, t_gt = synthetic_scan_pair(seed=0, cfg=cfg)
    print(f"scan0: {mask0.sum()} pts, scan1: {mask1.sum()} pts")

    respond = weights_io.load_respond_layer_params()
    encoder = weights_io.load_patch_encoder_params()

    t0 = time.time()
    f0 = extract_frame_features(respond, encoder, jnp.asarray(scan0), jnp.asarray(mask0), cfg)
    jax.block_until_ready(f0)
    t1 = time.time()
    f1 = extract_frame_features(respond, encoder, jnp.asarray(scan1), jnp.asarray(mask1), cfg)
    jax.block_until_ready(f1)
    t2 = time.time()
    print(f"feature extraction: {t1-t0:.2f}s (compile+run), {t2-t1:.3f}s (cached)")
    print(f"keypoints: {int(f0.mask.sum())} / {int(f1.mask.sum())}")

    reg = register_pair(jax.random.key(0), f0, f1, cfg)
    jax.block_until_ready(reg)
    t3 = time.time()
    reg = register_pair(jax.random.key(1), f0, f1, cfg)
    jax.block_until_ready(reg)
    t4 = time.time()
    print(f"registration: {t3-t2:.2f}s (compile+run), {t4-t3:.3f}s (cached)")

    R = np.asarray(reg.R)
    t = np.asarray(reg.t)
    ang_err = float(se3.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(R_gt)))
    t_err = float(np.linalg.norm(t - t_gt))
    print(f"success={bool(reg.success)} inliers={int(reg.n_inliers)} "
          f"threshold={float(reg.threshold):.2f}")
    print(f"rotation error: {ang_err:.4f} deg   translation error: {t_err:.4f} m")
    assert bool(reg.success), "registration failed"
    assert ang_err < 1.0 and t_err < 0.5, "pose error above KITTI success gate"
    print("OK: within the reference success thresholds (RRE<1deg, RTE<0.5m)")


if __name__ == "__main__":
    main()
