"""Scaling sweep harness: frames/s vs number of devices.

The north-star target (BASELINE.md) asks for >=80% scaling efficiency at
4 hosts.  This harness runs the data-parallel batched feature extractor on
1/2/4/.../N-device sub-meshes of whatever devices exist (real chips on a
pod, virtual CPU devices in tests) and reports throughput + efficiency.
"""
from __future__ import annotations

import time
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..parallel.mesh import make_mesh
from ..parallel.pipeline import make_batched_feature_extractor


def scaling_sweep(respond_params, encoder_params,
                  cfg: PipelineConfig,
                  frames_per_device: int = 4,
                  device_counts: List[int] | None = None,
                  reps: int = 3,
                  seed: int = 0) -> dict:
    devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devices)]
    rng = np.random.default_rng(seed)
    results = []
    for n in device_counts:
        mesh = make_mesh(n_data=n, n_model=1, devices=devices[:n])
        ex = make_batched_feature_extractor(mesh, cfg)
        B = frames_per_device * n
        pts = np.zeros((B, cfg.max_points, 4), np.float32)
        pts[..., 0] = rng.uniform(10, 60, (B, cfg.max_points))
        pts[..., 1] = rng.uniform(-30, 30, (B, cfg.max_points))
        pts[..., 2] = rng.uniform(-2, 3, (B, cfg.max_points))
        msk = np.ones((B, cfg.max_points), bool)
        m = jnp.asarray(msk)
        # per-rep-varied inputs; each rep ends in block_until_ready
        variants = [
            jnp.asarray(pts + np.float32(1e-4 * r)) for r in range(reps + 1)
        ]
        out = ex(respond_params, encoder_params, variants[0], m)
        jax.block_until_ready(out)              # warm-up
        times = []
        for r in range(reps):
            t0 = time.time()
            out = ex(respond_params, encoder_params, variants[r + 1], m)
            jax.block_until_ready(out)
            times.append(time.time() - t0)
        dt = sorted(times)[len(times) // 2]
        results.append({"devices": n, "frames": B,
                        "frames_per_s": B / dt, "dt_s": dt})
    base = results[0]["frames_per_s"]
    for r in results:
        r["efficiency"] = r["frames_per_s"] / (base * r["devices"])
    return {"sweep": results}
