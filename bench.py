"""Benchmark: steady-state front-end odometry throughput on one GPU.

Prints ONE JSON line:
  {"metric": "frontend_frames_per_s", "value": N, "unit": "frames/s",
   "vs_baseline": N / BASELINE_FPS, "mfu": ..., "p50_ms": ..., ...}

Measures the full per-frame pipeline (projection -> respond net -> NMS ->
voxel pyramid -> multi-scale patches -> merged 3-scale encoder ->
descriptors) plus per-pair registration (matching + 2048-hypothesis RANSAC
+ refit) on synthetic KITTI-sized scans (~100k points), as one fused
N_FRAMES-frame window program.  Each timed rep ends in
``jax.block_until_ready`` on the rep's outputs, with a per-rep RNG key.

MFU: XLA's own post-optimization FLOP count of the compiled window program
(``compiled.cost_analysis()['flops']``) divided by measured time and the
card's dense tensor-core peak at the precision the program runs in: TF32
for float32 at default matmul precision, bf16 for ``BENCH_DTYPE=bfloat16``.

Baseline: the reference pipeline is CPU+GPU file-based; from its own
published timings (cupy NMS alone 1.8 s/frame, SphericalRing.py:136; sklearn
patch KNN ~2 s/frame and the remaining stages per the timer printouts in
Match.py:315-356) a full frame costs ~5 s => 0.2 frames/s.
"""
import json
import os
import sys
import time

BASELINE_FPS = 0.2
# run_full_pipeline's production window is its `window` parameter (see
# pipeline.py and CLAUDE.md); 64 frames amortize per-window overhead.
N_FRAMES = int(os.environ.get("BENCH_FRAMES", "64"))
COMPUTE_DTYPE = os.environ.get("BENCH_DTYPE", "float32")
REPS = int(os.environ.get("BENCH_REPS", "12"))

# Dense peaks per device_kind (NVIDIA H100 SXM5 data sheet, without
# sparsity): FLOP/s by the precision the convs and matmuls run in, and HBM
# bytes/s.  A device missing here is an error, never a default.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"float32": 495e12,    # TF32 tensor cores
                  "bfloat16": 989e12},
        "hbm_bytes": 3.35e12,
    },
}


def _lookup_peaks(device_kind):
    if device_kind not in _PEAKS:
        raise SystemExit(
            f"bench.py: unknown device_kind {device_kind!r} — add its "
            f"data-sheet peaks to _PEAKS instead of assuming another card's")
    return _PEAKS[device_kind]


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from caelo_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()

    from caelo_tpu.cli import model_params
    from caelo_tpu.config import PipelineConfig
    from caelo_tpu.data.synthetic import (make_scene, sample_scene_points,
                                          range_filter)
    from caelo_tpu.ops.masking import pad_points
    from caelo_tpu.parallel.pipeline import make_sequence_processor
    from caelo_tpu.utils.telemetry import MetricsLog, gpu_name_and_power_limit

    dev = jax.devices()[0]
    peaks = _lookup_peaks(dev.device_kind)
    cfg = PipelineConfig(compute_dtype=COMPUTE_DTYPE)
    respond, encoder = model_params(cfg)

    # synthesize a short sequence: sensor translating through one scene
    scene = make_scene(seed=0)
    world = sample_scene_points(scene, seed=0, n_points=cfg.max_points)
    rng = np.random.default_rng(0)
    scans = []
    for i in range(N_FRAMES):
        t = np.array([1.2 * i, 0.05 * i, 0.0])
        local = range_filter((world - t).astype(np.float32), cfg.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        pts, mask = pad_points(np.concatenate([local, refl], 1), cfg.max_points)
        scans.append((jnp.asarray(pts), jnp.asarray(mask)))

    pts_b = jnp.stack([s for s, _ in scans])
    mask_b = jnp.stack([m for _, m in scans])
    process = make_sequence_processor(cfg)

    t0 = time.time()
    compiled = process.lower(
        respond, encoder, pts_b, mask_b, jax.random.key(0)
    ).compile()
    compile_s = time.time() - t0
    ca = compiled.cost_analysis()
    flops_per_window = float(ca.get("flops", 0.0))
    bytes_per_window = float(ca.get("bytes accessed", 0.0))

    _, regs = process(respond, encoder, pts_b, mask_b, jax.random.key(0))
    n_success = float(jnp.sum(regs.success))

    times = []
    for r in range(REPS):
        t0 = time.time()
        out = process(respond, encoder, pts_b, mask_b, jax.random.key(r + 1))
        jax.block_until_ready(out)
        times.append(time.time() - t0)

    ts = sorted(times)
    p50 = ts[len(ts) // 2]
    p95 = ts[min(len(ts) - 1, int(round(0.95 * (len(ts) - 1))))]
    fps = N_FRAMES / p50

    mfu = flops_per_window / p50 / peaks["flops"][COMPUTE_DTYPE]
    # XLA cost-model bytes over peak HBM bandwidth.  This is NOT an
    # achieved-bandwidth utilization: XLA's "bytes accessed" counts fused
    # reads more than once, so the ratio can exceed 1.0.  It is published
    # under an explicit cost-model name.
    costmodel_hbm = bytes_per_window / p50 / peaks["hbm_bytes"]
    card = gpu_name_and_power_limit().splitlines()[0]

    # capacity-saturation observability: per-scale occupancy vs the static
    # supercell caps / bitgrid slots, logged per run so silent patch
    # truncation on real data is detectable
    from caelo_tpu.voxel.grid import occupancy_stats, voxelize

    pyr = voxelize(pts_b[0, :, :3], mask_b[0], cfg.voxel)
    occ = jax.tree.map(int, occupancy_stats(pyr, cfg.voxel))

    os.makedirs("runs", exist_ok=True)
    log = MetricsLog(os.environ.get("BENCH_METRICS",
                                    "runs/bench_metrics.jsonl"))
    log.log("bench", device=str(dev.device_kind), card=card,
            frames=N_FRAMES, dtype=COMPUTE_DTYPE, compile_s=compile_s,
            window_ms=[t * 1e3 for t in times],
            pair_success=n_success,
            flops_per_window=flops_per_window,
            bytes_per_window=bytes_per_window,
            peak_bytes_in_use=dev.memory_stats().get("peak_bytes_in_use"),
            occupancy=occ,
            supercell_caps=list(cfg.voxel.supercell_caps),
            bitgrid_slots=list(cfg.voxel.bitgrid_slots))

    print(json.dumps({
        "metric": "frontend_frames_per_s",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / BASELINE_FPS,
        "mfu": mfu,
        "xla_costmodel_hbm_frac": costmodel_hbm,
        "bytes_per_window": bytes_per_window,
        "p50_ms": p50 * 1e3,
        "p95_ms": p95 * 1e3,
        "n_frames_window": N_FRAMES,
        "reps": REPS,
        "dtype": COMPUTE_DTYPE,
        "flops_per_window": flops_per_window,
        "platform": dev.platform,
        "device": str(dev.device_kind),
        "device_count": len(jax.devices()),
        "card": card,
        "compile_s": compile_s,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
