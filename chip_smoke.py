"""Smoke test of the odometry system on an NVIDIA GPU.

Drives the main path once at full width (``PipelineConfig()``: 131072-point
scans, a 64 x 1792 respond image, 1024 keypoints, three voxel scales at
their default caps, 2048 RANSAC hypotheses) through the entry points a user
calls, with the seed-0 random-init weights, and checks every part against a
plain reference.  Phases, in order, all in this one process:

  device     JAX must run on a GPU; prints the card, its power limit, JAX
  reference  the saliency map, the two networks and the matching / ICP
             distance matmuls on the GPU against a float64 numpy oracle or
             the CPU backend, at real widths
  selftest   ``cli selftest``'s registration gates
  window     the fused window program at 16 frames (vmap path) and at 64
             (lax.map path) on ray-cast scans
  pipeline   ``run_full_pipeline`` with every stage on, 48 ray-cast frames

A failed gate raises, so the run ends non-zero.  The last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage:
  python chip_smoke.py          # one GPU: every phase above
  python chip_smoke.py --multi  # four GPUs: the sharded paths only
  JAX_PLATFORMS=cpu python chip_smoke.py --cpu-reference [window pipeline]
                                # prints the CPU-backend numbers that
                                # CPU_REFERENCE below holds
"""
import argparse
import json
import os
import sys
import time

import numpy as np

# Window results of the same seeds on JAX's CPU backend, recorded with
# ``--cpu-reference window`` (16-core x86 host, JAX 0.9.0): 15/15 pairs
# (RRE 0.2458 deg, RTE 0.0577 m) and 63/63 (RRE 0.2111 deg, RTE 0.0563 m).
CPU_REFERENCE = {
    "window16": {"pairs": 15, "success": 15},
    "window64": {"pairs": 63, "success": 63},
}
# The CPU run of the pipeline phase did not finish within 25 minutes on
# that host, so the pipeline's final ATE is held to 1.5x the first H100
# run's instead (0.7447 m; raw 0.7252 m, 1 loop closure, 1 burst span).
PIPELINE_ATE_FINAL_M = 0.7447

# Tolerances of the reference phase (max abs error over max abs value of
# the reference output):
# - saliency: elementwise f32 sums of 8 squares, no matmul; only the
#   summation order differs from the float64 oracle.
SALIENCY_RTOL = 1e-5
# - networks at "highest" matmul precision: f32 convs on both backends,
#   which differ only in summation order.
HIGHEST_RTOL = 1e-5
# - networks at default precision: the GPU runs f32 convs in TF32 (10-bit
#   mantissa); bounds are under 2x the errors measured on an H100
#   (respond 7.27e-4, encoder 7.88e-4).
DEFAULT_RTOL = {"respond": 1.4e-3, "encoder": 1.5e-3}
# - share of the descriptor-matching argmins at default precision that
#   agree with "highest" (measured 0.9990 on an H100).
MIN_MATCH_AGREEMENT = 0.99
# - the same share for the ICP correspondence search.  Its distance
#   identity cancels |q|^2 ~ 2500 m^2 terms at KITTI ranges, which TF32
#   cannot resolve: measured 0.579 on an H100 (a TF32 emulation predicts
#   0.587).  The floor only guards against a further drop.
MIN_ICP_AGREEMENT = 0.5

WINDOW_SIZES = (16, 64)
PIPELINE_FRAMES = 48


def emit(phase, seconds, **numbers):
    print(json.dumps({"phase": phase, "seconds": seconds, **numbers}),
          flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(f"gate failed: {what}")


def rel_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


# ------------------------------------------------------------------ phases
def phase_device(n_devices):
    import jax

    from caelo_tpu.utils.telemetry import gpu_name_and_power_limit

    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    check(len(devs) >= n_devices, f"{len(devs)} GPUs, need {n_devices}")
    print(gpu_name_and_power_limit(), flush=True)
    print(f"device_kind={devs[0].device_kind} count={len(devs)} "
          f"jax={jax.__version__}", flush=True)


def saliency_oracle(resp, occ):
    """float64 min squared diff to occupied 5x5 neighbours + their count."""
    H, W, _ = resp.shape
    rp = np.pad(resp.astype(np.float64), ((2, 2), (2, 2), (0, 0)))
    op = np.pad(occ, 2)
    md = np.full((H, W), np.inf)
    cnt = np.zeros((H, W), np.int32)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            o = op[dy:dy + H, dx:dx + W]
            d2 = ((rp[dy:dy + H, dx:dx + W] - rp[2:2 + H, 2:2 + W]) ** 2).sum(-1)
            md = np.minimum(md, np.where(o, d2, np.inf))
            cnt += o
    return md, cnt


def phase_reference(cfg, respond, encoder):
    import jax
    import jax.numpy as jnp

    from caelo_tpu.backend.icp import nearest_neighbors
    from caelo_tpu.data.synthetic import synthetic_scan_pair
    from caelo_tpu.frontend.matching import squared_distance_matrix
    from caelo_tpu.frontend.registration import extract_frame_features
    from caelo_tpu.models.patch_encoder import PatchEncoder
    from caelo_tpu.models.respond_net import RespondLayer
    from caelo_tpu.ops.nms import saliency_map, select_keypoints
    from caelo_tpu.projection.spherical import (model_input,
                                                project_to_spherical_ring)
    from caelo_tpu.voxel.grid import extract_patches, voxelize

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    out = {}

    def run(dev, fn, *args, precision=None):
        with jax.default_matmul_precision(precision):
            return jax.device_get(jax.jit(fn)(*jax.device_put(args, dev)))

    # saliency map (the NMS stencil) against the float64 oracle
    rng = np.random.default_rng(0)
    H, W = cfg.sensor.model_h, cfg.sensor.model_w
    resp = rng.normal(size=(H, W, 8)).astype(np.float32)
    occ = rng.uniform(size=(H, W)) < 0.6
    md_ref, cnt_ref = saliency_oracle(resp, occ)
    fin = np.isfinite(md_ref)
    md, cnt = run(gpu, saliency_map, resp, occ)
    check(np.array_equal(cnt, cnt_ref), "saliency: neighbour counts")
    check(np.array_equal(np.isfinite(md), fin), "saliency: finite mask")
    out["saliency_rel_err"] = rel_err(md[fin], md_ref[fin])
    check(out["saliency_rel_err"] <= SALIENCY_RTOL,
          f"saliency: {out['saliency_rel_err']} > {SALIENCY_RTOL}")

    # respond net on one ring image
    scan0, mask0, scan1, mask1, R_gt, t_gt = synthetic_scan_pair(seed=0,
                                                                 cfg=cfg)
    image, counter = jax.device_get(jax.jit(
        lambda p, m: project_to_spherical_ring(p, m, cfg.sensor))(
            scan0, mask0))
    net_in = np.asarray(model_input(image, cfg.sensor))[None]
    rnet = lambda p, x: RespondLayer().apply(p, x)
    r_cpu = run(cpu, rnet, respond, net_in, precision="highest")
    r_hi = run(gpu, rnet, respond, net_in, precision="highest")
    r_def = run(gpu, rnet, respond, net_in)
    out["respond_highest_rel_err"] = rel_err(r_hi, r_cpu)
    out["respond_default_rel_err"] = rel_err(r_def, r_cpu)
    check(out["respond_highest_rel_err"] <= HIGHEST_RTOL, "respond highest")
    check(out["respond_default_rel_err"] <= DEFAULT_RTOL["respond"],
          "respond default")

    # top-1024 keypoints from the GPU's default-precision respond map vs
    # the CPU's
    kp = lambda r: select_keypoints(image, counter, r, cfg.sensor,
                                    cfg.keypoint)
    kp_cpu = run(cpu, kp, r_cpu[0])
    kp_gpu = run(gpu, kp, r_def[0])
    sets = [set(map(tuple, k[1][k[2]].tolist())) for k in (kp_cpu, kp_gpu)]
    out["keypoint_overlap"] = len(sets[0] & sets[1]) / max(len(sets[0]), 1)

    # patch encoder on 3072 real 16^3 patches (1024 keypoints x 3 scales)
    patches = run(gpu, lambda p, m, k, km: extract_patches(
        k, km, voxelize(p[:, :3], m, cfg.voxel), cfg.voxel),
        scan0, mask0, kp_cpu[0], kp_cpu[2])
    patches = np.concatenate(patches).astype(np.float32)
    enc = lambda p, x: PatchEncoder().apply(p, x)
    e_cpu = run(cpu, enc, encoder, patches, precision="highest")
    e_hi = run(gpu, enc, encoder, patches, precision="highest")
    e_def = run(gpu, enc, encoder, patches)
    out["encoder_patches"] = int(patches.shape[0])
    out["encoder_highest_rel_err"] = rel_err(e_hi, e_cpu)
    out["encoder_default_rel_err"] = rel_err(e_def, e_cpu)
    check(out["encoder_highest_rel_err"] <= HIGHEST_RTOL, "encoder highest")
    check(out["encoder_default_rel_err"] <= DEFAULT_RTOL["encoder"],
          "encoder default")

    # descriptor matching (1024 x 1024 x 60): argmin over frame-0 codes per
    # frame-1 keypoint, default vs highest precision
    f0, f1 = (jax.device_get(extract_frame_features(
        respond, encoder, jnp.asarray(s), jnp.asarray(m), cfg))
        for s, m in ((scan0, mask0), (scan1, mask1)))
    valid = f0.mask[:, None] & f1.mask[None, :]

    def match(a, b):
        return jnp.argmin(jnp.where(valid, squared_distance_matrix(a, b),
                                    jnp.inf), axis=0)

    m_hi = run(gpu, match, f0.descriptors, f1.descriptors,
               precision="highest")
    m_def = run(gpu, match, f0.descriptors, f1.descriptors)
    out["match_argmin_agreement"] = float(np.mean(
        (m_hi == m_def)[f1.mask]))

    # ICP correspondence search: 8192-point clouds at KITTI ranges, frame 1
    # moved onto frame 0 by the ground truth
    n = cfg.icp.max_points
    p0 = scan0[mask0][:, :3]
    p1 = scan1[mask1][:, :3] @ np.asarray(R_gt).T + np.asarray(t_gt)
    ref = p0[rng.choice(len(p0), n, replace=False)].astype(np.float32)
    qry = p1[rng.choice(len(p1), n, replace=False)].astype(np.float32)
    ones = np.ones(n, bool)
    nn = lambda q, r: nearest_neighbors(q, ones, r, ones)
    (i_hi, d_hi) = run(gpu, nn, qry, ref, precision="highest")
    (i_def, d_def) = run(gpu, nn, qry, ref)
    out["icp_nn_range_m"] = float(np.linalg.norm(qry, axis=1).mean())
    out["icp_nn_argmin_agreement"] = float(np.mean(i_hi == i_def))
    out["icp_nn_dist_excess_m_median"] = float(np.median(d_def - d_hi))
    out["icp_nn_dist_excess_m_p95"] = float(np.percentile(d_def - d_hi, 95))
    check(out["match_argmin_agreement"] >= MIN_MATCH_AGREEMENT,
          "matching argmin agreement")
    check(out["icp_nn_argmin_agreement"] >= MIN_ICP_AGREEMENT,
          "ICP nearest-neighbour argmin agreement")
    return out


def phase_selftest(cfg):
    from caelo_tpu.cli import selftest

    out = selftest(cfg)
    check(out["passed"], f"selftest {out}")
    return out


def window_run(cfg, respond, encoder, scans, gt, window, record):
    """One fused window program over the first ``window`` frames: pair
    success and RRE/RTE of the successful pairs.  The production window
    (16, ``run_full_pipeline``) also emits the refinement features, as
    production does; the bench window (64) does not."""
    import jax
    import jax.numpy as jnp

    from caelo_tpu.eval.metrics import relative_pose_errors
    from caelo_tpu.geometry.kitti_pose import chain_poses
    from caelo_tpu.parallel.pipeline import make_sequence_processor

    pts = jnp.asarray(np.stack([s[0] for s in scans[:window]]))
    msk = jnp.asarray(np.stack([s[1] for s in scans[:window]]))
    process = make_sequence_processor(cfg, with_refine=window == 16)
    times = []
    for _ in range(1 if record else 2):   # compile + run, then run alone
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            process(respond, encoder, pts, msk, jax.random.key(0)))
        times.append(time.perf_counter() - t0)
    out = jax.device_get(out)
    regs = out[-1]
    finite = all(np.all(np.isfinite(x)) for x in jax.tree.leaves(out)
                 if np.issubdtype(np.asarray(x).dtype, np.floating))
    poses = np.asarray(chain_poses(np.asarray(regs.R, np.float64),
                                   np.asarray(regs.t, np.float64),
                                   np.eye(3), np.zeros(3)))
    errs = relative_pose_errors(gt[:window], poses, np.eye(3), np.zeros(3))
    ok = np.asarray(regs.success, bool)
    return {
        "first_call_seconds": times[0], "window_seconds": times[-1],
        "finite": bool(finite),
        "pairs": int(ok.size), "success": int(ok.sum()),
        "rre_deg": float(errs.rre_deg[ok].mean()) if ok.any() else None,
        "rte_m": float(errs.rte_m[ok].mean()) if ok.any() else None,
    }


def phase_window(cfg, respond, encoder, record=False):
    import jax

    from caelo_tpu.data.hard_synthetic import generate_benchmark

    scans, gt = generate_benchmark(n_frames=max(WINDOW_SIZES), seed=0,
                                   cfg=cfg)
    out = {}
    for w in WINDOW_SIZES:
        r = window_run(cfg, respond, encoder, scans, gt, w, record)
        if record:
            emit(f"cpu_reference_window{w}", r["first_call_seconds"], **r)
        else:
            r["peak_bytes_in_use"] = (jax.devices()[0].memory_stats()
                                      or {}).get("peak_bytes_in_use")
            ref = CPU_REFERENCE[f"window{w}"]
            check(r["finite"], f"window {w}: non-finite output")
            check(r["success"] >= ref["success"] - 1,
                  f"window {w}: {r['success']} successful pairs, CPU had "
                  f"{ref['success']}")
            check(r["rre_deg"] is not None and r["rre_deg"] < 1.0
                  and r["rte_m"] < 0.5, f"window {w}: {r}")
        out[f"window{w}"] = r
    return out


def pipeline_frames(cfg):
    """A 40-frame lap of a small city circuit driven 1.2 times (the last 8
    frames revisit the first: loop closure and the pose-graph solve), with
    a 6-frame sensor-degradation burst (burst rescue)."""
    from caelo_tpu.data.hard_synthetic import generate_benchmark

    return generate_benchmark(
        n_frames=PIPELINE_FRAMES, seed=0, cfg=cfg, side=30.0,
        yaw_rate_deg=12.0, n_cars=3, lap_frames=40,
        degraded_spans=[(20, 26, 0.8, 140.0)])


def run_pipeline(cfg, respond, encoder, scans):
    from caelo_tpu.pipeline import run_full_pipeline

    return run_full_pipeline(scans, respond, encoder, cfg=cfg,
                             enable_refinement=True,
                             enable_loop_closure=True, min_loop_gap=30,
                             seed=0)


def phase_pipeline(cfg, respond, encoder, record=False):
    from caelo_tpu.eval.metrics import absolute_trajectory_error

    scans, gt = pipeline_frames(cfg)
    t0 = time.perf_counter()
    res = run_pipeline(cfg, respond, encoder, scans)
    out = {"run_seconds": time.perf_counter() - t0}
    for name in ("raw", "dejumped", "refined", "final"):
        out[f"ate_{name}_m"] = absolute_trajectory_error(
            gt, getattr(res, f"poses_{name}"))["ate_rmse"]
    bs = res.burst_stats
    out.update(
        pair_success=float(res.odometry.successes.mean()),
        dejumped=len(res.dejumped_frames),
        refined_spans=len(res.refine_stats.refined),
        burst_spans=len(bs.spans) if bs else 0,
        burst_accepted=len(bs.accepted) if bs else 0,
        loop_closures=int(res.n_loop_closures))
    if not record:
        check(bool(np.all(np.isfinite(res.poses_final))),
              "pipeline: non-finite final poses")
        bound = 1.5 * PIPELINE_ATE_FINAL_M
        check(out["ate_final_m"] <= bound,
              f"pipeline: final ATE {out['ate_final_m']} > {bound}")
    return out


def phase_multi(cfg, respond, encoder, n_devices):
    """The sharded paths on ``n_devices`` GPUs, each checked against one
    device: ``dryrun_multichip`` (each of its paths checks itself) and the
    span-sharded ICP refinement on the pipeline phase's frames."""
    import jax

    import __graft_entry__
    from caelo_tpu.backend.refine import fix_jump_poses
    from caelo_tpu.frontend.odometry import run_odometry_windowed
    from caelo_tpu.pipeline import stage_refinement

    devs = jax.devices()[:n_devices]
    out = {}
    scans, _ = pipeline_frames(cfg)
    odo, _, ref_feats = run_odometry_windowed(
        scans, respond, encoder, cfg=cfg, window=16,
        keep_refine_features=True)
    poses_dj, _ = fix_jump_poses(odo.poses, cfg.refine,
                                 pair_trusted=odo.successes)
    # every pair untrusted, so every keyframe span is solved
    untrusted = np.zeros_like(odo.successes)
    args = (poses_dj, ref_feats, odo.inlier_pairs, np.eye(3), np.zeros(3),
            cfg)
    t0 = time.perf_counter()
    p_one, s_one = stage_refinement(*args, pair_trusted=untrusted,
                                    devices=devs[:1])
    out["refine_1dev_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_all, s_all = stage_refinement(*args, pair_trusted=untrusted,
                                    devices=devs)
    out["refine_ndev_seconds"] = time.perf_counter() - t0
    out["refine_spans"] = len(s_all.refined) + len(s_all.failed) + len(
        s_all.rejected)
    out["refine_max_abs_pose_diff"] = float(np.max(np.abs(p_all - p_one)))
    out["peak_bytes_per_device"] = [
        (d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    check(out["refine_spans"] > 0, "sharded refinement solved no span")
    check(out["refine_max_abs_pose_diff"] < 1e-5,
          f"sharded refinement differs: {out['refine_max_abs_pose_diff']}")
    check(all(b and b > 0 for b in out["peak_bytes_per_device"]),
          "a device held no memory")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_devices)
    out["dryrun_seconds"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------------------- main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--multi", action="store_true",
                      help="four GPUs: the sharded paths only")
    mode.add_argument("--cpu-reference", nargs="*",
                      choices=("window", "pipeline"),
                      help="print the CPU-backend numbers of these phases "
                           "(default both; no GPU, no gates)")
    args = ap.parse_args(argv)

    import jax

    import caelo_tpu
    here = os.path.dirname(os.path.abspath(__file__))
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        caelo_tpu.__file__))) == here,
        f"caelo_tpu comes from {caelo_tpu.__file__}, not this checkout")
    from caelo_tpu.cli import model_params
    from caelo_tpu.config import PipelineConfig
    from caelo_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    cfg = PipelineConfig()

    if args.cpu_reference is not None:
        check(jax.default_backend() == "cpu", "--cpu-reference runs with "
              "JAX_PLATFORMS=cpu")
        respond, encoder = model_params(cfg)
        for name, fn in (("window", phase_window),
                         ("pipeline", phase_pipeline)):
            if args.cpu_reference and name not in args.cpu_reference:
                continue
            t0 = time.perf_counter()
            numbers = fn(cfg, respond, encoder, record=True)
            emit(f"cpu_reference_{name}", time.perf_counter() - t0,
                 **numbers)
        return 0

    n_devices = 4 if args.multi else 1
    t0 = time.perf_counter()
    phase_device(n_devices)
    emit("device", time.perf_counter() - t0)
    respond, encoder = model_params(cfg)
    if args.multi:
        phases = [("multi", lambda: phase_multi(cfg, respond, encoder,
                                                n_devices))]
    else:
        phases = [
            ("reference", lambda: phase_reference(cfg, respond, encoder)),
            ("selftest", lambda: phase_selftest(cfg)),
            ("window", lambda: phase_window(cfg, respond, encoder)),
            ("pipeline", lambda: phase_pipeline(cfg, respond, encoder)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        numbers = fn()
        emit(name, time.perf_counter() - t0, **numbers)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
