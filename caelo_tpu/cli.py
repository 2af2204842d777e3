"""Unified CLI: preprocess / train / odometry / refine / evaluate / bench.

The reference has *no* flag system — behavior switches are hand-edited
module-scope integers (``RefinePoses.py:523-531``, ``PoseEstimation.py:
174-189``, ``Match.py:287-291``) and paths are constants in ``Dirs.py``.
This module replaces all of that with one argparse tree:

  python -m caelo_tpu.cli odometry --data /kitti --seq 00 --out runs/
  python -m caelo_tpu.cli refine   --poses runs/poses_/00.txt ...
  python -m caelo_tpu.cli evaluate --gt ... --est ...
  python -m caelo_tpu.cli train-respond / train-patch ...
  python -m caelo_tpu.cli bench
  python -m caelo_tpu.cli selftest   # synthetic end-to-end check, no data
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p):
    p.add_argument("--platform", default=None,
                   help="jax platform override (e.g. cpu or cuda)")


def _setup_platform(args):
    if args.platform:
        import jax

        os.environ["JAX_PLATFORMS"] = args.platform
        jax.config.update("jax_platforms", args.platform)


def model_params(cfg):
    """The shipped reference weights when present, else the seed-0 random
    init of both networks: ``(respond_params, encoder_params)``."""
    import jax
    import jax.numpy as jnp

    from .models import weights_io
    from .models.patch_encoder import PatchEncoder
    from .models.respond_net import RespondLayer

    if weights_io.reference_models_available():
        return (weights_io.load_respond_layer_params(),
                weights_io.load_patch_encoder_params())
    key = jax.random.key(0)
    return (RespondLayer().init(
                key, jnp.zeros((1, cfg.sensor.model_h, cfg.sensor.model_w, 3))),
            PatchEncoder().init(key, jnp.zeros((1, 16, 16, 16))))


def selftest(cfg) -> dict:
    """Register the seed-0 synthetic scan pair and score it against its
    ground truth; ``out["passed"]`` applies the gates (success, rotation
    error < 1 deg, translation error < 0.5 m)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .data.synthetic import synthetic_scan_pair
    from .frontend.registration import extract_frame_features, register_pair
    from .geometry import se3

    scan0, mask0, scan1, mask1, R_gt, t_gt = synthetic_scan_pair(seed=0, cfg=cfg)
    respond, encoder = model_params(cfg)
    f0 = extract_frame_features(respond, encoder, jnp.asarray(scan0), jnp.asarray(mask0), cfg)
    f1 = extract_frame_features(respond, encoder, jnp.asarray(scan1), jnp.asarray(mask1), cfg)
    reg = register_pair(jax.random.key(0), f0, f1, cfg)
    ang = float(se3.rotation_geodesic_deg(reg.R, jnp.asarray(R_gt)))
    terr = float(np.linalg.norm(np.asarray(reg.t) - t_gt))
    out = {"success": bool(reg.success), "n_inliers": int(reg.n_inliers),
           "rot_err_deg": ang, "trans_err_m": terr}
    out["passed"] = out["success"] and ang < 1.0 and terr < 0.5
    return out


def cmd_selftest(args):
    """Synthetic end-to-end registration check (no dataset needed)."""
    _setup_platform(args)
    from .config import PipelineConfig, small_test_config

    out = selftest(small_test_config() if args.small else PipelineConfig())
    print(json.dumps(out))
    return 0 if out["passed"] else 1


def cmd_odometry(args):
    _setup_platform(args)
    import numpy as np

    from .config import PipelineConfig
    from .data.kitti import KittiOdometry, save_kitti_poses
    from .frontend.odometry import run_odometry
    from .models import weights_io

    cfg = PipelineConfig()
    ds = KittiOdometry(args.data, cfg)
    respond = weights_io.load_respond_layer_params(args.respond_weights)
    encoder = weights_io.load_patch_encoder_params(args.encoder_weights)
    R_tr, t_tr = ds.load_calib(args.seq)
    n = ds.n_frames(args.seq) if args.frames < 0 else args.frames
    progress = lambda i: print(f"{args.seq}:{n}:{i}", end="\r", flush=True)
    if args.keypoints == "cae-lo":
        # fused 16-frame window pipeline (one device dispatch per window)
        from .frontend.odometry import run_odometry_windowed

        result, _ = run_odometry_windowed(
            ds.iter_scans(args.seq, 0, n), respond, encoder, R_tr, t_tr, cfg,
            window=min(64, n), progress=progress,
        )
    elif args.keypoints == "external":
        # third-party keypoints/descriptors from their file trees
        # (EvalOnReg_KeyPts.py:73-204 / Dirs.py:35-41)
        import itertools

        import jax
        import jax.numpy as jnp

        from .data.external import ExternalSequence
        from .frontend.ablation import features_from_keypoints

        if not args.external_dir:
            print("--keypoints external requires --external-dir",
                  file=sys.stderr)
            return 2
        ext = ExternalSequence(
            args.external_dir, seq=args.seq, fmt=args.external_fmt,
            desc_dim=args.external_desc_dim,
            n_slots=cfg.keypoint.n_keypoints,
        )
        counter = itertools.count()

        def feature_fn(pts, mask):
            f = ext.features(next(counter))
            # keypoints only -> CAE-LO descriptors.  (FrameFeatures is a
            # NamedTuple, i.e. also a tuple — check for the bare pair.)
            if isinstance(f, tuple) and not hasattr(f, "_fields"):
                kp, km = f
                return features_from_keypoints(
                    encoder, jnp.asarray(pts), jnp.asarray(mask),
                    jnp.asarray(kp), jnp.asarray(km), cfg,
                )
            return jax.tree.map(jnp.asarray, f)

        result = run_odometry(
            ds.iter_scans(args.seq, 0, n), respond, encoder, R_tr, t_tr, cfg,
            feature_fn=feature_fn, progress=progress,
        )
    else:
        from .frontend.ablation import make_ablation_feature_fn

        feature_fn = make_ablation_feature_fn(
            args.keypoints, respond, encoder, cfg
        )
        result = run_odometry(
            ds.iter_scans(args.seq, 0, n), respond, encoder, R_tr, t_tr, cfg,
            feature_fn=feature_fn, progress=progress,
        )
    out = os.path.join(args.out, "poses_", f"{args.seq}.txt")
    save_kitti_poses(out, result.poses)
    np.savez(os.path.join(args.out, f"odom_{args.seq}.npz"),
             rel_Rs=result.rel_Rs, rel_ts=result.rel_ts,
             successes=result.successes, n_inliers=result.n_inliers,
             thresholds=result.thresholds,
             **{f"inl0_{i}": p[0] for i, p in enumerate(result.inlier_pairs)},
             **{f"inl1_{i}": p[1] for i, p in enumerate(result.inlier_pairs)})
    # the reference's Matchablity_*.mat stats (GenerateTrajactory.m:284-290):
    # inlier proportion + the adaptive-effort stat (threshold escalations
    # stand in for its trial counts)
    inlier_ratio = result.n_inliers.mean() / cfg.keypoint.n_keypoints
    esc = (result.thresholds > cfg.ransac.residual_thresholds[0]).mean()
    print(f"\nwrote {out}: {len(result.poses)} poses, "
          f"{result.successes.mean()*100:.1f}% pair success, "
          f"inlier ratio {inlier_ratio*100:.1f}%, "
          f"threshold escalation {esc*100:.1f}%")
    return 0


def cmd_preprocess(args):
    """Front-end pass persisting per-frame artifacts + poses_ (the
    reference's BatchPreprocess + PoseEstimation stages; restartable
    back-end stages read these via ``cli refine`` / ``cli loop``)."""
    _setup_platform(args)
    from .config import PipelineConfig
    from .data.artifacts import ArtifactStore
    from .data.kitti import KittiOdometry, save_kitti_poses
    from .models import weights_io
    from .pipeline import preprocess_to_store

    cfg = PipelineConfig()
    ds = KittiOdometry(args.data, cfg)
    respond = weights_io.load_respond_layer_params()
    encoder = weights_io.load_patch_encoder_params()
    R_tr, t_tr = ds.load_calib(args.seq)
    n = ds.n_frames(args.seq) if args.frames < 0 else args.frames
    store = ArtifactStore(args.artifacts)
    progress = lambda i: print(f"{args.seq}:{n}:{i}", end="\r", flush=True)
    odo = preprocess_to_store(
        ds.iter_scans(args.seq, 0, n), respond, encoder, R_tr, t_tr, cfg,
        store, args.seq, progress=progress,
    )
    out = os.path.join(args.out, "poses_", f"{args.seq}.txt")
    save_kitti_poses(out, odo.poses)
    print(f"\nwrote {out} + artifacts under {args.artifacts}: "
          f"{len(odo.poses)} frames, "
          f"{odo.successes.mean()*100:.1f}% pair success")
    return 0


def cmd_refine(args):
    """De-jump + (with --artifacts) ICP refinement from stored artifacts:
    poses_ -> poses__ -> poses___ without touching raw scans
    (``RefinePoses.py:526-531`` stage toggles ``iDejump/iRefineOdometry``)."""
    _setup_platform(args)
    import numpy as np

    from .backend.refine import fix_jump_poses
    from .config import PipelineConfig

    cfg = PipelineConfig()
    poses = np.loadtxt(args.poses).reshape(-1, 12)
    trusted = None
    if args.artifacts:
        # use the stored per-pair RANSAC evidence to gate jump detection
        # (trusted high-inlier registrations are real motion, not jumps)
        from .data.artifacts import ArtifactStore
        from .pipeline import load_stage_inputs

        data = load_stage_inputs(ArtifactStore(args.artifacts), args.seq)
        trusted = data["successes"]
    fixed, frames = fix_jump_poses(poses, cfg.refine, pair_trusted=trusted)
    out_dj = args.out or args.poses.replace("poses_", "poses__")
    os.makedirs(os.path.dirname(out_dj) or ".", exist_ok=True)
    np.savetxt(out_dj, fixed)
    print(f"de-jumped {len(frames)} frames -> {out_dj}")
    if not args.artifacts:
        return 0

    from .pipeline import stage_refinement

    poses_ref, stats = stage_refinement(
        fixed, data["ref_feats"], data["inlier_pairs"],
        data["R_tr"], data["t_tr"], cfg, pair_trusted=data["successes"],
    )
    out_ref = out_dj.replace("poses__", "poses___")
    np.savetxt(out_ref, poses_ref)
    print(f"refined {len(stats.refined)} spans "
          f"({len(stats.failed)} failed, {len(stats.rejected)} rejected) "
          f"-> {out_ref}")
    return 0


def cmd_loop(args):
    """Loop closure + pose-graph solve from stored artifacts:
    poses___ -> poses____ (``CloseLoopPipeline``, ``RefinePoses.py:477-518``
    — restartable via ``iCloseLoop``-style staging)."""
    _setup_platform(args)
    import numpy as np

    from .config import PipelineConfig
    from .data.artifacts import ArtifactStore
    from .pipeline import load_stage_inputs, stage_loop_closure

    cfg = PipelineConfig()
    poses = np.loadtxt(args.poses).reshape(-1, 12)
    data = load_stage_inputs(ArtifactStore(args.artifacts), args.seq)
    poses_final, n_loops, ei, ej = stage_loop_closure(
        poses, data["feats"], data["rel_Rs"], data["rel_ts"],
        data["R_tr"], data["t_tr"], cfg, min_loop_gap=args.min_gap,
        candidate_source=getattr(args, "candidates", "descriptor"),
    )
    out = args.out or args.poses.replace("poses___", "poses____")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savetxt(out, poses_final)
    print(f"closed {n_loops} loops "
          f"({list(zip(ei.tolist(), ej.tolist()))}) -> {out}")
    return 0


def cmd_evaluate(args):
    _setup_platform(args)
    import numpy as np

    from .eval.metrics import (absolute_trajectory_error, kitti_drift,
                               registration_summary, relative_pose_errors)
    from .geometry.kitti_pose import load_calib_tr

    gt = np.loadtxt(args.gt).reshape(-1, 12)
    est = np.loadtxt(args.est).reshape(-1, 12)
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    if args.calib:
        R_tr, t_tr = load_calib_tr(args.calib)
    else:
        R_tr, t_tr = np.eye(3), np.zeros(3)
    errs = relative_pose_errors(gt, est, R_tr, t_tr)
    out = registration_summary(errs)
    out.update(absolute_trajectory_error(gt, est))
    out.update(kitti_drift(gt, est))
    print(json.dumps(out, indent=2))
    return 0


def cmd_train_respond(args):
    _setup_platform(args)
    from .training.drivers import train_respond_main

    return train_respond_main(args)


def cmd_train_patch(args):
    _setup_platform(args)
    from .training.drivers import train_patch_main

    return train_patch_main(args)


def cmd_full(args):
    _setup_platform(args)
    import numpy as np

    from .config import PipelineConfig, ci_config
    from .data.kitti import KittiOdometry, save_kitti_poses
    from .models import weights_io
    from .pipeline import run_full_pipeline

    from .utils.telemetry import MetricsLog, StageTimer

    cfg = ci_config() if getattr(args, "ci", False) else PipelineConfig()
    ds = KittiOdometry(args.data, cfg)
    respond = weights_io.load_respond_layer_params()
    encoder = weights_io.load_patch_encoder_params()
    R_tr, t_tr = ds.load_calib(args.seq)
    n = ds.n_frames(args.seq) if args.frames < 0 else args.frames
    timer = StageTimer(sync=False)
    metrics = MetricsLog(os.path.join(args.out, f"metrics_{args.seq}.jsonl"))
    out = run_full_pipeline(
        list(ds.iter_scans(args.seq, 0, n)), respond, encoder, R_tr, t_tr,
        cfg, enable_refinement=not args.no_refine,
        enable_loop_closure=not args.no_loops,
        timer=timer, metrics=metrics,
    )
    metrics.log("stage_timings", **{
        k: v["total_s"] for k, v in timer.summary().items()
    })
    # the reference's four-trajectory naming convention (Dirs.py:19-24)
    for name, poses in [("poses_", out.poses_raw),
                        ("poses__", out.poses_dejumped),
                        ("poses___", out.poses_refined),
                        ("poses____", out.poses_final)]:
        save_kitti_poses(os.path.join(args.out, name, f"{args.seq}.txt"), poses)
    print(json.dumps({
        "frames": int(n),
        "pair_success_rate": float(out.odometry.successes.mean()),
        "dejumped": len(out.dejumped_frames),
        "refined_spans": len(out.refine_stats.refined),
        "loop_closures": out.n_loop_closures,
    }))
    return 0


def cmd_scaling(args):
    _setup_platform(args)
    from .config import small_test_config
    from .eval.scaling import scaling_sweep

    cfg = small_test_config()
    respond, encoder = model_params(cfg)
    out = scaling_sweep(respond, encoder, cfg,
                        frames_per_device=args.frames_per_device)
    print(json.dumps(out, indent=2))
    return 0


def cmd_bench(args):
    import bench

    return bench.main()


def main(argv=None):
    ap = argparse.ArgumentParser("caelo_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("selftest", help="synthetic end-to-end check")
    p.add_argument("--small", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("odometry", help="run per-sequence odometry")
    p.add_argument("--data", required=True, help="KITTI odometry root")
    p.add_argument("--seq", default="00")
    p.add_argument("--out", default="runs")
    p.add_argument("--frames", type=int, default=-1)
    p.add_argument("--respond-weights", default=None)
    p.add_argument("--encoder-weights", default=None)
    p.add_argument("--keypoints", default="cae-lo",
                   choices=["cae-lo", "iss", "harris", "sift", "random",
                            "external"],
                   help="keypoint-source ablation (PoseEstimation.py:30-39); "
                        "'external' loads keypoints/descriptors from "
                        "--external-dir (EvalOnReg_KeyPts.py:73-204)")
    p.add_argument("--external-dir", default=None,
                   help="directory of per-frame external keypoint (.bin xyz "
                        "float32) and descriptor (.bin Utils.m:57-75 layout) "
                        "files for --keypoints external")
    p.add_argument("--external-fmt", default="3dfeatnet",
                   choices=["3dfeatnet", "xyzdesc", "usip"],
                   help="binary layout of the external files")
    p.add_argument("--external-desc-dim", type=int, default=32,
                   help="descriptor dim for the xyzdesc layout")
    _add_common(p)
    p.set_defaults(fn=cmd_odometry)

    p = sub.add_parser("full", help="full stack: odometry+dejump+refine+loops")
    p.add_argument("--data", required=True)
    p.add_argument("--seq", default="00")
    p.add_argument("--out", default="runs")
    p.add_argument("--frames", type=int, default=-1)
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--no-loops", action="store_true")
    p.add_argument("--ci", action="store_true",
                   help="CI-scale config (config.ci_config) — test trees")
    _add_common(p)
    p.set_defaults(fn=cmd_full)

    p = sub.add_parser("scaling", help="frames/s scaling sweep over devices")
    p.add_argument("--frames-per-device", type=int, default=4)
    _add_common(p)
    p.set_defaults(fn=cmd_scaling)

    p = sub.add_parser("preprocess",
                       help="front end -> per-frame artifacts + poses_")
    p.add_argument("--data", required=True, help="KITTI odometry root")
    p.add_argument("--seq", default="00")
    p.add_argument("--out", default="runs")
    p.add_argument("--artifacts", default="runs/artifacts")
    p.add_argument("--frames", type=int, default=-1)
    _add_common(p)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("refine",
                       help="de-jump (+ ICP refine from --artifacts): "
                            "poses_ -> poses__ -> poses___")
    p.add_argument("--poses", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--artifacts", default=None,
                   help="artifact store from `preprocess`; enables the ICP "
                        "refinement stage")
    p.add_argument("--seq", default="00")
    _add_common(p)
    p.set_defaults(fn=cmd_refine)

    p = sub.add_parser("loop",
                       help="loop closure from artifacts: poses___ -> "
                            "poses____")
    p.add_argument("--poses", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--artifacts", required=True)
    p.add_argument("--seq", default="00")
    p.add_argument("--min-gap", type=int, default=100)
    p.add_argument("--candidates", default="descriptor",
                   choices=("descriptor", "scancontext"),
                   help="loop-candidate source: pooled-descriptor distance "
                        "(default) or the rotation-searched ScanContext "
                        "correlation matrix (robust to reverse-traversal "
                        "revisits and descriptor aliasing)")
    _add_common(p)
    p.set_defaults(fn=cmd_loop)

    p = sub.add_parser("evaluate", help="RRE/RTE/ATE/drift vs ground truth")
    p.add_argument("--gt", required=True)
    p.add_argument("--est", required=True)
    p.add_argument("--calib", default=None)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("train-respond", help="train the 2D respond AE")
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="checkpoints/respond")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes instead of KITTI")
    p.add_argument("--steps", type=int, default=-1)
    _add_common(p)
    p.set_defaults(fn=cmd_train_respond)

    p = sub.add_parser("train-patch", help="train the 3D voxel-patch AE")
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="checkpoints/patch")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=-1)
    _add_common(p)
    p.set_defaults(fn=cmd_train_patch)

    p = sub.add_parser("bench", help="run the benchmark")
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from .utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
