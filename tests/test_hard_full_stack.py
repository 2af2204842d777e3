"""CI-scale quality gate for the FULL pipeline on the hard generator:
front end + de-jump + refinement + loop closure + pose-graph solve on a
closed mini-circuit with a genuine revisit (VERDICT r2 item 1: the back-end
stages must be quality-gated on the hard ray-cast scenes, not only the
front end).  The full-size version is ``examples/hard_benchmark.py``.
"""
import dataclasses

import numpy as np
import pytest

from caelo_tpu.models import weights_io

needs_ref = pytest.mark.skipif(
    not weights_io.reference_models_available(),
    reason="reference .h5 models not present",
)


@needs_ref
@pytest.mark.slow
def test_full_stack_gates_on_hard_circuit():
    """~88-frame closed circuit (one full lap + revisit) at 60 deg/s turn
    rate and reduced sensor resolution, through run_full_pipeline with
    refinement AND loop closure."""
    from test_hard_benchmark import hard_ci_config

    from caelo_tpu.data.hard_synthetic import generate_benchmark
    from caelo_tpu.eval.metrics import (absolute_trajectory_error,
                                        loop_closure_pr,
                                        registration_summary,
                                        relative_pose_errors)
    from caelo_tpu.pipeline import run_full_pipeline

    cfg = hard_ci_config()
    scans, gt = generate_benchmark(n_frames=88, seed=0, cfg=cfg, side=30.0,
                                   yaw_rate_deg=6.0, az_step_deg=1.6,
                                   n_cars=3)
    respond = weights_io.load_respond_layer_params()
    encoder = weights_io.load_patch_encoder_params()
    res = run_full_pipeline(scans, respond, encoder, cfg=cfg,
                            enable_loop_closure=True, min_loop_gap=60,
                            seed=0)

    errs = relative_pose_errors(gt, res.poses_raw, np.eye(3), np.zeros(3))
    s = registration_summary(errs)
    ate_raw = absolute_trajectory_error(gt, res.poses_raw)["ate_rmse"]
    ate_dj = absolute_trajectory_error(gt, res.poses_dejumped)["ate_rmse"]
    ate_ref = absolute_trajectory_error(gt, res.poses_refined)["ate_rmse"]
    ate_fin = absolute_trajectory_error(gt, res.poses_final)["ate_rmse"]

    # front-end gates (reference thresholds, EvaluationOnRegistration.py)
    assert s["success_rate"] >= 0.90, s
    assert s["rre_deg"] < 1.0, s
    assert s["rte_m"] < 0.5, s
    # back-end gates: no stage may damage the trajectory...
    assert ate_dj <= ate_raw * 1.05 + 0.05, (ate_raw, ate_dj)
    assert ate_ref <= ate_dj * 1.05 + 0.05, (ate_dj, ate_ref)
    assert ate_fin <= ate_ref * 1.05 + 0.05, (ate_ref, ate_fin)
    # ...the circuit has a genuine revisit, so the detector must FIND it
    # (recall gate — a permanently-empty loop stage may not pass), and any
    # accepted edges must be genuine revisits
    assert res.n_loop_closures > 0
    pr = loop_closure_pr(res.loop_edge_i, res.loop_edge_j,
                         gt.reshape(-1, 3, 4)[:, :, 3], min_gap=40)
    assert pr["precision"] >= 0.9, pr
    assert pr["recall"] >= 0.5, pr
