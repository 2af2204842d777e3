"""CI-scale refinement-rescue gate (VERDICT r3 item 1).

A sensor-degradation burst (heavy dropout + occluded azimuth wedge) over a
turn makes the descriptor front end fail or register confidently-wrong
pairs; the refinement stage must actively repair the trajectory — the
reference's reason for the stage to exist (``RefinePoses.py:338-464``).
The full-size version is ``examples/hard_benchmark.py --degraded``.
"""
import numpy as np
import pytest

from caelo_tpu.models import weights_io

needs_ref = pytest.mark.skipif(
    not weights_io.reference_models_available(),
    reason="reference .h5 models not present",
)


@needs_ref
@pytest.mark.slow
def test_refinement_rescues_degraded_burst():
    from test_hard_benchmark import hard_ci_config

    from caelo_tpu.data.hard_synthetic import generate_benchmark
    from caelo_tpu.eval.metrics import absolute_trajectory_error
    from caelo_tpu.pipeline import run_full_pipeline

    cfg = hard_ci_config()
    # 64-frame arc with a degraded burst crossing the first turn (turns at
    # ~7-22 / ~29-44 with yaw_rate 6 deg/frame on the side-30 circuit)
    scans, gt = generate_benchmark(n_frames=64, seed=0, cfg=cfg, side=30.0,
                                   yaw_rate_deg=6.0, az_step_deg=1.6,
                                   n_cars=3,
                                   degraded_spans=[(30, 42, 0.8, 140.0)])
    respond = weights_io.load_respond_layer_params()
    encoder = weights_io.load_patch_encoder_params()
    res = run_full_pipeline(scans, respond, encoder, cfg=cfg,
                            enable_loop_closure=False, seed=0)

    ate_dj = absolute_trajectory_error(gt, res.poses_dejumped)["ate_rmse"]
    ate_ref = absolute_trajectory_error(gt, res.poses_refined)["ate_rmse"]
    # the burst must actually hurt the front end...
    assert not res.odometry.successes.all()
    # ...and the rescue stages must actively repair, not merely
    # not-degrade.  Burst spans are OWNED by stage 3b (multi-frame burst
    # rescue, backend.burst): consecutive degraded frames share one
    # sensor-locked wedge, so pairwise re-registration there is degenerate
    # and is skipped by design — the repair evidence is the accepted burst
    # span (same ``acted`` semantics as examples/hard_benchmark.py).
    bs = res.burst_stats
    acted = (len(res.refine_stats.refined) > 0
             or (bs is not None and len(bs.accepted) > 0))
    assert acted, (res.refine_stats, bs)
    assert ate_ref <= 0.9 * ate_dj, (ate_dj, ate_ref)
