"""Tracing, stage timing, and structured run metrics.

The reference's observability is ad-hoc ``time()`` bracketing with print
deltas scattered through every script (``Match.py:315-356``,
``PoseEstimation.py:237-270``, ``BatchVoxelization.py:105-114``) plus
``.mat`` side files of stats (``Matchablity_*.mat``, ``DebugInfo.mat``).
This module centralizes it:

* ``StageTimer`` — named wall-clock stages with device sync, aggregated
  mean/count, JSON-dumpable;
* ``trace`` — context manager bridging to ``jax.profiler`` traces (view in
  TensorBoard / xprof) and ``jax.profiler.annotate``-style named regions;
* ``MetricsLog`` — append-only JSONL run log (the ``DebugInfo.mat`` /
  ``Matchablity`` analog, but greppable and streaming).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict


class StageTimer:
    """Named stage timing with optional device synchronization."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and block_on is not None:
                import jax

                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def trace(logdir: str | None = None, name: str = "caelo"):
    """Capture a device profile trace (xprof/TensorBoard) around a block.

    With ``logdir=None`` this is a no-op region annotation only.
    """
    import jax

    if logdir:
        jax.profiler.start_trace(logdir)
    try:
        with jax.profiler.TraceAnnotation(name):
            yield
    finally:
        if logdir:
            jax.profiler.stop_trace()


def gpu_name_and_power_limit() -> str:
    """Each card's name and power limit as ``nvidia-smi`` reports them, one
    line per card.  A card set below its maximum power runs slower under a
    matrix-heavy load, so every device number is kept beside this."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


class MetricsLog:
    """Append-only JSONL metrics stream, one record per event."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, event: str, **fields: Any):
        rec = {"t": round(time.time(), 3), "event": event}
        for k, v in fields.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
