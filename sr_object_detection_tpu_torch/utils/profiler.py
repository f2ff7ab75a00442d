"""Tracing / profiling harness.

Counterpart of ``sr_object_detection_tpu/utils/profiler.py``. The
reference has only printf wall-clocks (SURVEY §5.1: sec() around data
loading/steps, the 'speed' command, demo FPS counter). Here:

  * :class:`StepTimer` — EMA'd phase timers for train loops (load /
    step / total), the structured version of detector.c:110-149's
    printfs (copied as it is);
  * :func:`trace` — context manager around ``torch.profiler`` that
    writes a Chrome trace (viewable in Perfetto or chrome://tracing);
  * :func:`mfu` — model FLOPs utilization from the analytic FLOPs
    ('ops' command formula) and measured step time, against the H100's
    dense peaks (:data:`H100_PEAK_FLOPS`);
  * :class:`MetricsLog` — JSON-lines metrics sink (the structured
    replacement for stdout loss lines; copied as it is).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


# dense peak FLOP/s of one H100 SXM by operand type: bf16 on the tensor
# cores, and float32 on the FP32 cores (TF32 off, as the port's float32
# paths run)
H100_PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float32": 67e12,
}


class StepTimer:
    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: dict[str, float] = {}
        self._open: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            prev = self.ema.get(name)
            self.ema[name] = dt if prev is None else \
                (1 - self.alpha) * prev + self.alpha * dt

    def summary(self) -> str:
        return " ".join(f"{k}={v*1e3:.1f}ms" for k, v in self.ema.items())


@contextlib.contextmanager
def trace(logdir: str = "sr_trace"):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a
    device is present) and write its Chrome trace to
    ``<logdir>/trace.json``: ``with profiler.trace(d) as prof:
    step(...)``. Yields the profiler (``prof.key_averages()``)."""
    from torch import profiler as tp
    import torch
    acts = [tp.ProfilerActivity.CPU] + (
        [tp.ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with tp.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def mfu(flops_per_step: float, step_seconds: float,
        dtype: str = "float32") -> float:
    """Model FLOPs utilization against the H100's dense peak for
    ``dtype`` ("float32" or "bfloat16")."""
    return flops_per_step / step_seconds / H100_PEAK_FLOPS[dtype]


def train_flops(spec, backward_multiplier: float = 3.0) -> float:
    """Per-image training FLOPs: forward + ~2x for backward."""
    from ..infer.engine import analytic_flops
    return analytic_flops(spec) * backward_multiplier


class MetricsLog:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.rows: list[dict] = []

    def log(self, step: int, **metrics):
        row = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                else v) for k, v in metrics.items()}}
        self.rows.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row


__all__ = ["StepTimer", "trace", "mfu", "train_flops", "MetricsLog",
           "H100_PEAK_FLOPS"]
