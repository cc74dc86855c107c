"""Phase timers and the metric stream of the training loops (counterpart
of `unirenderer_tpu/core/tracing.py` `PhaseTimer` and `MetricLogger`).

`PhaseTimer(device)` sums the wall time of named phases; a phase timed
with `sync=True` waits for the card (`torch.cuda.synchronize`) before it
stops the clock, so it counts the device work it enqueued.
`profile_trace(log_dir)` records a `torch.profiler` trace of its body
(the JAX `profile_trace`, which records a `jax.profiler` trace).
`MetricLogger` writes one JSON line per logged step, and with
`report_to` containing "tensorboard" also TensorBoard scalars (skipped
with a warning when `torch.utils.tensorboard` cannot be imported).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase; JSONL-dumpable."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.device is not None and \
                    self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def dump(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(self.summary()) + "\n")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[Optional[object]]:
    """A `torch.profiler` trace of the body, CPU activity and, where a card
    is present, CUDA activity, written on exit as a Chrome trace
    (`trace-<pid>-<ns>.json`, for chrome://tracing or Perfetto) under
    `log_dir`; yields the profiler.  Nothing is recorded for a `log_dir`
    of None or ""."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class MetricLogger:
    """Structured metric stream: JSONL always, TensorBoard on request."""

    def __init__(self, path: str, report_to=("jsonl",),
                 tb_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._tb = None
        if "tensorboard" in report_to:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(
                    tb_dir or os.path.join(os.path.dirname(path) or ".",
                                           "tensorboard"))
            except ImportError:
                import warnings
                warnings.warn("tensorboard writer unavailable "
                              "(torch.utils.tensorboard import failed); "
                              "logging JSONL only")

    def log(self, step: int, metrics: Dict) -> Dict:
        """One record {step, time, metric: float}; tensors are read here
        (one host copy each).  Returns the record."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))
        return rec

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
