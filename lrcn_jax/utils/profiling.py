"""Profiling and step timing.

The reference has no tracing/profiling at all — only progress prints and a
``cudaDeviceSynchronize`` before returning from training (lrcn.jl:241,
381-385; SURVEY.md §5).  This module provides:

- ``trace(logdir)``: context manager around ``jax.profiler`` producing
  XPlane traces viewable in TensorBoard/XProf;
- ``StepTimer``: wall-clock step statistics that wait for the device
  with ``jax.block_until_ready`` at the measurement edges.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace for the enclosed block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time_ms(trace_dir: str) -> float:
    """Total device-busy milliseconds recorded in a profiler trace.

    Parses the trace's ``XLA Modules`` track — the sum of executed XLA
    program durations on the device timeline.  This is THE reliable
    device-time measurement on runtimes where per-dispatch host overhead
    dwarfs kernels (wall clock) and where other tracks double-count or
    span idle gaps (summing every device event overstates; the 'Steps'
    track spans idle time).  Returns 0.0 when no trace file is found.

    Usage::

        with trace("/tmp/t"):
            jax.block_until_ready(run())
        ms = device_time_ms("/tmp/t")
    """
    import glob
    import gzip
    import json

    files = sorted(glob.glob(f"{trace_dir}/**/*.trace.json.gz",
                             recursive=True))
    if not files:
        return 0.0
    with gzip.open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    thread_names = {}
    for e in events:
        if (e.get("ph") == "M" and "pid" in e
                and e.get("name") == "thread_name"):
            thread_names[(e["pid"], e.get("tid"))] = e["args"].get("name")
    def track_total(pred) -> float:
        return sum(
            e.get("dur", 0) for e in events
            if e.get("ph") == "X" and "pid" in e
            and pred(thread_names.get((e["pid"], e.get("tid")))))

    total_us = track_total(lambda n: n == "XLA Modules")
    if total_us == 0.0:
        # CPU traces have no 'XLA Modules' track; approximate with the
        # XLA client execution threads (tests run on the CPU backend)
        total_us = track_total(
            lambda n: bool(n) and n.startswith("tf_XLA"))
    return total_us / 1e3


def measure_device_time_ms(fn, *args, iters: int = 3,
                           trace_dir: str | None = None) -> float:
    """Device-time per call of an already-compiled jitted ``fn`` in ms.

    Warm up (and compile) first; this traces ``iters`` back-to-back calls
    and divides the device-busy total.
    """
    import tempfile

    logdir = trace_dir or tempfile.mkdtemp(prefix="lrcn_trace_")
    jax.block_until_ready(fn(*args))   # compile + warm up outside the trace
    with trace(logdir):
        out = None
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
    return device_time_ms(logdir) / iters


@dataclass
class StepTimer:
    """Accumulates per-step wall times; sync only at measurement edges."""

    _times: list = field(default_factory=list)
    _t0: float | None = None

    def start(self, outputs=None) -> None:
        if outputs is not None:
            jax.block_until_ready(outputs)
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        if outputs is not None:
            jax.block_until_ready(outputs)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self._t0 = None
        return dt

    @property
    def count(self) -> int:
        return len(self._times)

    def mean(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self._times, p)) if self._times else 0.0

    def throughput(self, items_per_step: int) -> float:
        m = self.mean()
        return items_per_step / m if m else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.count,
            "mean_s": round(self.mean(), 6),
            "p50_s": round(self.percentile(50), 6),
            "p95_s": round(self.percentile(95), 6),
        }
