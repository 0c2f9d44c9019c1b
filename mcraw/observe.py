"""Observability: structured logging, per-stage timing, profiler hooks.

The reference has no tracing or metrics (SURVEY.md §5 — its only output is
CLI prints, example.cpp:163,192). This module provides the framework-level
replacements: a stage timer that aggregates parse / H2D / unpack / emit
costs, a frames-per-second counter, structured log records, and an optional
``jax.profiler`` trace context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

logger = logging.getLogger("mcraw")


def log_event(event: str, **fields) -> None:
    """Structured (JSON-line) log record."""
    logger.info("%s", json.dumps({"event": event, **fields}, default=str))


@dataclass
class StageTimer:
    """Aggregates wall time per pipeline stage.

    >>> t = StageTimer()
    >>> with t.stage("parse"): ...
    >>> t.summary()  # {'parse': {'seconds': ..., 'count': 1}}
    """

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    # Stages run on thread pools (export_clip's prep/write workers);
    # += on the dicts is a read-modify-write that needs the lock.
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"seconds": round(self.totals[k], 6), "count": self.counts[k]}
            for k in sorted(self.totals)
        }

    def log(self) -> None:
        log_event("stage_timing", **self.summary())


@dataclass
class Throughput:
    """North-star counter: frames (and bytes) per second per chip."""

    frames: int = 0
    in_bytes: int = 0
    out_bytes: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, frames: int = 1, in_bytes: int = 0, out_bytes: int = 0):
        self.frames += frames
        self.in_bytes += in_bytes
        self.out_bytes += out_bytes

    def summary(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "frames": self.frames,
            "fps": round(self.frames / dt, 2),
            "in_GBps": round(self.in_bytes / dt / 1e9, 3),
            "out_GBps": round(self.out_bytes / dt / 1e9, 3),
        }


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """jax.profiler trace context (no-op when trace_dir is None)."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
