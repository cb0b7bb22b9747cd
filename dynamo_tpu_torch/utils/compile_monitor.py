"""Capture telemetry: count CUDA graph captures and their seconds (port of
``dynamo_tpu/utils/compile_monitor.py`` ``CompileMonitor``).

The reference counts XLA compiles of its jitted step functions; the port's
counterpart of a compile is the capture of a step body into a CUDA graph
(``engine/graphs.py``): an eager run of the body and its capture, a stall of
the same kind that a request arriving at a new shape feels. The counters
(count, cumulative seconds, the last capture's label and age, captures per
label) keep the reference's names, so a capture in the middle of serving
shows up as a climbing count, not as unexplained latency. The reference's
``monitored_jit`` wrapper has no counterpart: the graph cache charges each
capture itself.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("utils.compile_monitor")


class CompileMonitor:
    """Shared capture telemetry for one runner's step graphs."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_s = 0.0
        self.last_label: Optional[str] = None
        self.last_ts: Optional[float] = None
        self.per_label: dict[str, int] = {}

    def record(self, label: str, seconds: float, count: int = 1) -> None:
        with self._lock:
            self.compiles += count
            self.compile_s += seconds
            self.last_label = label
            self.last_ts = self._clock()
            self.per_label[label] = self.per_label.get(label, 0) + count
        if seconds > 1.0:
            log.info("graph capture: %s took %.2fs (%d total)", label, seconds, self.compiles)

    def snapshot(self) -> dict:
        with self._lock:
            age = round(self._clock() - self.last_ts, 3) if self.last_ts is not None else None
            return {
                "compiles": self.compiles,
                "compile_s": round(self.compile_s, 4),
                "last_label": self.last_label,
                "last_compile_age_s": age,
                "per_label": dict(self.per_label),
            }
