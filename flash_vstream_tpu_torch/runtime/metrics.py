"""Latency metering: a copy of `AverageMeter`, `MetricMeter` and `Timer`
(flash_vstream_tpu/runtime/metrics.py:41-105), so the port imports nothing
of the JAX package. The JAX module's completion fence and profiler wrapper
work around its remote-dispatch runtime and have no counterpart here.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class AverageMeter:
    """Thread-safe: the same meter may be fed from an ingest thread and an
    answer thread."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.max = float("-inf")
        self.count = 0

    def update(self, val: float, n: int = 1):
        with self._lock:
            self.val = val
            self.sum += val * n
            self.count += n
            self.avg = self.sum / max(self.count, 1)
            self.max = max(self.max, val)

    def __str__(self):
        return f"{self.name} val={self.val:.4f} avg={self.avg:.4f} max={self.max:.4f}"


class MetricMeter:
    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}
        self._lock = threading.Lock()

    def update(self, name: str, val: float, n: int = 1):
        with self._lock:
            meter = self.meters.get(name)
            if meter is None:
                meter = self.meters[name] = AverageMeter(name)
        meter.update(val, n)

    def get(self, name: str) -> Optional[AverageMeter]:
        return self.meters.get(name)

    def summary(self) -> str:
        return "\n".join(str(m) for m in self.meters.values())

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"val": m.val, "avg": m.avg, "max": m.max, "count": m.count}
                for k, m in self.meters.items()}


class Timer:
    """Context manager feeding a MetricMeter series."""

    def __init__(self, meter: MetricMeter, name: str):
        self.meter = meter
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.meter.update(self.name, time.perf_counter() - self.t0)
        return False
