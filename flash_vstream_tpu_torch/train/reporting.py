"""Training observability: a JSONL scalars stream and a profiler window.

Port of flash_vstream_tpu/train/reporting.py: every step appends one JSON
line (step, loss, lr, step_time_s, ...), and `StepProfiler` records a
torch.profiler trace (CPU and CUDA activity, a Chrome trace per window)
over a window of steps.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Optional


def lr_at(cfg, step: int, lr: Optional[float] = None) -> float:
    """The learning rate of optimizer step `step` (0-based): linear warmup
    from 0 over max(int(total * warmup_ratio), 1) steps, then cosine decay
    to 0 (optax's join of linear_schedule and cosine_decay_schedule,
    evaluated at the count before the step, so step 0 runs at lr 0)."""
    lr = lr if lr is not None else cfg.learning_rate
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    if step < warmup:
        return lr * step / warmup
    decay = max(cfg.total_steps - warmup, 1)
    t = min(step - warmup, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))


class ScalarsWriter:
    """Append-mode JSONL scalars stream; one line per step."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, step: int, **scalars):
        rec = {"step": step, "time": round(time.time(), 3)}
        rec.update({k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class StepProfiler:
    """torch.profiler trace over steps [start + 1, start + n_steps]: the first
    step after a (re)start is skipped (it pays the kernel build and
    allocator warm-up). The trace lands in `trace_dir` as a Chrome trace."""

    def __init__(self, trace_dir: Optional[str], start_step: int,
                 n_steps: int = 3):
        self.trace_dir = trace_dir
        self.first = start_step + 1
        self.last = self.first + max(n_steps, 1) - 1
        self._prof = None

    def before_step(self, step: int):
        if self.trace_dir and self._prof is None and step == self.first:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def after_step(self, step: int):
        if self._prof is not None and step >= self.last:
            self.close()

    def close(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"trace_steps_{self.first}-{self.last}.json"))
            self.profile = prof
