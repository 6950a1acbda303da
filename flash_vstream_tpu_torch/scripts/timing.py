"""Timing of a chained loop, the port's counterpart of the JAX probes'
scan-in-jit timing.

`loop()` runs the whole chain (fresh inputs each iteration, state carried
across iterations) and returns the carried state as a tensor. On the card
it is captured once into a CUDA graph and each trial replays the graph
between CUDA events: device time, without the host's launch cost, as the
compiled scan gives it on the TPU. `eager_seconds` times the same loop run
eagerly between CUDA events, where the host's launch rate shows. On the
CPU both run eagerly under the host clock. Every timing forces completion
by reading the carried state. `card_line` names what a figure was
measured on.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def graph_seconds(loop: Callable[[], torch.Tensor], device: torch.device,
                  trials: int) -> float:
    """Best of `trials` runs of `loop` in seconds (graph replay on the
    card, after one eager warm-up run that builds the kernels)."""
    float(loop())
    if device.type != "cuda":
        return eager_seconds(loop, device, trials)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        state = loop()
    best = float("inf")
    for _ in range(trials):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / 1e3)
    float(state)
    del graph
    return best


def eager_seconds(loop: Callable[[], torch.Tensor], device: torch.device,
                  trials: int) -> float:
    """Best of `trials` eager runs of `loop` in seconds: between CUDA events
    on the card, under the host clock on the CPU."""
    best = float("inf")
    for _ in range(trials):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state = loop()
            e1.record()
            float(state)
            best = min(best, e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            float(loop())
            best = min(best, time.perf_counter() - t0)
    return best


def card_line(device: torch.device) -> str:
    """What a figure was measured on: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (a card below its 700 W limit runs slower under load), or the CPU,
    whose times are the host's and no device's."""
    if device.type != "cuda":
        return "cpu (no card: every time below is the host's)"
    import subprocess
    idx = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or f"{torch.cuda.get_device_name(device)}, power limit unread"
