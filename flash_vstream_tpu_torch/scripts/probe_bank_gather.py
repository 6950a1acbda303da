"""Probe: the DAM frame gather (spa_x = bank[idx]) by four routes on the card.

Port of scripts/probe_bank_gather.py. Routes (`MODES`):
  xla     bank.index_select(0, idx), PyTorch's own gather (the JAX probe's
          `bank[idx]`)
  onehot  one_hot(idx) @ bank.reshape(T, -1): reads the WHOLE bank, on the
          tensor cores (a plain torch.matmul)
  k2      the CUDA kernel K2 (kernels/gather_rows.py): a vector copy through
          the threads' registers
  bulk    the CUDA kernel P1 (kernels/bank_gather.py), the port of the JAX
          probe's `pallas` route: each row streams through shared memory by
          bulk (TMA) copies, the TPU's one DMA per row
Each route runs as a chained loop of --iters gathers with fresh indices per
iteration ((arange(K) * 7 + i) % T) and state carried across iterations,
timed by CUDA-graph replay, best of 4 (scripts/timing.py). On the CPU
(--device cpu, at small sizes) k2 and bulk take their kernels' plain
versions.

Usage: python -m flash_vstream_tpu_torch.scripts.probe_bank_gather
           [--t 1024] [--k 30] [--p 256] [--d 1280] [--iters 50]
           [--dtype bfloat16] [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.bank_gather import bank_gather
from ..kernels.gather_rows import gather_rows
from .timing import graph_seconds

TRIALS = 4


def gather_xla(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return bank.index_select(0, idx)


def gather_onehot(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """one_hot(idx) [K, T] @ bank [T, P*D], one rounding of the f32 sums to
    the bank's dtype (exact: one term per output)."""
    T, P, D = bank.shape
    oh = F.one_hot(idx.long(), T).to(bank.dtype)
    return torch.matmul(oh, bank.reshape(T, P * D)).reshape(-1, P, D)


MODES: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "xla": gather_xla,
    "onehot": gather_onehot,
    "k2": gather_rows,
    "bulk": bank_gather,
}


def chained_loop(fn, bank: torch.Tensor, k: int, iters: int):
    """The probe's chain: `iters` gathers of k rows with fresh indices, each
    output's first element summed into the carried state."""
    T = bank.shape[0]

    def loop() -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32, device=bank.device)
        for i in range(iters):
            idx = (torch.arange(k, dtype=torch.int32, device=bank.device) * 7
                   + i) % T
            acc = acc + fn(bank, idx).reshape(-1)[0].float()
        return acc
    return loop


def make_bank(t: int, p: int, d: int, dtype: torch.dtype,
              device: torch.device, seed: int = 0) -> torch.Tensor:
    """N(0, 1) bank [t, p, d] in `dtype`, drawn on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(t, p, d, generator=g, device=device).to(dtype)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--t", type=int, default=1024)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--p", type=int, default=256)
    ap.add_argument("--d", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Runs the routes, prints one line each; returns {mode: seconds per
    gather}."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    T, K = args.t, args.k
    dtype = getattr(torch, args.dtype)
    bank = make_bank(T, args.p, args.d, dtype, device)
    nbytes = K * args.p * args.d * bank.element_size()
    results = {}
    for mode, fn in MODES.items():
        loop = chained_loop(fn, bank, K, args.iters)
        dt = graph_seconds(loop, device, TRIALS) / args.iters
        results[mode] = dt
        print(f"{mode:10s} {dt * 1e3:7.3f} ms   {nbytes / dt / 1e9:7.1f} GB/s "
              f"gathered ({nbytes / 1e6:.1f} MB)", flush=True)
    return results


if __name__ == "__main__":
    main()
