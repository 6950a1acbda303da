"""Decode-shape matvec roofline probe: int8 `QuantWeight` against bf16
weights, on the card.

Counterpart of scripts/bench_int8_matvec.py. Times x [--rows, din] @ W at
the Qwen2-7B decoder's shapes (hidden 3,584, MLP 18,944: the fused qkvo,
gate_up and down) through `models/layers.dense`: (a) bf16 weights, (b)
int8 weights (int8 values cast to x's dtype, the per-channel scale on the
output). Each as a chained loop of --iters calls over 4 fresh x (the
previous output's first element carried in), by CUDA-graph replay between
CUDA events (scripts/timing.py), best of --trials; achieved GB/s of the
stored weight bytes against the H100's 3.35 TB/s (the JAX script read
the v5e's 819 GB/s). An int8 time above half the bf16 time shows that the
cast materializes a bf16 copy.

Prints a line a shape and format and one JSON line (metric
`torch_int8_matvec`) with the card's name and power limit. On the CPU
(--device cpu, small --dims) every time is the host's.

Usage: python -m flash_vstream_tpu_torch.scripts.bench_int8_matvec
           [--iters 50] [--rows 8]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.device import resolve_device
from ..models.layers import dense
from ..weights.quantize import quantize_weight
from .timing import card_line, eager_seconds, graph_seconds

H100_HBM_GBS = 3350.0
# Qwen2-7B decoder matvec shapes (hidden 3584, mlp 18944)
SHAPES = (("qkvo", 3584, 3584 + 2 * 512 + 3584),
          ("gate_up", 3584, 2 * 18944),
          ("down", 18944, 3584))


def chained_seconds(fn, xs, iters, trials, device) -> float:
    """Seconds a call of fn(x) over a chained loop of `iters` calls."""
    def loop():
        acc = torch.zeros((), device=device)
        for i in range(iters):
            out = fn(xs[i % xs.shape[0]] + acc.to(xs.dtype))
            acc = out.reshape(-1)[0].float() * 1e-6
        return acc
    timer = graph_seconds if device.type == "cuda" else eager_seconds
    return timer(loop, device, trials) / iters


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--dims", type=str, default=None,
                    help="name:din:dout,... in place of the 7B shapes")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    shapes = SHAPES if args.dims is None else tuple(
        (n, int(a), int(b)) for n, a, b in
        (s.split(":") for s in args.dims.split(",")))
    print(f"device: {card_line(device)}", file=sys.stderr)
    g = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, din, dout in shapes:
        w16 = (torch.randn((din, dout), generator=g, device=device)
               * 0.02).to(torch.bfloat16)
        wq = quantize_weight(w16)
        xs = torch.randn((4, args.rows, din), generator=g, device=device,
                         dtype=torch.bfloat16)
        row = {}
        for fmt, w, nbytes in (("bf16", w16, 2 * din * dout),
                               ("int8", wq, din * dout)):
            dt = chained_seconds(lambda x, w=w: dense(x, w), xs, args.iters,
                                 args.trials, device)
            gbs = nbytes / dt / 1e9
            row[f"{fmt}_us"] = dt * 1e6
            row[f"{fmt}_gbs"] = gbs
            row[f"{fmt}_share_of_hbm"] = (gbs / H100_HBM_GBS
                                          if device.type == "cuda" else None)
            print(f"{name} {fmt} [{din}x{dout}] {dt * 1e6:9.1f} us "
                  f"{gbs:7.0f} GB/s ({gbs / H100_HBM_GBS:.2f} of 3.35 TB/s)",
                  file=sys.stderr, flush=True)
        row["speedup"] = row["bf16_us"] / row["int8_us"]
        results[name] = row
        del w16, wq
    out = {"metric": "torch_int8_matvec", "device": card_line(device),
           "rows": args.rows, **results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
