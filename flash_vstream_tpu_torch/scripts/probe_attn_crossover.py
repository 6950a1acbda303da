"""Probe: where K1 starts to beat the plain attention on the card.

Counterpart of scripts/probe_attn_crossover.py, which timed the Pallas
kernel against XLA's attention per (S, D, causal) to set the JAX
dispatch's `worth_fusing = S >= 512` (flash_vstream_tpu/kernels/
flash_attention.py:538). Here K1 (`flash_attention_cuda`) against the
port's plain version (`flash_attention_reference`, f32 scores in torch
ops) at the JAX script's cases: the Qwen ViT's frames, CLIP's, long
encodes and the causal prefill. Each runs as a chained loop of --iters
calls over two input sets (fresh inputs, the previous output carried into
q), by CUDA-graph replay, best of --trials.

Prints a line a case (us a call and TF/s of each), then for each (D,
causal) the smallest S at which K1 is faster (the port's crossover; the
port's dispatch runs K1 at every S on the card), and one JSON line (metric
`torch_attention_crossover`) with the card's name and power limit. On
the CPU (--device cpu) both forms are the plain version and every time is
the host's.

Usage: python -m flash_vstream_tpu_torch.scripts.probe_attn_crossover
           [--iters 50] [--cases B:H:S:D:causal,...]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.device import resolve_device
from ..kernels import flash_attention as fa
from .timing import card_line, eager_seconds, graph_seconds

# (B, H, S, D, causal): Qwen ViT frames, CLIP frames, long encodes, the
# causal prefill (the JAX script's cases)
CASES = ((4, 16, 64, 80, False), (4, 16, 256, 80, False),
         (8, 16, 640, 64, False), (4, 16, 1024, 80, False),
         (2, 16, 2048, 80, False), (1, 32, 2048, 128, True),
         (1, 32, 4096, 128, True))
JAX_CROSSOVER_S = 512


def _parse(spec: str):
    out = []
    for c in spec.split(","):
        B, H, S, D, causal = c.split(":")
        out.append((int(B), int(H), int(S), int(D), causal in ("1", "c",
                                                              "True")))
    return tuple(out)


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--cases", type=str, default=None,
                    help="B:H:S:D:causal,... (default: the JAX script's)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    cases = _parse(args.cases) if args.cases else CASES
    g = torch.Generator(device=device).manual_seed(0)
    kernel = (fa.flash_attention_cuda if device.type == "cuda"
              else fa.flash_attention_reference)
    timer = graph_seconds if device.type == "cuda" else eager_seconds
    results, wins = {}, {}
    for B, H, S, D, causal in cases:
        q, k, v = (torch.randn((2, B, H, S, D), generator=g, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        flops = 2 * 2 * B * H * S * S * D * (0.5 if causal else 1.0)
        tag = f"B{B}xH{H}xS{S}xD{D}{'c' if causal else ''}"
        us = {}
        for name, fn in (("k1", kernel), ("plain",
                                          fa.flash_attention_reference)):
            def loop(fn=fn):
                acc = torch.zeros((), device=device)
                for i in range(args.iters):
                    out = fn(q[i % 2] + acc.to(torch.bfloat16), k[i % 2],
                             v[i % 2], causal=causal)
                    acc = out[0, 0, 0, 0].float()
                return acc
            dt = timer(loop, device, args.trials) / args.iters
            us[name] = dt * 1e6
            results[f"{tag}:{name}"] = dt * 1e6
            print(f"{tag:24s} {name:6s} {dt * 1e6:9.1f} us "
                  f"{flops / dt / 1e12:6.1f} TF/s", file=sys.stderr,
                  flush=True)
        wins.setdefault((D, causal), []).append((S, us["k1"] < us["plain"]))
    crossover = {}
    for (D, causal), rows in sorted(wins.items()):
        won = [S for S, w in sorted(rows) if w]
        crossover[f"D{D}{'c' if causal else ''}"] = min(won) if won else None
        print(f"D{D} {'causal' if causal else 'full'}: K1 faster from S "
              f"{min(won) if won else 'never (at these S)'} (JAX dispatch: "
              f"S >= {JAX_CROSSOVER_S})", file=sys.stderr, flush=True)
    out = {"metric": "torch_attention_crossover", "device": card_line(device),
           "us": results, "k1_faster_from_s": crossover,
           "jax_worth_fusing_s": JAX_CROSSOVER_S}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
