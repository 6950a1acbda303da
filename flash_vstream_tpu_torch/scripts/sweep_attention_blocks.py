"""Launch-plan sweep of K1's forward on the card.

Counterpart of scripts/sweep_attention_blocks.py, which swept the Pallas
kernel's (block_q, block_kv). K1's key tile is fixed at 64 keys
(kernels/flash_attention.py BLOCK_N, its ring in shared memory); what a
launch chooses is the q rows per block, 16 a warp (`FwdPlan`,
`_launch_plan`): each of ROWS_PER_BLOCK forced in turn, and the plan's
own choice, timed as bench_attention.py times K1 (a chained loop of
--iters calls, CUDA-graph replay, best of --trials). The output is the
same bit for bit at every plan (tests/test_torch_flash_attention.py).

Prints a line a plan (rows, blocks, shared bytes, TF/s) and one JSON line
(metric `torch_flash_attention_fwd_plan_sweep`) with the card's name and
power limit. On the CPU (--device cpu) there is no kernel: each plan is
printed with the plain version's host time, the same for every plan.

Usage: python -m flash_vstream_tpu_torch.scripts.sweep_attention_blocks
           [--seq 8192] [--heads 32] [--dim 128] [--rows 16,32,64,128]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.device import resolve_device
from ..kernels import flash_attention as fa
from .timing import card_line, eager_seconds, graph_seconds


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--rows", type=str,
                    default=",".join(map(str, fa.ROWS_PER_BLOCK)),
                    help="q rows per block to force, comma list")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    B, S, H, D = args.batch, args.seq, args.heads, args.dim
    flops = 2 * 2 * B * H * S * S * D / 2
    g = torch.Generator(device=device).manual_seed(0)
    q0, k0, v0 = (torch.randn((B, H, S, D), generator=g, device=device,
                              dtype=torch.bfloat16) for _ in range(3))
    own = fa._launch_plan(B, H, S, D)
    plans = [(f"{r}", int(r)) for r in args.rows.split(",")]
    plans.append((f"plan({own.rows_per_block})", None))

    def run(q, rows):
        if device.type != "cuda":
            return fa.flash_attention_reference(q, k0, v0, causal=True)
        return fa._launch_fwd(q, k0, v0, None, True, None, None, None, "K1",
                              rows_per_block=rows)[0]

    results = {}
    for name, rows in plans:
        plan = fa._launch_plan(B, H, S, D, rows)

        def loop(rows=rows):
            q = q0
            for _ in range(args.iters):
                q = q + run(q, rows) * 1e-6
            return q[0, 0, 0, 0].float()
        timer = graph_seconds if device.type == "cuda" else eager_seconds
        dt = timer(loop, device, args.trials) / args.iters
        tf = flops / dt / 1e12
        results[name] = {"rows_per_block": plan.rows_per_block,
                         "blocks": plan.blocks, "smem_bytes": plan.smem_bytes,
                         "ms": dt * 1e3, "tflops": tf}
        print(f"rows per block {name:>10s}: {plan.blocks:6d} blocks "
              f"{plan.smem_bytes:6d} B shared -> {dt * 1e3:8.3f} ms "
              f"{tf:6.1f} TF/s", file=sys.stderr, flush=True)
    out = {"metric": "torch_flash_attention_fwd_plan_sweep",
           "device": card_line(device),
           "shape": f"B{B} H{H} S{S} D{D} bf16 causal", "plans": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
