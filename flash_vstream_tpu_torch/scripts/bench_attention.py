"""Flash-attention microbenchmark on the card: K1's forward and K3 + K4 +
K5's forward+backward in TFLOP/s, beside torch's SDPA on the same shapes.

Counterpart of scripts/bench_attention.py. The JAX script's comparison,
jax's shipped TPU flash kernel, becomes SDPA
(`F.scaled_dot_product_attention`, causal, GQA), a library kernel timed
here only. Each form runs as a chained loop of --iters calls, each call's q
moved by the previous output (q + o x 1e-6), so no call can be skipped or
reordered: the forward by CUDA-graph replay between CUDA events
(scripts/timing.py), the forward+backward (autograd through the
port's FlashAttentionFunction, dq, dk, dv) eagerly between CUDA events;
best of --trials, with the worst trial's rate beside it as the spread. A
calibration matmul, [8192 x 8192] @ [8192 x 8192] in bf16 chained the same
way, reads what the card sustained in the same process.

FLOPs as the JAX script counts them: causal forward 2 x 2 x B H S^2 D / 2,
the backward 2.5 x that. Prints one JSON line (metric
`torch_flash_attention_tflops`) with the card's name and power limit. On
the CPU (--device cpu) the wrappers run their plain versions and every
rate is the host's.

Usage: python -m flash_vstream_tpu_torch.scripts.bench_attention
           [--seq 8192] [--heads 32] [--kv-heads 32] [--dim 128]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.flash_attention import flash_attention
from .timing import card_line, eager_seconds, graph_seconds


def _rates(loop, device, trials, flops, iters, graph):
    """(best, worst) TFLOP/s of `loop` (`iters` calls) over `trials`."""
    runs = []
    for _ in range(trials):
        t = (graph_seconds(loop, device, 1) if graph and device.type == "cuda"
             else eager_seconds(loop, device, 1))
        runs.append(t / iters)
    return flops / min(runs) / 1e12, flops / max(runs) / 1e12


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=None)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--calib-size", type=int, default=8192,
                    help="side of the calibration matmul")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    B, S, H, D = args.batch, args.seq, args.heads, args.dim
    Hkv = args.kv_heads or H
    flops_fwd = 2 * 2 * B * H * S * S * D / 2
    flops_bwd = 2.5 * flops_fwd
    g = torch.Generator(device=device).manual_seed(0)
    q0, k0, v0 = (torch.randn((B, h, S, D), generator=g, device=device,
                              dtype=torch.bfloat16) for h in (H, Hkv, Hkv))

    def ours(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=Hkv != H)

    def fwd_loop(attn):
        def loop():
            q = q0
            for _ in range(args.iters):
                q = q + attn(q, k0, v0) * 1e-6
            return q[0, 0, 0, 0].float()
        return loop

    def fwdbwd_loop(attn):
        def loop():
            q = q0
            for _ in range(args.iters):
                qg, kg, vg = (x.detach().requires_grad_()
                              for x in (q, k0, v0))
                out = attn(qg, kg, vg).float().sum()
                dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg))
                q = (q + dq * 1e-6).detach()
            return q[0, 0, 0, 0].float()
        return loop

    res = {}
    for name, attn in (("k1", ours), ("sdpa", sdpa)):
        res[f"{name}_fwd"] = _rates(fwd_loop(attn), device, args.trials,
                                    flops_fwd, args.iters, graph=True)
        res[f"{name}_fwd_bwd"] = _rates(
            fwdbwd_loop(attn), device, args.trials, flops_fwd + flops_bwd,
            args.iters, graph=False)
        print(f"{name:5s} fwd {res[f'{name}_fwd'][0]:7.1f} TF/s  fwd+bwd "
              f"{res[f'{name}_fwd_bwd'][0]:7.1f} TF/s", file=sys.stderr,
              flush=True)

    m = args.calib_size
    a0 = torch.randn((m, m), generator=g, device=device, dtype=torch.bfloat16)
    w0 = torch.randn((m, m), generator=g, device=device,
                     dtype=torch.bfloat16) * 0.01

    def mm():
        a = a0
        for _ in range(args.iters):
            a = (a @ w0) * 0.01
        return a[0, 0].float()
    calib, _ = _rates(mm, device, args.trials, 2 * m ** 3, args.iters,
                      graph=True)
    out = {
        "metric": "torch_flash_attention_tflops",
        "device": card_line(device),
        "shape": f"B{B} H{H}/{Hkv} S{S} D{D} bf16 causal",
        "fwd_tflops": res["k1_fwd"][0],
        "fwd_bwd_tflops": res["k1_fwd_bwd"][0],
        "fwd_tflops_worst_trial": res["k1_fwd"][1],
        "sdpa_fwd_tflops": res["sdpa_fwd"][0],
        "sdpa_fwd_bwd_tflops": res["sdpa_fwd_bwd"][0],
        "matmul_calibration_tflops": calib,
        "method": ("chained loop; forward by CUDA-graph replay, "
                   "forward+backward eager between CUDA events; best of "
                   f"{args.trials} trials"),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
