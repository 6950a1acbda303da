"""Probe: decode-matvec bandwidth by weight format at the Qwen2-VL-7B
decode shape, on the card.

Counterpart of scripts/probe_int4_matvec.py. A chained matvec x [1, din]
through `--layers` stacked weights of [din, dout] (each layer's output
folded back into x, so every call depends on the one before), repeated
--iters times: every weight is read from memory once a pass, and the
stack (16 x 67.9 MB of bf16 at the default shape) far exceeds the card's
50 MB L2. Formats: bf16 (`torch.matmul`), int8 (values cast in the feed,
the per-channel scale on the output), packed int4 dequantized to bf16 and
multiplied (`dequantize_weight4`, the path off the K6 gate), packed int4
through K6 (`int4_matmul_cuda`, the port's kernel) and torch's
`_weight_int4pack_mm` on the same weights (a library kernel, timed only).
The JAX script's native-int4 row has no torch counterpart and is left out.

Timed by CUDA-graph replay between CUDA events (scripts/timing.py), best
of --trials. Prints a line a format (ms a matvec, GB/s of the stored
weight bytes and its share of the H100's 3.35 TB/s) and one JSON line
(metric `torch_int4_matvec`) with the card's name and power limit. On the
CPU (--device cpu, small dims) K6 and the library's row are skipped and
every time is the host's.

Usage: python -m flash_vstream_tpu_torch.scripts.probe_int4_matvec
           [--trials 4] [--iters 50] [--din 3584] [--dout 18944]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.device import resolve_device
from ..kernels.int4_matmul import int4_matmul_cuda
from ..weights.quantize import QuantWeight4, dequantize_weight4
from .timing import card_line, eager_seconds, graph_seconds

H100_HBM_GBS = 3350.0


def int4pack(q4: torch.Tensor, scale: torch.Tensor):
    """torch's int4 layout of a packed `QuantWeight4` (groups of din / nb
    along din, (u - 8) x scale): (packed, group, scales_and_zeros)."""
    u = torch.cat([q4 & 0xF, q4 >> 4]).T.contiguous()          # [dout, din]
    packed = torch._convert_weight_to_int4pack(
        ((u[:, ::2] << 4) | u[:, 1::2]).contiguous(), 8)
    group = u.shape[1] // scale.shape[0]
    sz = torch.stack([scale, torch.zeros_like(scale)],
                     dim=-1).to(torch.bfloat16).contiguous()
    return packed, group, sz


def bench_one(name, ws, matvec, din, iters, trials, device, stored):
    """ms a matvec and GB/s of `stored` bytes a pass."""
    x0 = torch.ones((1, din), device=device, dtype=torch.bfloat16)

    def loop():
        x = x0
        for _ in range(iters):
            for w in ws:
                y = matvec(x, w)
                x = (x + y[:, :din].to(x.dtype) * 1e-6).to(torch.bfloat16)
        return x.float().sum()
    timer = graph_seconds if device.type == "cuda" else eager_seconds
    best = timer(loop, device, trials)
    ms = best / (iters * len(ws)) * 1e3
    gbs = stored * iters / best / 1e9
    print(f"{name:30s} {ms:7.3f} ms/matvec {gbs:8.1f} GB/s stored-weight "
          f"({gbs / H100_HBM_GBS:.2f} of 3.35 TB/s; {stored / 1e6:.1f} MB "
          f"stacked x{len(ws)})", file=sys.stderr, flush=True)
    return {"ms": ms, "gbs": gbs, "share_of_hbm": (
        gbs / H100_HBM_GBS if device.type == "cuda" else None)}


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--din", type=int, default=3584)
    ap.add_argument("--dout", type=int, default=18944)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    din, dout, L = args.din, args.dout, args.layers
    nb = max(din // 128, 2)
    g = torch.Generator(device=device).manual_seed(0)
    print(f"device: {card_line(device)}", file=sys.stderr)
    print(f"matvec [1,{din}] @ [{din},{dout}]", file=sys.stderr)
    nbytes = lambda ws: sum(t.numel() * t.element_size() for w in ws
                            for t in (w if isinstance(w, tuple) else (w,)))
    run = lambda name, ws, mv: bench_one(name, ws, mv, din, args.iters,
                                         args.trials, device, nbytes(ws))
    res = {}
    w16 = [torch.randn((din, dout), generator=g, device=device,
                       dtype=torch.bfloat16) for _ in range(L)]
    res["bf16"] = run("bf16", w16, lambda x, w: torch.matmul(x, w))
    del w16
    w8 = [(torch.randint(-127, 127, (din, dout), generator=g, device=device,
                         dtype=torch.int8),
           torch.ones((1, dout), device=device)) for _ in range(L)]
    res["int8"] = run("int8 convert-in-feed", w8,
                      lambda x, w: torch.matmul(x, w[0].to(x.dtype))
                      * w[1].to(x.dtype))
    del w8
    w4 = [(torch.randint(0, 256, (din // 2, dout), generator=g,
                         device=device, dtype=torch.int32).to(torch.uint8),
           torch.ones((nb, dout), device=device) * 0.01) for _ in range(L)]
    res["int4_dequant"] = run(
        "uint8-packed dequant (QW4)", w4,
        lambda x, w: torch.matmul(x, dequantize_weight4(QuantWeight4(*w),
                                                        x.dtype)))
    if device.type == "cuda":
        res["int4_k6"] = run("uint8-packed K6 kernel", w4,
                             lambda x, w: int4_matmul_cuda(x, *w))
        packs = [int4pack(*w) for w in w4]
        stored4 = nbytes(w4)
        lib = bench_one("torch _weight_int4pack_mm", packs,
                        lambda x, p: torch._weight_int4pack_mm(x, *p), din,
                        args.iters, args.trials, device, stored4)
        res["int4_weight_int4pack_mm"] = lib
    out = {"metric": "torch_int4_matvec", "device": card_line(device),
           "shape": [din, dout], "layers": L, **res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
