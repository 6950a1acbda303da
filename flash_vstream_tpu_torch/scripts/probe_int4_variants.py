"""Probe: int4 decode-matvec kernel VARIANTS on the card, to locate the
bottleneck.

Port of scripts/probe_int4_variants.py. Every variant reads the same packed
[din/2, dout] uint8 weight (kernels/int4_variants.py, the CUDA kernels P3
and P4):

  v1-current     unbias per element, f32 partial dots, f32 block scales
  v2-biasfold    the -8 unbias folded into a per-block correction (K6)
  v3-floor       unpack + one plain dot, no scales or bias (wrong math:
                 isolates unpack + dot)
  v4-int8dot     nibbles as int8 lanes, int32 dot products against an
                 int8-quantized x (quantized in the chain, every step),
                 scales on the partials
  v5-u8mask      v2's function, two nibbles converted per 32-bit operation
  v6-bf16dot     a plain bf16 matvec over a [din, dout] bf16 weight
  v7-unpackonly  unpack and column sums alone

Each variant runs the JAX probe's chain: `--iters` passes over 16 stacked
layers, x = bf16(x + y[:, :din] * 1e-6) after every matvec, from x = ones,
timed by CUDA-graph replay of the whole chain, best of `--trials`
(scripts/timing.py). Weights come from a seeded generator on the device:
uniform bytes in [0, 254] (jax.random.randint(k, shape, 0, 255)), scales
1e-3; v6's weight N(0, 1) in bf16. Each line gives ms per matvec and GB/s
of the stored weight (q4 + scale, v6 the bf16 weight). `main` runs v1-v5
(`--only` a substring of the names) and `main2` v6 and v7 (`--which`); the
command line takes `main2` when it holds `--which`, as the JAX script's
last lines intend (there `main()` runs first and refuses `--which`). A
variant that fails raises: nothing is caught. On the CPU (--device cpu, at
small sizes) the variants take their plain versions.

Usage: python -m flash_vstream_tpu_torch.scripts.probe_int4_variants
           [--din 3584] [--dout 18944] [--blk 512] [--iters 50]
           [--trials 4] [--only v2] [--which v6,v7] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional

import torch

from ..core.device import resolve_device
from ..kernels import int4_variants as iv
from .timing import graph_seconds

LAYERS = 16

# name -> (variant, takes int8 x)
VARIANTS: Dict[str, tuple] = {
    "v1-current": (iv.v1_current, False),
    "v2-biasfold": (iv.v2_biasfold, False),
    "v3-floor": (iv.v3_floor, False),
    "v4-int8dot": (iv.v4_int8dot, True),
    "v5-u8mask": (iv.v5_u8mask, False),
    "v6-bf16dot": (iv.v6_bf16dot, False),
    "v7-unpackonly": (iv.v7_unpackonly, False),
}
MAIN_VARIANTS = ("v1-current", "v2-biasfold", "v3-floor", "v4-int8dot",
                 "v5-u8mask")


def check_shape(din: int, dout: int, blk: int) -> None:
    """The probe's limits: blk divides dout (dout / blk blocks, as the TPU
    grid); dout >= din, since the chain adds y[:, :din]; din even."""
    if din % 2 or dout < din or dout % blk:
        raise ValueError(f"the probe takes an even din <= dout and a blk "
                         f"that divides dout; got din {din}, dout {dout}, "
                         f"blk {blk}")


def make_call(kernel: Callable, din: int, dout: int, blk: int) -> Callable:
    """The variant as the chain calls it, with the probe's blk: (x, q4,
    scale), v4 (xq, xs, q4, scale), v6 (x, w). The JAX script's `nb` and
    `int8_x` arguments are not needed: the kernels read nb from the
    scale's shape and take their operands from the call."""
    check_shape(din, dout, blk)

    def call(*args):
        return kernel(*args, blk=blk)
    return call


def quantize_x(x: torch.Tensor):
    """v4's per-step quantization, in bf16 as the JAX chain: xs = max|x| /
    127 and x / xs each rounded to bf16, round half to even, clip to
    [-127, 127]. The divisor 127 is a tensor: CUDA turns a division by a
    Python scalar into a product with its reciprocal."""
    xs = x.abs().amax() / x.new_full((), 127.0)
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    return xq, xs.reshape(1, 1)


def chain_step(x: torch.Tensor, y: torch.Tensor, din: int) -> torch.Tensor:
    """x + y[:, :din] * 1e-6 rounded once to bf16."""
    return torch.add(x, y[:, :din], alpha=1e-6).to(torch.bfloat16)


def _chain(matvec: Callable, ws: list, x0: torch.Tensor, din: int,
           iters: int, int8_x: bool) -> Callable[[], torch.Tensor]:
    def loop() -> torch.Tensor:
        x = x0
        for _ in range(iters):
            for w in ws:
                if int8_x:
                    y = matvec(*quantize_x(x), *w)
                else:
                    y = matvec(x, *w)
                x = chain_step(x, y, din)
        return x.float().sum()
    return loop


def _report(name: str, seconds: float, stored: int, iters: int,
            layers: int) -> float:
    per = seconds / (iters * layers)
    print(f"{name:14s} {per * 1e3:7.3f} ms/matvec   "
          f"{stored * iters / seconds / 1e9:7.1f} GB/s stored-weight",
          flush=True)
    return per


def bench(name: str, matvec: Callable, din: int, dout: int, nb: int,
          iters: int, trials: int, layers: int = LAYERS, int8_x: bool = False,
          device: Optional[torch.device] = None) -> float:
    """The chained loop over `layers` stacked int4 weights; prints the
    variant's line and returns seconds per matvec."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randint(0, 255, (layers, din // 2, dout), generator=g,
                      device=device, dtype=torch.uint8)
    s = torch.full((layers, nb, dout), 1e-3, dtype=torch.float32,
                   device=device)
    x0 = torch.ones((1, din), dtype=torch.bfloat16, device=device)
    loop = _chain(matvec, list(zip(q.unbind(0), s.unbind(0))), x0, din,
                  iters, int8_x)
    best = graph_seconds(loop, device, trials)
    stored = q.numel() + s.numel() * s.element_size()
    return _report(name, best, stored, iters, layers)


def bench_bf16(name: str, din: int, dout: int, blk: int, iters: int,
               trials: int, layers: int = LAYERS,
               device: Optional[torch.device] = None) -> float:
    """The same chain over `layers` bf16 weights [din, dout] through v6."""
    device = resolve_device(device)
    check_shape(din, dout, blk)
    g = torch.Generator(device=device).manual_seed(0)
    w = torch.empty((layers, din, dout), dtype=torch.bfloat16, device=device)
    for layer in w:                      # f32 draws one layer at a time
        layer.copy_(torch.randn(din, dout, generator=g, device=device))
    x0 = torch.ones((1, din), dtype=torch.bfloat16, device=device)
    call = make_call(iv.v6_bf16dot, din, dout, blk)
    loop = _chain(call, [(wl,) for wl in w.unbind(0)], x0, din, iters, False)
    best = graph_seconds(loop, device, trials)
    return _report(name, best, w.numel() * 2, iters, layers)


def _parser(which: bool) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--din", type=int, default=3584)
    ap.add_argument("--dout", type=int, default=18944)
    ap.add_argument("--blk", type=int, default=512)
    if which:
        ap.add_argument("--which", type=str, default="v6")
    else:
        ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def _header(args, device: torch.device, weight: str) -> None:
    on = (torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu")
    print(f"[1,{args.din}] @ {weight} blk={args.blk} on {on}", flush=True)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """v1-v5 (those whose name holds --only); returns {variant: seconds per
    matvec}."""
    args = _parser(which=False).parse_args(argv)
    device = resolve_device(args.device)
    din, dout, blk = args.din, args.dout, args.blk
    nb = din // 128
    _header(args, device, f"packed[{din // 2},{dout}]")
    results = {}
    for name in MAIN_VARIANTS:
        if args.only and args.only not in name:
            continue
        kernel, int8_x = VARIANTS[name]
        call = make_call(kernel, din, dout, blk)
        results[name] = bench(name, call, din, dout, nb, args.iters,
                              args.trials, int8_x=int8_x, device=device)
    return results


def main2(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """v6 and/or v7, as --which names them; returns {variant: seconds per
    matvec}."""
    args = _parser(which=True).parse_args(argv)
    device = resolve_device(args.device)
    din, dout, blk = args.din, args.dout, args.blk
    nb = din // 128
    _header(args, device, f"[{din},{dout}]")
    results = {}
    if "v6" in args.which:
        results["v6-bf16dot"] = bench_bf16("v6-bf16dot", din, dout, blk,
                                           args.iters, args.trials,
                                           device=device)
    if "v7" in args.which:
        call = make_call(iv.v7_unpackonly, din, dout, blk)
        results["v7-unpackonly"] = bench("v7-unpackonly", call, din, dout, nb,
                                         args.iters, args.trials,
                                         device=device)
    return results


if __name__ == "__main__":
    if "--which" in sys.argv:
        main2()
    else:
        main()
