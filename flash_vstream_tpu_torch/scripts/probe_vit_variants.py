"""Probe: ViT-block variants of the ingest encode on the card.

Port of scripts/probe_vit_variants.py: the 32-layer Qwen2-VL ViT over one
clip of both resolution streams (4 temporal pairs at 224 px: 1,024 full and
256 small tokens), each variant run as a chained loop of --iters encodes
with state carried across them. Modes (`MODES`):

  base        qwen_vit_blocks_frames as shipped (three QKV projections,
              attention through K1 once per stream per layer)
  fusedqkv    one [tokens, 3D] QKV projection per stream (int8 weights
              concatenate their columns and per-channel scales)
  combqkv     one QKV projection over BOTH streams, K1 per stream
  onecall     fused QKV and both streams in ONE K1 call, the small stream's
              frames zero-padded from 64 to 256 tokens. As in the JAX probe
              the call has no mask, so the 192 zero keys score 0 and take
              softmax weight from every small-stream query: the result is
              not the base encode's (printed below as its error)
  xlaattn     fused QKV and the plain attention (flash_attention_reference)
  framekernel the CUDA kernel P2 (kernels/frame_attention.py), a whole-row
              softmax per (frame, head block), once per stream per layer
  noattn      the projections run, attention is replaced by v

Each mode prints the JAX probe's line (ms per clip by CUDA-graph replay,
best of --trials, and TF/s of the same FLOP count) with the eager ms per
clip beside it (the port's ingest runs eager, so the host's launch rate
shows there) and the largest |error| against `base` on the same patches;
then the JAX probe's JSON line of ms per clip. `--int8-weight-only`
quantizes the blocks to int8; `--int8` also turns on w8a8 for the run.
`--single-layer` chains one block body 32 x --iters times instead of the
stack. The JAX probe's `--retries` is left out: it retried compiles of a
remote compile service, a workaround that is not ported. `--layers` cuts
the depth, for runs on the CPU (--device cpu, a small --side).

Usage: python -m flash_vstream_tpu_torch.scripts.probe_vit_variants
           [--modes a,b] [--iters 20] [--int8 | --int8-weight-only]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import QWEN2_VL_VIT, VitConfig
from ..core.device import resolve_device
from ..kernels import flash_attention as fa
from ..kernels import frame_attention as fra
from ..models import layers
from ..models.layers import (apply_rope, dense, gelu_mlp, layer_norm,
                             layer_slice)
from ..models.qwen2_vit import (_frame_rope, init_qwen_vit_params,
                                qwen_vit_blocks_frames)
from ..weights.quantize import (QuantWeight, enable_w8a8_prefill,
                                quantize_params)
from .timing import eager_seconds, graph_seconds

MODES = ("base", "fusedqkv", "combqkv", "onecall", "xlaattn", "framekernel",
         "noattn")
# the modes that compute base's function (onecall and noattn do not)
SAME_AS_BASE = ("base", "fusedqkv", "combqkv", "xlaattn", "framekernel")
# kernel launches per block (one layer over both streams) on the card
K1_PER_BLOCK = {"base": 2, "fusedqkv": 2, "combqkv": 2, "onecall": 1}
P2_PER_BLOCK = {"framekernel": 2}
N_BANK = 4             # patch sets the chain rotates through


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One clip's token layout: t temporal pairs of g x g full-resolution
    patches and (g/2) x (g/2) pooled ones."""
    t: int
    g: int

    @classmethod
    def of(cls, side: int, clip: int) -> "Geometry":
        return cls(clip // 2, side // 14)

    @property
    def P_full(self) -> int:
        return self.g * self.g

    @property
    def P_small(self) -> int:
        return (self.g // 2) ** 2

    @property
    def S(self) -> int:
        return self.t * self.P_full

    @property
    def S_small(self) -> int:
        return self.t * self.P_small

    @property
    def St(self) -> int:
        return self.S + self.S_small


def vit_flops(cfg: VitConfig, geo: Geometry) -> int:
    """The JAX probe's FLOP count of one encode (the blocks, no patch
    embedding)."""
    D, I, H, hd = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                   cfg.head_dim)
    return cfg.num_layers * (
        4 * 2 * geo.St * D * D + 2 * 2 * geo.St * D * I
        + 2 * 2 * geo.t * H * hd * (geo.P_full ** 2 + geo.P_small ** 2))


def qkv_fused(lp: dict, hf: torch.Tensor):
    """One projection onto the concatenated q, k, v columns, split after.
    Int8 weights concatenate their int8 columns and per-channel scales, so
    one activation quantization feeds all three under w8a8."""
    wq, wk, wv = (lp["attn"][n] for n in ("wq", "wk", "wv"))
    if isinstance(wq["w"], QuantWeight):
        w = QuantWeight(torch.cat([wq["w"].q, wk["w"].q, wv["w"].q], dim=1),
                        torch.cat([wq["w"].scale, wk["w"].scale,
                                   wv["w"].scale], dim=-1))
    else:
        w = torch.cat([wq["w"], wk["w"], wv["w"]], dim=1)
    b = torch.cat([wq["b"], wk["b"], wv["b"]]) if "b" in wq else None
    return dense(hf, w, b).chunk(3, dim=-1)


def make_blocks(mode: str, cfg: VitConfig, geo: Geometry, device, *,
                head_block: int = 8) -> Callable[[torch.Tensor, dict],
                                                 torch.Tensor]:
    """The block body of `mode`: (x [St, D], one layer's params) -> x.
    "base" gives the shipped block (three projections, K1 per stream)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    t, S, St = geo.t, geo.S, geo.St
    P_full, P_small = geo.P_full, geo.P_small
    rope_f = _frame_rope((geo.g, geo.g), hd, device)
    rope_s = _frame_rope((geo.g // 2, geo.g // 2), hd, device)

    def heads(x, T, P):
        return x.reshape(T, P, H, hd).transpose(1, 2)

    def attn_stream(lp, h, rope, attn_fn, fused):
        T, P, _ = h.shape
        hf = h.reshape(T * P, D)
        a = lp["attn"]
        if fused:
            q, k, v = qkv_fused(lp, hf)
        else:
            q, k, v = (dense(hf, a[n]["w"], a[n].get("b"))
                       for n in ("wq", "wk", "wv"))
        q, k, v = (heads(x, T, P) for x in (q, k, v))
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
        out = attn_fn(q, k, v).transpose(1, 2).reshape(T * P, D)
        return dense(out, a["wo"]["w"], a["wo"].get("b"))

    def per_stream(lp, h, attn_fn, fused):
        a_full = attn_stream(lp, h[:S].reshape(t, P_full, D), rope_f,
                             attn_fn, fused)
        a_small = attn_stream(lp, h[S:].reshape(t, P_small, D), rope_s,
                              attn_fn, fused)
        return torch.cat([a_full, a_small])

    def combqkv(lp, h):
        q, k, v = qkv_fused(lp, h.reshape(St, D))

        def one_stream(q, k, v, T, P, rope):
            q, k, v = (heads(x, T, P) for x in (q, k, v))
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
            out = fa.flash_attention(q, k, v)
            return out.transpose(1, 2).reshape(T * P, D)
        attn = torch.cat([
            one_stream(q[:S], k[:S], v[:S], t, P_full, rope_f),
            one_stream(q[S:], k[S:], v[S:], t, P_small, rope_s)])
        return dense(attn, lp["attn"]["wo"]["w"], lp["attn"]["wo"].get("b"))

    def onecall(lp, h):
        q, k, v = qkv_fused(lp, h.reshape(St, D))
        pad = (0, 0, 0, P_full - P_small)

        def pad_heads(x):     # both streams as 2t frames of P_full tokens
            return torch.cat([heads(x[:S], t, P_full),
                              F.pad(heads(x[S:], t, P_small), pad)])
        q, k, v = pad_heads(q), pad_heads(k), pad_heads(v)
        pad_rope = (F.pad(rope_s[0], pad), F.pad(rope_s[1], pad))
        q = torch.cat([apply_rope(q[:t], *rope_f),
                       apply_rope(q[t:], *pad_rope)])
        k = torch.cat([apply_rope(k[:t], *rope_f),
                       apply_rope(k[t:], *pad_rope)])
        # no mask, as in the JAX probe: the padded keys are attended
        out = fa.flash_attention(q, k, v)
        attn = torch.cat([
            out[:t].transpose(1, 2).reshape(S, D),
            out[t:, :, :P_small].transpose(1, 2).reshape(geo.S_small, D)])
        return dense(attn, lp["attn"]["wo"]["w"], lp["attn"]["wo"].get("b"))

    def frame_attn(q, k, v):
        return fra.frame_attention(q, k, v, head_block=head_block)

    attention = {
        "combqkv": combqkv,
        "onecall": onecall,
        "framekernel": lambda lp, h: per_stream(lp, h, frame_attn, False),
        "noattn": lambda lp, h: per_stream(lp, h, lambda q, k, v: v, False),
        "xlaattn": lambda lp, h: per_stream(
            lp, h, fa.flash_attention_reference, True),
        "fusedqkv": lambda lp, h: per_stream(lp, h, fa.flash_attention, True),
        "base": lambda lp, h: per_stream(lp, h, fa.flash_attention, False),
    }[mode]

    def body(x, lp):
        h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], 1e-6)
        x = x + attention(lp, h)
        h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], 1e-6)
        return x + gelu_mlp(lp["mlp"], h, cfg.hidden_act)
    return body


def encode(mode: str, params: dict, cfg: VitConfig, geo: Geometry,
           patches: torch.Tensor, *, head_block: int = 8,
           body: Optional[Callable] = None) -> torch.Tensor:
    """One clip's encode by `mode`: patches [St, pd] -> [St, D]. `body`
    reuses a `make_blocks` result."""
    if mode == "base":
        return qwen_vit_blocks_frames(
            params, cfg, patches, t_full=geo.t, hw_full=(geo.g, geo.g),
            t_small=geo.t, hw_small=(geo.g // 2, geo.g // 2))
    body = body or make_blocks(mode, cfg, geo, patches.device,
                               head_block=head_block)
    x = dense(patches, params["patch_embed"]["w"])
    for i in range(cfg.num_layers):
        x = body(x, layer_slice(params["layers"], i))
    return x


def _counts() -> Dict[str, int]:
    return {"K1": fa.flash_attention_cuda.launches,
            "P2": fra.frame_attention_cuda.launches}


def run_mode(mode: str, params: dict, cfg: VitConfig, geo: Geometry,
             patches: torch.Tensor, *, iters: int, trials: int,
             head_block: int = 8, single_layer: bool = False,
             base_out: Optional[torch.Tensor] = None) -> dict:
    """Times one mode. Returns seconds per clip by graph replay (`s`) and
    eagerly (`eager_s`), max |out - base_out| on patches[0] (`err`, and
    `err_rel` over max |base_out|, when base_out is given), the blocks the
    wrapper calls ran (`blocks`: graph replays do not pass through the
    wrappers) and the K1 / P2 launches counted meanwhile (`launches`)."""
    device = patches.device
    body = make_blocks(mode, cfg, geo, device, head_block=head_block)
    blocks = [0]

    def enc(p):
        blocks[0] += cfg.num_layers
        return encode(mode, params, cfg, geo, p, body=body)

    if single_layer:
        layer0 = layer_slice(params["layers"], 0)

        def loop():
            x = dense(patches[0], params["patch_embed"]["w"])
            for _ in range(iters * cfg.num_layers):
                blocks[0] += 1
                x = body(x, layer0)
            return x[0, 0].float()
    else:
        def loop():
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(iters):
                acc = acc + enc(patches[i % len(patches)])[0, 0].float()
            return acc

    before = _counts()
    s = graph_seconds(loop, device, trials) / iters
    eager_s = eager_seconds(loop, device, trials) / iters
    err = err_rel = None
    if base_out is not None:
        out = enc(patches[0])
        err = (out.float() - base_out.float()).abs().max().item()
        err_rel = err / base_out.float().abs().max().item()
    after = _counts()
    return dict(s=s, eager_s=eager_s, err=err, err_rel=err_rel,
                blocks=blocks[0],
                launches={k: after[k] - before[k] for k in after})


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--side", type=int, default=224)
    ap.add_argument("--clip", type=int, default=8)
    ap.add_argument("--modes", type=str,
                    default="combqkv,fusedqkv,base,xlaattn,onecall")
    ap.add_argument("--head-block", type=int, default=8,
                    help="P2 heads per block (framekernel mode)")
    ap.add_argument("--int8-weight-only", action="store_true",
                    help="int8 weights without w8a8: the weight-read change "
                         "alone")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and w8a8 (int8 x int8 products at "
                         "prefill rows)")
    ap.add_argument("--single-layer", action="store_true",
                    help="chain ONE block body 32 x iters times instead of "
                         "the stack; per-layer cost x layers approximates "
                         "the encode")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the ViT to this many layers (default: all 32)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    """Runs the modes and prints their lines; returns {mode: run_mode's
    record, with `tflops`}."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = QWEN2_VL_VIT
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    geo = Geometry.of(args.side, args.clip)
    pd = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
    params = init_qwen_vit_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        dtype=torch.bfloat16)
    if args.int8 or args.int8_weight_only:
        params = quantize_params(params)
    patches = torch.from_numpy(np.random.default_rng(0).normal(
        size=(N_BANK, geo.St, pd)).astype(np.float32)).to(device)
    patches = patches.to(torch.bfloat16)
    flops = vit_flops(cfg, geo)
    tag8 = " int8" if args.int8 else (" int8-wo" if args.int8_weight_only
                                      else "")
    was = layers.W8A8_PREFILL
    enable_w8a8_prefill(args.int8)
    try:
        base_out = encode("base", params, cfg, geo, patches[0])
        results, ms = {}, {}
        for mode in args.modes.split(","):
            r = run_mode(mode, params, cfg, geo, patches, iters=args.iters,
                         trials=args.trials, head_block=args.head_block,
                         single_layer=args.single_layer, base_out=base_out)
            r["tflops"] = flops / r["s"] / 1e12
            results[mode] = r
            print(f"{mode:10s}{tag8} {r['s'] * 1e3:7.2f} ms/clip "
                  f"{r['tflops']:6.1f} TF/s  eager {r['eager_s'] * 1e3:7.2f} "
                  f"ms/clip  max|err| vs base {r['err']:.3e} "
                  f"({r['err_rel']:.2e} of max)",
                  file=sys.stderr, flush=True)
            ms[mode] = round(r["s"] * 1e3, 2)
            print(json.dumps(ms), flush=True)
    finally:
        enable_w8a8_prefill(was)
    return results


if __name__ == "__main__":
    main()
