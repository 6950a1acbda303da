"""Training-step throughput of the Qwen-family LoRA step on one card.

Counterpart of scripts/bench_train_step.py. Measures the LoRA train step
(frozen base + rank-r adapters over the decoder's projections and the
merger, the vision tower under no_grad, the decoder forward/backward with
remat, in-step grad accumulation) end to end: uint8 video patches ->
dual-res ViT -> Flash memory -> splice -> decoder -> loss -> LoRA grads ->
Adam update, through the port's Trainer.

--arch 7b is Qwen2-VL-7B with a quantized base (QLoRA: --base-bits 4, the
default, packed int4; 8, int8) over the decoder's projections, its lm_head,
its embedding and the ViT's projections, at the reference's production
shape with --frames 240 --seq 14000 --px 448. A sequence whose logits
would pass 2**26 elements takes the chunked cross entropy (--ce-chunk; a
quantized head also tiles the vocabulary).

The JAX script's --memory-analysis (XLA's AOT estimate of a step's HBM
without running it) has no torch counterpart: this script measures the
peak instead, `torch.cuda.max_memory_allocated` over the first timed step
(weights, adapters and moments included), and prints it with the timing.

Prints one JSON line (metric `torch_train_step_<arch>_lora`): step p50 s,
tokens/s, model TFLOP a step and TFLOP/s by the JAX script's reckoning
(lora-4N: 4 x the frozen matmul parameters x tokens, with the ViT's and the
attention's terms; remat recompute not counted) and their share of the
H100's 989 TFLOP/s dense bf16 peak, beside the card's name and power
limit. On the CPU (--device cpu, with --tiny) every time is the host's.

Usage: python -m flash_vstream_tpu_torch.scripts.bench_train_step
           [--frames 16] [--seq 512] [--accum 2] [--arch 2b|7b] [--tiny]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..core.device import resolve_device
from .timing import card_line

H100_BF16_TFLOPS = 989.0       # dense bf16, NVIDIA's data sheet (SXM)
VIT_TARGETS = (r"layers/attn/w[qkvo]/w$", r"layers/mlp/fc[12]/w$",
               r"merger/fc[12]/w$")


def _llm_matmul_params(llm) -> float:
    """Matmul-visible parameter count of the decoder stack + LM head
    (embedding gather excluded)."""
    h, i, hk = llm.hidden_size, llm.intermediate_size, (
        llm.num_kv_heads * llm.head_dim)
    per_layer = h * h * 2 + 2 * h * hk + 3 * h * i
    return llm.num_layers * per_layer + llm.vocab_size * h


def _vit_matmul_params(vit) -> float:
    h, i = vit.hidden_size, vit.intermediate_size
    per_layer = 4 * h * h + 2 * h * i
    pd = vit.in_channels * vit.temporal_patch_size * vit.patch_size ** 2
    return vit.num_layers * per_layer + pd * h


def train_step_model_flops(cfg, n_frames: int, seq: int, px: int) -> dict:
    """Model TFLOP of one fwd+bwd LoRA micro-batch, the JAX script's
    reckoning: 4 x frozen matmul params x tokens (2 forward, 2 input-grad
    backward; no dW for the frozen base), 3x-forward attention, the adapter
    terms neglected, remat recompute not counted."""
    t = n_frames // 2
    g = px // 14
    full_tokens = t * g * g
    vit_tokens = full_tokens + full_tokens // 4
    vit_mm = 4 * vit_tokens * _vit_matmul_params(cfg.vit)
    h_v = cfg.vit.hidden_size
    vit_attn = 3.0 * cfg.vit.num_layers * 4 * h_v * (
        t * (g * g) ** 2 + t * (g * g // 4) ** 2)
    dec_mm = 4 * seq * _llm_matmul_params(cfg.llm)
    dec_attn = 3.0 * cfg.llm.num_layers * 2 * seq * seq * cfg.llm.hidden_size
    total = vit_mm + vit_attn + dec_mm + dec_attn
    return {"vit_matmul_tflop": vit_mm / 1e12,
            "vit_attn_tflop": vit_attn / 1e12,
            "decoder_matmul_tflop": dec_mm / 1e12,
            "decoder_attn_tflop": dec_attn / 1e12,
            "total_tflop": total / 1e12}


def make_config(args):
    from ..core.config import (QWEN2_VL_VIT, FlashMemoryConfig, LLMConfig,
                               VStreamQwenConfig, tiny_qwen_config)
    if args.tiny:
        return tiny_qwen_config().replace(flash_memory=FlashMemoryConfig(
            temporal_length=16, spatial_length=8))
    if args.arch == "7b":
        return VStreamQwenConfig(
            vit=dataclasses.replace(QWEN2_VL_VIT, merger_out_dim=3584),
            llm=LLMConfig(vocab_size=152064, hidden_size=3584,
                          intermediate_size=18944, num_layers=28,
                          num_heads=28, num_kv_heads=4, attention_bias=True,
                          rope_theta=1e6, mrope_sections=(16, 24, 24)),
            flash_memory=FlashMemoryConfig())
    return VStreamQwenConfig(
        vit=dataclasses.replace(QWEN2_VL_VIT, merger_out_dim=1536),
        llm=LLMConfig(vocab_size=151936, hidden_size=1536,
                      intermediate_size=8960, num_layers=28, num_heads=12,
                      num_kv_heads=2, attention_bias=True, rope_theta=1e6,
                      mrope_sections=(16, 24, 24)),
        flash_memory=FlashMemoryConfig(temporal_length=16, spatial_length=8))


def make_params(cfg, args, device, dtype):
    """Random weights from seed 0 (bf16 on the card, f32 on the CPU). At
    --arch 7b the decoder, its embedding and the ViT's projections are
    quantized to --base-bits, one layer at a time."""
    from ..models.llm import init_llm_params
    from ..models.vstream_qwen import init_qwen_params
    from ..weights.quantize import (quantize_params, quantize_params4,
                                    quantize_weight, quantize_weight4)
    gen = torch.Generator(device=device).manual_seed(0)
    if args.arch != "7b" or args.tiny:
        return init_qwen_params(cfg, gen, device, dtype=dtype)
    tiny_llm = dataclasses.replace(
        cfg.llm, num_layers=2, hidden_size=256, intermediate_size=512,
        num_heads=4, num_kv_heads=2, vocab_size=512,
        mrope_sections=(8, 12, 12))
    params = init_qwen_params(cfg.replace(llm=tiny_llm), gen, device,
                              dtype=dtype)
    q = quantize_params4 if args.base_bits == 4 else quantize_params
    llm = init_llm_params(cfg.llm, gen, device, dtype=dtype)
    llm = q(llm)                    # the projections and the lm_head
    llm["embed"] = (quantize_weight4 if args.base_bits == 4
                    else quantize_weight)(llm["embed"])
    params["llm"] = llm
    params["vit"] = q(params["vit"], targets=VIT_TARGETS)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return params


def run(args) -> dict:
    from ..models.llm import (cross_entropy_loss, cross_entropy_loss_chunked,
                              decoder_forward, embed_tokens, lm_head)
    from ..models.vstream_qwen import build_qwen_positions, encode_video
    from ..preprocess.image import qwen_patch_norm
    from ..train.lora import QWEN_TARGETS, init_lora_params, lora_views
    from ..train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    cfg = make_config(args)
    params = make_params(cfg, args, device, dtype)
    lora = init_lora_params(torch.Generator(device=device).manual_seed(1),
                            params, rank=args.lora_rank, targets=QWEN_TARGETS)

    side = 4 if args.tiny else args.px // 14
    t = args.frames // 2
    grid = (t, side, side)
    pd = 3 * 2 * 14 * 14
    fm = cfg.flash_memory
    dam = min(t, fm.dam_grid_len) * side * side // 4
    csm = min(t, fm.csm_grid_len) * (side // 2) * (side // 2) // 4
    n_vis = dam + csm
    S, start = args.seq, 16
    if start + n_vis >= S:
        raise ValueError(f"--seq {S} holds no text after {n_vis} visual "
                         f"tokens from position {start}")
    long_seq = S >= 8192
    norm = qwen_patch_norm()

    def loss_fn(lp, batch, key, base):
        # f32 master adapters, bf16 factors in the model (as JAX's)
        lp = {p: {k: v.to(dtype) for k, v in ab.items()}
              for p, ab in lp.items()}
        eff = lora_views(base, lp, alpha=32, rank=args.lora_rank)
        g = torch.Generator().manual_seed(key[0] * 1009 + key[1])
        vis = encode_video(eff, cfg, batch["patches"], grid,
                           draws=lambda n: torch.rand(n, generator=g).to(
                               device),
                           vit_chunk=args.vit_chunk, patch_norm=norm)
        ids = batch["ids"][None]
        embeds = embed_tokens(eff["llm"], ids)
        embeds = torch.cat([embeds[:, :start],
                            vis.video_embeds[None].to(embeds.dtype),
                            embeds[:, start + n_vis:]], dim=1)
        positions, _ = build_qwen_positions(S, start, n_vis,
                                            vis.visual_positions)
        h = decoder_forward(
            eff["llm"], cfg.llm, embeds, positions, remat=True,
            mlp_seq_chunk=args.mlp_chunk,
            remat_group=args.remat_group or (4 if long_seq else 1))
        labels = batch["labels"][None]
        if S * cfg.llm.vocab_size > 1 << 26:
            return cross_entropy_loss_chunked(eff["llm"], cfg.llm, h, labels,
                                              chunk=args.ce_chunk)
        return cross_entropy_loss(lm_head(eff["llm"], cfg.llm, h), labels)

    tcfg = TrainConfig(learning_rate=8e-4, total_steps=100,
                       grad_accum=args.accum, warmup_ratio=0.0,
                       mu_dtype="bfloat16" if args.arch == "7b" else None,
                       offload_moments=args.offload_moments)
    trainer = Trainer(loss_fn, lora, tcfg, frozen=params)

    rng = np.random.default_rng(0)
    V = cfg.llm.vocab_size
    batch = {
        # uint8 patches, normalized per ViT chunk in the step
        "patches": torch.from_numpy(rng.integers(
            0, 256, (args.accum, t * side * side, pd), dtype=np.uint8)
            ).to(device),
        "ids": torch.from_numpy(rng.integers(1, V - 1, (args.accum, S))
                                ).to(device),
        "labels": torch.from_numpy(rng.integers(1, V - 1, (args.accum, S))
                                   ).to(device),
    }

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    trainer.run_step(batch, 0)
    sync()
    first_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times, loss = [], float("nan")
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss = trainer.run_step(batch, i + 1)
        sync()
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    p50 = sorted(times)[len(times) // 2]
    fl = train_step_model_flops(cfg, args.frames, S, args.px)
    step_tflop = args.accum * fl["total_tflop"]
    achieved = step_tflop / p50
    return {
        "metric": f"torch_train_step_{args.arch}_lora",
        "device": card_line(device),
        "base_bits": args.base_bits if args.arch == "7b" else 16,
        "frames": args.frames, "seq": S, "grad_accum": args.accum,
        "visual_tokens": int(n_vis),
        "step_p50_s": p50,
        "steps_s": times,
        "tokens_per_s": args.accum * S / p50,
        "model_tflop_per_step": step_tflop,
        "achieved_tflops": achieved,
        "share_of_h100_bf16_peak": (achieved / H100_BF16_TFLOPS
                                    if device.type == "cuda" else None),
        "flop_convention": "lora-4N (dW skipped for frozen base) + 3x-fwd "
                           "attention; remat recompute excluded",
        "flop_split_tflop": {k: v * args.accum for k, v in fl.items()
                             if k != "total_tflop"},
        "first_step_s": first_s,
        "peak_memory_gib": peak,
        "final_loss": loss,
    }


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lora-rank", type=int, default=64)
    ap.add_argument("--arch", choices=["2b", "7b"], default="2b",
                    help="7b = Qwen2-VL-7B over a quantized base (QLoRA) at "
                         "production shapes: pass --frames 240 --seq 14000 "
                         "--px 448")
    ap.add_argument("--px", type=int, default=224,
                    help="frame side; 448 = the reference's max_pixels")
    ap.add_argument("--vit-chunk", type=int, default=8,
                    help="frame pairs per ViT chunk")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny dims (script logic check; with --device cpu "
                         "on a machine without a card)")
    ap.add_argument("--remat-group", type=int, default=0,
                    help="decoder layers per checkpoint (0 = auto: 4 from "
                         "seq 8192 on, else 1)")
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--mlp-chunk", type=int, default=0,
                    help="MLP sequence chunk (0 = off)")
    ap.add_argument("--offload-moments", action="store_true",
                    help="rest the Adam moments in pinned host memory "
                         "between steps")
    ap.add_argument("--base-bits", type=int, choices=[4, 8], default=4,
                    help="frozen-base precision for --arch 7b")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); cpu for "
                         "a logic check")
    return ap


def main(argv=None) -> dict:
    out = run(make_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
