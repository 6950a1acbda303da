"""Qwen-family LoRA fine-tuning entry.

Port of flash_vstream_tpu/train/finetune_flash.py (the rebuild of
Flash-VStream-Qwen/finetune_flash.py) for one device: ChatML supervision with
the video block expanded to the Flash memory's token count, LoRA over the
decoder's projections and the merger, per-sample micro-batches with gradient
accumulation, (resolution, frame-count) buckets, checkpoint auto-resume.

One sample's loss: frames -> `qwen_preprocess` -> the chunked ViT and Flash
memory consolidation (no graph) -> PatchMerger (LoRA) -> splice into the
prompt's embeddings with the AM-RoPE positions -> the decoder under
checkpointing (LoRA views; attention through FlashAttentionFunction, K3/K4/K5
on the card) -> cross entropy, chunked over the sequence when
max_len * vocab > 2**26. The adapters are f32 masters cast to bf16 inside
the loss, as in JAX.

    python -m flash_vstream_tpu_torch.train.finetune_flash --dry-run \\
        --device cpu --output-dir /tmp/ft

`--dry-run` trains `tiny_qwen_config()` on synthetic frame directories. A
caller may hand `run_training` its own config, base parameters and adapters
(chip_smoke.py runs the full-width model that way); without them a real run
needs the checkpoint loader (ROADMAP A10). Image items, --pp/--sp and
--int8-base raise (ROADMAP A3, A16, A10/A12).

The k-means draws of Flash memory consolidation come from `kmeans_draws(step,
micro, sample, n)`, by default a torch generator seeded from those indices;
the tests pass the JAX run's own draws instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import IGNORE_INDEX

logger = logging.getLogger("finetune_flash")


def build_synthetic_dataset(path: str, n_items: int = 8, n_frames=6,
                            side: int = 56, n_images: int = 0):
    """JPEG frame directories of random frames and a ChatML train.json.
    n_frames: one length, or a per-item list. Returns (data_path,
    video_dir)."""
    if n_images:
        raise NotImplementedError(
            "image items need the varlen ViT, not ported yet: ROADMAP A3")
    os.makedirs(os.path.join(path, "frames"), exist_ok=True)
    from PIL import Image
    rng = np.random.default_rng(0)
    items = []
    lens = (n_frames if isinstance(n_frames, (list, tuple))
            else [n_frames] * n_items)
    for i in range(n_items):
        vid = f"v{i}"
        d = os.path.join(path, "frames", vid)
        os.makedirs(d, exist_ok=True)
        for t in range(lens[i % len(lens)]):
            Image.fromarray(rng.integers(0, 255, (side, side, 3),
                                         dtype=np.uint8)
                            ).save(os.path.join(d, f"{t:06d}.jpg"))
        items.append({
            "id": i, "video": vid,
            "conversations": [
                {"from": "human", "value": f"<video>\nDescribe video {i}."},
                {"from": "gpt", "value": f"It shows scene {i}."},
            ],
        })
    data_path = os.path.join(path, "train.json")
    with open(data_path, "w") as f:
        json.dump(items, f)
    return data_path, os.path.join(path, "frames")


def preprocess_qwen_sample(item: dict, tokenizer, cfg, grid,
                           max_len: int = 512,
                           system_message: str = "You are a helpful assistant.",
                           kind: str = "video"):
    """Multi-turn ChatML ids + labels + the video span (start, n_visual).

    The system block and every user turn are IGNORE; the first user turn
    carries <|vision_start|><|video_pad|>*N<|vision_end|>; every assistant
    turn supervises its answer tokens and <|im_end|>, not the role header or
    the trailing newline."""
    from ..models.vstream_qwen import visual_token_count
    from ..preprocess.qwen_processor import (IM_END, IM_START, VISION_END,
                                             VISION_START, _video_pad_id)
    if kind != "video":
        raise NotImplementedError(
            "image items need the varlen ViT, not ported yet: ROADMAP A3")

    def enc(text):
        if hasattr(tokenizer, "special_id"):
            return tokenizer.encode(text, add_bos=False)
        return tokenizer.encode(text, add_special_tokens=False)

    pad_tok = _video_pad_id(tokenizer, cfg)
    dam, csm = visual_token_count(cfg, *grid)
    n_vis = dam + csm

    ids, labels = [], []
    system = enc(f"{IM_START}system\n{system_message}{IM_END}\n")
    ids += system
    labels += [IGNORE_INDEX] * len(system)
    span = None
    first_user = True
    for turn in item["conversations"]:
        text = turn["value"].replace("<video>\n", "").replace(
            "<image>\n", "").replace("<video>", "").replace("<image>", "")
        if turn["from"] in ("human", "user"):
            if first_user:
                first_user = False
                head = enc(f"{IM_START}user\n{VISION_START}")
                tail = enc(f"{VISION_END}{text}{IM_END}\n")
                span = (len(ids) + len(head), n_vis)
                seq = head + [pad_tok] * n_vis + tail
            else:
                seq = enc(f"{IM_START}user\n{text}{IM_END}\n")
            ids += seq
            labels += [IGNORE_INDEX] * len(seq)
        else:
            prefix = enc(f"{IM_START}assistant\n")
            body = enc(text) + enc(IM_END)
            nl = enc("\n")
            ids += prefix + body + nl
            labels += ([IGNORE_INDEX] * len(prefix) + body
                       + [IGNORE_INDEX] * len(nl))
    if span is None:
        raise ValueError("conversation has no user turn")
    if span[0] + span[1] > max_len:
        raise ValueError(f"video block [{span[0]}, {span[0] + span[1]}) "
                         f"truncated by max_len={max_len}")
    ids = np.asarray(ids, np.int64)
    labels = np.asarray(labels, np.int64)
    return ids[:max_len], labels[:max_len], span


def default_kmeans_draws(step: int, micro: int, sample: int, n: int
                         ) -> torch.Tensor:
    """n uniform draws for one sample's k-means init, from a CPU generator
    seeded by (step, micro-batch, sample)."""
    g = torch.Generator().manual_seed((step * 1_000_003 + micro) * 1_009
                                      + sample)
    return torch.rand(n, generator=g)


def sample_loss(cfg, base: dict, lora_params: dict, patches: torch.Tensor,
                grid, ids: torch.Tensor, labels: torch.Tensor,
                seg: torch.Tensor, vis_start: int, n_vis: int,
                draws: torch.Tensor, *, alpha: float, rank: int,
                vit_chunk: int = 8) -> torch.Tensor:
    """One sample's LoRA loss (JAX `one_sample`): the f32 adapters cast to
    bf16 and viewed over the detached base, the video encoded (ViT and
    Flash memory without a graph, `draws` seeding k-means) and spliced at
    `vis_start`, the decoder checkpointed per layer (per group of 4 from
    max_len 8192 on), then cross entropy, chunked over the sequence when
    max_len * vocab > 2**26. ids, labels, seg: [max_len]."""
    from ..models.llm import (cross_entropy_loss, cross_entropy_loss_chunked,
                              decoder_forward, embed_tokens, lm_head)
    from ..models.vstream_qwen import (build_qwen_positions_dynamic,
                                       encode_video, splice_embeds_dynamic)
    from .lora import lora_views
    span = torch.profiler.record_function      # named spans for a trace
    max_len = ids.shape[0]
    lp16 = {p: {k: v.to(torch.bfloat16) for k, v in ab.items()}
            for p, ab in lora_params.items()}
    eff = lora_views(base, lp16, alpha=alpha, rank=rank)
    with span("train/encode_video"):
        vis = encode_video(eff, cfg, patches, grid, init_scores=draws,
                           vit_chunk=vit_chunk)
    positions, _ = build_qwen_positions_dynamic(max_len, vis_start, n_vis,
                                                vis.visual_positions)
    embeds = embed_tokens(eff["llm"], ids[None])
    embeds = splice_embeds_dynamic(embeds, vis.video_embeds, vis_start)
    with span("train/decoder_forward"):
        h = decoder_forward(eff["llm"], cfg.llm, embeds, positions,
                            segment_ids=seg[None], remat=True,
                            remat_group=4 if max_len >= 8192 else 1)
    with span("train/cross_entropy"):
        if max_len * cfg.llm.vocab_size > 1 << 26:
            return cross_entropy_loss_chunked(eff["llm"], cfg.llm, h,
                                              labels[None], chunk=512)
        return cross_entropy_loss(lm_head(eff["llm"], cfg.llm, h),
                                  labels[None])


def run_training(args, *, cfg=None, params: Optional[dict] = None,
                 lora: Optional[dict] = None,
                 kmeans_draws: Optional[Callable] = None,
                 on_step: Optional[Callable] = None) -> dict:
    """Train the LoRA adapters; returns {"final_loss", "losses", "lora"}.

    `cfg`/`params` (and optionally `lora`, an adapter tree such as
    `weights.from_jax.lora_from_numpy` gives) replace the dry-run or
    checkpoint model; `on_step(step, trainer, record)` runs after every
    optimizer step with the record written to the scalars file."""
    from ..core.config import FlashMemoryConfig, tiny_qwen_config
    from ..core.device import resolve_device
    from ..models.vstream_qwen import init_qwen_params
    from ..preprocess.image import (_resize_bilinear, _to_float_chw,
                                    qwen_preprocess, smart_resize)
    from ..preprocess.qwen_processor import make_byte_qwen_tokenizer
    from ..preprocess.video import load_video, probe_video_hw, probe_video_len
    from ..utils.prefetch import BackgroundPrefetcher
    from . import recipes
    from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from .data import proportional_schedule
    from .lora import QWEN_TARGETS, init_lora_params
    from .reporting import ScalarsWriter, StepProfiler, lr_at
    from .trainer import DP_TODO, Trainer

    if args.pp > 1 or args.sp > 1:
        raise NotImplementedError(DP_TODO)
    if args.int8_base:
        raise NotImplementedError("QLoRA int8/int4 bases are not ported yet: "
                                  "ROADMAP A10/A12")
    if args.export_merged:
        raise NotImplementedError("merged-weight export needs a safetensors "
                                  "writer, not ported yet: ROADMAP A10")
    device = resolve_device(args.device)
    if params is None:
        if not args.dry_run:
            raise NotImplementedError(
                "training from a checkpoint needs load_qwen_checkpoint, not "
                "ported yet: ROADMAP A10 (pass --dry-run, or hand "
                "run_training a config and parameters)")
        cfg = tiny_qwen_config()
        params = init_qwen_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        if not args.data_path:
            args.data_path, args.video_dir = build_synthetic_dataset(
                os.path.join(args.output_dir, "synthetic"))
    elif cfg is None:
        raise ValueError("run_training(params=...) needs its cfg")
    if args.flash_memory_dict:
        cfg = cfg.replace(flash_memory=FlashMemoryConfig.from_dict(
            json.loads(args.flash_memory_dict)))
    tokenizer = make_byte_qwen_tokenizer()
    kmeans_draws = kmeans_draws or default_kmeans_draws

    with open(args.data_path) as f:
        items = json.load(f)
    total_steps = args.max_steps or max(
        len(items) // args.grad_accum, 1) * args.epochs
    tcfg = dataclasses.replace(
        recipes.qwen_lora(total_steps, args.grad_accum),
        learning_rate=args.learning_rate, zero_stage=args.zero_stage,
        offload_moments=args.offload_moments)
    if lora is None:
        lora = init_lora_params(
            torch.Generator(device=device).manual_seed(1), params,
            rank=args.lora_rank, targets=QWEN_TARGETS)
    alpha, rank = args.lora_alpha, args.lora_rank
    max_len = args.max_len or (512 if args.dry_run else 14000)

    def frame_rung(n: int) -> int:
        if args.frame_bucket:
            return args.frame_bucket
        for b in (args.max_frames // 8, args.max_frames // 4,
                  args.max_frames // 2, args.max_frames):
            b = max(b + b % 2, 2)              # temporal pairs need even
            if n <= b:
                return b
        return args.max_frames

    def bucket_of(item):
        if "image" in item:
            raise NotImplementedError(
                "image items need the varlen ViT, not ported yet: ROADMAP A3")
        path = os.path.join(args.video_dir, item["video"])
        h, w = probe_video_hw(path)
        n = min(probe_video_len(path), args.max_frames)
        return (smart_resize(h, w, factor=56, max_pixels=args.max_pixels),
                frame_rung(n))

    buckets: dict = {}
    for item in items:
        buckets.setdefault(bucket_of(item), []).append(item)
    logger.info(f"(resolution, frames) buckets: "
                f"{ {bk: len(v) for bk, v in buckets.items()} }")

    def prepare(item, bk):
        train_hw, target = bk
        frames = list(load_video(os.path.join(args.video_dir, item["video"]),
                                 max_frames=target))
        # pad to the bucket's frame count by repeating the last frame
        while len(frames) < target:
            frames.append(frames[-1])
        frames = [np.clip(_resize_bilinear(_to_float_chw(np.asarray(f)),
                                           train_hw) * 255, 0, 255)
                  .transpose(1, 2, 0).astype(np.uint8)
                  if np.asarray(f).shape[:2] != train_hw else np.asarray(f)
                  for f in frames]
        patches, grid = qwen_preprocess(frames, max_pixels=args.max_pixels)
        ids, labels, span = preprocess_qwen_sample(item, tokenizer, cfg, grid,
                                                   max_len)
        pad = max_len - len(ids)
        seg = np.concatenate([np.zeros(len(ids), np.int32),
                              np.full(pad, -1, np.int32)])
        ids = np.pad(ids, (0, pad))
        labels = np.pad(labels, (0, pad), constant_values=IGNORE_INDEX)
        return patches, grid, ids, labels, span, seg

    def make_loss(grid, span):
        def one_sample(lora_params, base, patches, ids, labels, seg,
                       vis_start, draws):
            return sample_loss(cfg, base, lora_params, patches, grid, ids,
                               labels, seg, vis_start, span[1], draws,
                               alpha=alpha, rank=rank,
                               vit_chunk=args.vit_chunk)

        def loss_fn(lora_params, batch, key, base):
            (step, micro), B = key, batch["ids"].shape[0]
            losses = []
            for b in range(B):
                def dev(name, dtype=None):
                    return torch.from_numpy(batch[name][b]).to(device, dtype)
                draws = kmeans_draws(step, micro, b, grid[0]).to(device)
                losses.append(one_sample(
                    lora_params, base, dev("patches"), dev("ids"),
                    dev("labels"), dev("seg"), int(batch["vis_start"][b]),
                    draws))
            return torch.stack(losses).mean()
        return loss_fn

    order = sorted(buckets, key=lambda hw: -len(buckets[hw]))
    first_hw = order[0]
    first = prepare(buckets[first_hw][0], first_hw)
    trainer = Trainer(make_loss(first[1], first[4]), lora, tcfg,
                      frozen=params)
    step_fns = {first_hw: trainer._train_step}

    def step_fn_for(hw):
        if hw not in step_fns:
            probe = prepare(buckets[hw][0], hw)
            step_fns[hw] = trainer.compile_step(make_loss(probe[1], probe[4]))
        return step_fns[hw]

    start_step = 0
    if latest_checkpoint(args.output_dir):
        step, payload = restore_checkpoint(args.output_dir,
                                           map_location=device)
        trainer.load_state(payload["params"], payload["opt_state"])
        start_step = step
        logger.info(f"resumed from checkpoint-{step}")

    B = args.batch_size
    cursors = {hw: 0 for hw in order}
    schedule = proportional_schedule({hw: len(buckets[hw]) for hw in order},
                                     total_steps)
    # resume: replay the consumed prefix so the data order is stable
    for s in range(start_step):
        cursors[schedule[s]] += args.grad_accum * B

    def make_step_batch(step: int):
        hw = schedule[step]
        bucket_items = buckets[hw]
        micro = []
        for _ in range(args.grad_accum):
            rows = []
            for _ in range(B):
                rows.append(prepare(
                    bucket_items[cursors[hw] % len(bucket_items)], hw))
                cursors[hw] += 1
            micro.append(tuple(np.stack([r[i] for r in rows])
                               for i in (0, 2, 3, 5))
                         + (np.asarray([r[4][0] for r in rows], np.int32),))
        batch = {name: np.stack([m[i] for m in micro])
                 for i, name in enumerate(("patches", "ids", "labels", "seg",
                                           "vis_start"))}
        return hw, batch

    scalars = ScalarsWriter(args.scalars_file or
                            os.path.join(args.output_dir, "scalars.jsonl"))
    profiler = StepProfiler(args.profile_dir, start_step, args.profile_steps)
    prefetch = BackgroundPrefetcher(make_step_batch, start_step, total_steps)
    losses = []
    try:
        for step, (hw, batch) in zip(range(start_step, total_steps),
                                     prefetch):
            t0 = time.perf_counter()
            profiler.before_step(step)
            loss = trainer.run_step(batch, step, step_fn=step_fn_for(hw))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.after_step(step)
            dt = time.perf_counter() - t0
            losses.append(loss)
            record = dict(loss=loss, lr=lr_at(tcfg, step), step_time_s=dt,
                          bucket=f"{hw[0][0]}x{hw[0][1]}x{hw[1]}f",
                          tokens_per_s=B * args.grad_accum * max_len
                          / max(dt, 1e-9))
            scalars.write(step + 1, **record)
            logger.info(f"step {step + 1}/{total_steps} loss={loss:.4f} "
                        f"bucket={hw} B={B}")
            if on_step is not None:
                on_step(step, trainer, record)
            if (step + 1) % args.save_steps == 0 or step + 1 == total_steps:
                save_checkpoint(args.output_dir, step + 1, trainer.params,
                                trainer.opt_state)
    finally:
        prefetch.close()
        profiler.close()
        scalars.close()
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "lora": trainer.params, "profile": getattr(profiler, "profile",
                                                       None)}


def make_parser():
    p = argparse.ArgumentParser(description="Flash-VStream Qwen LoRA finetune")
    p.add_argument("--model-path", default=None)
    p.add_argument("--data-path", default=None)
    p.add_argument("--video-dir", default="")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="samples per micro-batch")
    p.add_argument("--int8-base", action="store_true",
                   help="QLoRA base (not ported: ROADMAP A10/A12)")
    p.add_argument("--base-bits", type=int, choices=[4, 8], default=4)
    p.add_argument("--lora-rank", type=int, default=64)
    p.add_argument("--lora-alpha", type=float, default=32)
    p.add_argument("--learning-rate", type=float, default=8e-4)
    p.add_argument("--grad-accum", type=int, default=8)
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (not ported: ROADMAP A16)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel width (not ported: ROADMAP A16)")
    p.add_argument("--zero-stage", type=int, default=2, choices=(1, 2, 3),
                   help="one device runs the default only (ROADMAP A16)")
    p.add_argument("--offload-moments", action="store_true",
                   help="not ported: ROADMAP A16")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--max-frames", type=int, default=240)
    p.add_argument("--frame-bucket", type=int, default=None,
                   help="one fixed frame count per sample; default: rungs "
                        "max_frames/{8,4,2,1}")
    p.add_argument("--max-pixels", type=int, default=4 * 224 * 224)
    p.add_argument("--vit-chunk", type=int, default=8,
                   help="frame pairs per ViT chunk (0 = one encode)")
    p.add_argument("--max-len", type=int, default=None,
                   help="sequence length; default 14000 (the reference's "
                        "model_max_length) or 512 under --dry-run")
    p.add_argument("--save-steps", type=int, default=100)
    p.add_argument("--scalars-file", type=str, default=None,
                   help="JSONL scalars stream (default "
                        "<output-dir>/scalars.jsonl)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--profile-steps", type=int, default=3)
    p.add_argument("--flash-memory-dict", default=None)
    p.add_argument("--export-merged", action="store_true",
                   help="not ported: ROADMAP A10")
    p.add_argument("--dry-run", action="store_true")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run_training(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
