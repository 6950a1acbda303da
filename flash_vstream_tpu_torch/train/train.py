"""LLaVA-family training entry: projector pretraining, then the full
finetune.

Port of flash_vstream_tpu/train/train.py:26-402, the CLI rebuild of
Flash-VStream-LLaVA/flash_vstream/train/train.py, on one device: two
stages (`--stage pretrain`: the projector and the NTM train, the `plain`
template, `recipes.llava_pretrain`; `--stage finetune`: everything but the
vision tower, `vicuna_v1`, `recipes.llava_finetune`), length-grouped order
within each modality, modalities interleaved in proportion to their size,
checkpoint auto-resume with a cursor-stable data order.

Four kinds of item train, each modality with its own step
(`Trainer.compile_step`): precomputed video features (`--feature-dir`, the
reference's feature mode, train.py:700-760), raw frame directories (the
frozen CLIP runs inside the loss, K1 on the card; train.py:764-793),
single images (their full patch features, no memory; train.py:694-716) and
text-only conversations. A video's loss: features [B, T, P, D] -> one STAR
consolidation per sample (its own draws) -> the valid memory packed into
n_mem rows, n_mem = the frame bucket's count for every sample (JAX
train.py:170: a video with fewer frames splices invalid memory rows, as
written) -> projector -> the splice at the batch's image slot -> the
decoder checkpointed per layer (K3/K4/K5 on the card) -> cross entropy
over chunks of 512 tokens (one [B, 512, vocab] f32 block live at a time).

    python -m flash_vstream_tpu_torch.train.train --dry-run --device cpu \\
        --output-dir /tmp/llava --stage finetune --max-steps 4
    python -m flash_vstream_tpu_torch.train.train --model-path DIR \\
        --data-path train.json --feature-dir FEATS --output-dir OUT \\
        --stage pretrain --batch-size 32 --frame-bucket 50

`--dry-run` trains `tiny_llava_config()` (f32 on the CPU, bf16 on the
card) with the byte tokenizer on synthetic features, or with
`--synthetic-raw` on `.npy` frame directories, `.npy` images and text-only
items (JAX writes JPEGs; the card's machine has no PIL). `--model-path`
loads a Flash-VStream-LLaVA checkpoint directory in bf16
(`weights/convert.load_llava_checkpoint`) with `VStreamLLaVAConfig()` and
its HF tokenizer (`transformers`); a caller may hand `run_training` its own
config, parameters and tokenizer. --tp > 1, --zero-stage other than 2 and
--offload-moments raise (ROADMAP A16).

The STAR draws (k-means init, drop coins) come from `draws(step, micro,
sample, n)`, by default a torch generator seeded from those indices; the
tests hand in the JAX run's own uniforms.
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

logger = logging.getLogger("train")

CE_CHUNK = 512                 # tokens of a cross-entropy chunk


def build_synthetic_dataset(path: str, n_items: int = 16,
                            n_frames: int = 6, feat_shape=(64, 32)):
    """Synthetic conversations and `.npy` features [n_frames, *feat_shape]
    (JAX's draws, file for file). Returns (data_path, feature_dir)."""
    os.makedirs(os.path.join(path, "feats"), exist_ok=True)
    items = []
    rng = np.random.default_rng(0)
    for i in range(n_items):
        vid = f"v{i}"
        np.save(os.path.join(path, "feats", vid + ".npy"),
                rng.normal(size=(n_frames, *feat_shape)).astype(np.float32))
        items.append({
            "id": i, "video": vid,
            "conversations": [
                {"from": "human", "value": f"<image>\nWhat is in video {i}?"},
                {"from": "gpt", "value": f"Scene number {i} with motion."},
            ],
        })
    data_path = os.path.join(path, "train.json")
    with open(data_path, "w") as f:
        json.dump(items, f)
    return data_path, os.path.join(path, "feats")


def build_synthetic_raw_dataset(path: str, n_videos: int = 4,
                                n_images: int = 2, n_text: int = 2,
                                n_frames: int = 4, side: int = 112):
    """Raw media for every dataset branch (reference train.py:679-816):
    `.npy` frame directories, `.npy` single images and text-only items,
    with JAX's pixel draws (JAX encodes them as JPEGs). Returns (data_path,
    media_dir)."""
    media = os.path.join(path, "media")
    os.makedirs(media, exist_ok=True)
    rng = np.random.default_rng(0)
    items = []
    for i in range(n_videos):
        d = os.path.join(media, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for t in range(n_frames):
            np.save(os.path.join(d, f"{t:06d}.npy"),
                    rng.integers(0, 255, (side, side, 3), dtype=np.uint8))
        items.append({
            "id": f"v{i}", "video": f"v{i}",
            "conversations": [
                {"from": "human", "value": f"<image>\nWhat is in video {i}?"},
                {"from": "gpt", "value": f"Scene {i} with motion."}]})
    for i in range(n_images):
        name = f"img{i}.npy"
        np.save(os.path.join(media, name),
                rng.integers(0, 255, (side, side, 3), dtype=np.uint8))
        items.append({
            "id": f"i{i}", "image": name,
            "conversations": [
                {"from": "human", "value": f"<image>\nDescribe image {i}."},
                {"from": "gpt", "value": f"A colorful pattern {i}."}]})
    for i in range(n_text):
        items.append({
            "id": f"t{i}",
            "conversations": [
                {"from": "human", "value": f"Say the number {i}."},
                {"from": "gpt", "value": f"The number is {i}."}]})
    data_path = os.path.join(path, "train.json")
    with open(data_path, "w") as f:
        json.dump(items, f)
    return data_path, media


def make_losses(cfg, device, image_slot: int, n_mem: int,
                draws: Callable) -> dict:
    """{"video", "image", "text"} -> loss_fn(params, micro_batch, (step,
    micro)) over numpy batches (JAX `video_loss`, `image_loss`,
    `text_loss`); `draws(step, micro, sample, n)` seeds each sample's
    consolidation."""
    from ..models.llm import cross_entropy_loss_chunked, embed_tokens
    from ..models.projector import project
    from ..models.vstream_llava import (clip_train, decode_train,
                                        encode_frames_train, memory_embeds,
                                        splice_batch)
    from ..ops.pooling import merge_2x2_tokens
    from ..preprocess.image import clip_device_preprocess
    span = torch.profiler.record_function      # named spans for a trace

    def dev(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

    def decode_loss(params, embeds, batch):
        with span("train/decoder_forward"):
            h = decode_train(params, cfg, embeds, dev(batch["segments"]))
        labels = dev(batch["labels"])
        with span("train/cross_entropy"):
            return cross_entropy_loss_chunked(params["llm"], cfg.llm, h,
                                              labels, chunk=CE_CHUNK)

    def splice(params, batch, visual):
        ids = dev(batch["input_ids"]).clamp_min(0)   # the slot's id is -200
        return splice_batch(params["llm"], ids, image_slot, visual)

    def video_loss(params, batch, key):
        step, micro = key
        with span("train/encode_video"):
            if "frames" in batch:
                u8 = dev(batch["frames"])              # [B, T, H, W, 3]
                images = clip_device_preprocess(u8.flatten(0, 1))
                feats = encode_frames_train(
                    params, cfg, images.unflatten(0, u8.shape[:2]))
            else:
                feats = dev(batch["images"], torch.float32)
            mem = memory_embeds(
                params, cfg, feats, batch["n_frames"], n_mem,
                lambda b, n: draws(step, micro, b, n).to(device))
        return decode_loss(params, splice(params, batch, mem), batch)

    def image_loss(params, batch, key):
        with span("train/encode_image"):
            feats = clip_train(params, cfg,
                               clip_device_preprocess(dev(batch["image"])))
            if cfg.projector.use_4_vision_tokens:
                feats = merge_2x2_tokens(feats)
            proj = project(params["projector"], cfg.projector, feats)
        return decode_loss(params, splice(params, batch, proj), batch)

    def text_loss(params, batch, key):
        embeds = embed_tokens(params["llm"],
                              dev(batch["input_ids"]).clamp_min(0))
        return decode_loss(params, embeds, batch)

    return {"video": video_loss, "image": image_loss, "text": text_loss}


def run_training(args, *, cfg=None, params: Optional[dict] = None,
                 tokenizer=None, draws: Optional[Callable] = None,
                 on_step: Optional[Callable] = None) -> dict:
    """Train; returns {"final_loss", "losses", "steps", "modalities",
    "params", "profile"}. `cfg`/`params` replace the dry-run or checkpoint
    model (`--model-path` then loads into `cfg`), `tokenizer` the byte
    tokenizer or the checkpoint's. `on_step(step, trainer, record)` runs
    after every optimizer step with the record written to the scalars
    file."""
    from ..core.config import VStreamLLaVAConfig, tiny_llava_config
    from ..core.device import dry_run_dtype, resolve_device
    from ..models.vstream_llava import init_llava_params, star_valid_counts
    from ..preprocess.tokenizer import ByteTokenizer
    from ..utils.prefetch import BackgroundPrefetcher
    from . import recipes
    from .checkpoint import (latest_checkpoint, restore_checkpoint,
                             save_checkpoint)
    from .data import (DataConfig, SupervisedVideoDataset, collate_llava,
                       collate_text, length_grouped_indices,
                       proportional_schedule, spliced_labels,
                       spliced_segments)
    from .finetune_flash import default_kmeans_draws
    from .reporting import ScalarsWriter, StepProfiler, lr_at
    from .trainer import DP_TODO, Trainer

    if args.tp > 1 or args.zero_stage != 2 or args.offload_moments:
        raise NotImplementedError(DP_TODO)
    device = resolve_device(args.device)
    if params is None:
        if args.dry_run:
            cfg = tiny_llava_config()
            params = init_llava_params(
                cfg, torch.Generator(device=device).manual_seed(0), device,
                dtype=dry_run_dtype(device))
            tokenizer = tokenizer or ByteTokenizer()
        elif args.model_path:
            from ..weights.convert import load_llava_checkpoint
            cfg = cfg or VStreamLLaVAConfig()
            params = load_llava_checkpoint(args.model_path, cfg,
                                           dtype=torch.bfloat16,
                                           device=device)
            if tokenizer is None:
                from ..preprocess.tokenizer import load_tokenizer
                tokenizer = load_tokenizer(args.model_path)
        else:
            raise ValueError("pass --model-path DIR (a Flash-VStream-LLaVA "
                             "checkpoint directory) or --dry-run, or hand "
                             "run_training a config and parameters")
    elif cfg is None:
        raise ValueError("run_training(params=...) needs its cfg")
    tokenizer = tokenizer or ByteTokenizer()
    draws = draws or default_kmeans_draws
    if args.dry_run and not args.data_path:
        if args.synthetic_raw:
            args.data_path, args.video_dir = build_synthetic_raw_dataset(
                os.path.join(args.output_dir, "synthetic"),
                side=cfg.vit.image_size)
        else:
            args.data_path, args.feature_dir = build_synthetic_dataset(
                os.path.join(args.output_dir, "synthetic"))

    dcfg = DataConfig(
        data_path=args.data_path, video_dir=args.video_dir,
        feature_dir=args.feature_dir,
        video_max_frames=args.video_max_frames,
        conv_version="plain" if args.stage == "pretrain" else "v1",
        frame_bucket=args.frame_bucket, image_size=cfg.vit.image_size)
    dataset = SupervisedVideoDataset(dcfg, tokenizer)

    # one step per modality bucket, every step homogeneous (the reference
    # branches per item, train.py:679-816)
    groups = {"video": [], "image": [], "text": []}
    for i, item in enumerate(dataset.items):
        m = ("video" if "video" in item
             else "image" if "image" in item else "text")
        groups[m].append(i)
    groups = {m: idxs for m, idxs in groups.items() if idxs}

    bsz = args.batch_size
    steps_per_epoch = max(len(dataset) // (bsz * args.grad_accum), 1)
    total_steps = args.max_steps or steps_per_epoch * args.epochs
    tcfg = (recipes.llava_pretrain if args.stage == "pretrain"
            else recipes.llava_finetune)(total_steps, args.grad_accum)
    tcfg = dataclasses.replace(tcfg, zero_stage=args.zero_stage,
                               offload_moments=args.offload_moments)
    if args.learning_rate:
        tcfg = dataclasses.replace(tcfg, learning_rate=args.learning_rate)

    n_mem = sum(star_valid_counts(cfg, args.frame_bucket))
    grid = cfg.vit.image_size // cfg.vit.patch_size
    n_img = grid * grid // (4 if cfg.projector.use_4_vision_tokens else 1)
    pad_id = tokenizer.pad_token_id or 0
    pre_len, post_len = args.pre_len, args.post_len
    seq_len = {"video": pre_len + n_mem + post_len,
               "image": pre_len + n_img + post_len, "text": args.text_len}

    losses_by_modality = make_losses(cfg, device, pre_len, n_mem, draws)
    main_modality = next(iter(groups))
    trainer = Trainer(losses_by_modality[main_modality], params, tcfg)
    step_fns = {main_modality: trainer._train_step}
    for m in groups:
        if m not in step_fns:
            step_fns[m] = trainer.compile_step(losses_by_modality[m])

    start_step = 0
    if latest_checkpoint(args.output_dir):
        step, payload = restore_checkpoint(args.output_dir,
                                           map_location=device)
        trainer.load_state(payload["params"], payload["opt_state"])
        start_step = step
        logger.info(f"resumed from checkpoint-{step}")

    # length-grouped order within each modality (the reference's
    # LengthGroupedSampler separates modalities at the megabatch level,
    # vstream_trainer.py:117-148)
    all_lengths = dataset.modality_lengths()
    orders = {}
    for m, idxs in groups.items():
        sub = length_grouped_indices([abs(all_lengths[i]) for i in idxs],
                                     args.batch_size, 1)
        orders[m] = [idxs[j] for j in sub]

    def make_group(modality: str, idx0: int):
        group, idx, order = [], idx0, orders[modality]
        for _ in range(args.grad_accum):
            samples = [dataset[order[(idx + j) % len(order)]]
                       for j in range(bsz)]
            idx += bsz
            if modality == "text":
                group.append(collate_text(samples, pad_id,
                                          fixed_len=args.text_len))
                continue
            b = collate_llava(samples, args.frame_bucket, pad_id,
                              fixed_pre_len=pre_len, fixed_post_len=post_len)
            n_vis = n_img if modality == "image" else n_mem
            out = {"input_ids": b["input_ids"],
                   "labels": spliced_labels(b, n_vis),
                   "segments": spliced_segments(b, n_vis, pad_id)}
            if modality == "image":
                out["image"] = b["image"]
            elif "features" in b:
                out["images"] = b["features"]
                out["n_frames"] = b["n_frames"]
            else:
                out["frames"] = b["frames"]
                out["n_frames"] = b["n_frames"]
            group.append(out)
        return {k: np.stack([g[k] for g in group]) for k in group[0]}, idx

    modalities = list(groups)
    # modalities interleave in proportion to their size (largest-remainder
    # pick), as the reference's sampler draws uniformly over the dataset
    schedule = proportional_schedule(
        {m: len(groups[m]) for m in modalities}, total_steps)
    cursors = {m: 0 for m in modalities}
    for s in range(start_step):                  # checkpoint-stable resume
        cursors[schedule[s]] += bsz * args.grad_accum

    def make_step_batch(step: int):
        m = schedule[step]
        batch, cursors[m] = make_group(m, cursors[m])
        return m, batch

    scalars = ScalarsWriter(args.scalars_file or
                            os.path.join(args.output_dir, "scalars.jsonl"))
    profiler = StepProfiler(args.profile_dir, start_step, args.profile_steps)
    prefetch = BackgroundPrefetcher(make_step_batch, start_step, total_steps)
    losses, kinds = [], []
    try:
        for step, (m, batch) in zip(range(start_step, total_steps),
                                    prefetch):
            t0 = time.perf_counter()
            profiler.before_step(step)
            loss = trainer.run_step(batch, step, step_fn=step_fns[m])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.after_step(step)
            dt = time.perf_counter() - t0
            losses.append(loss)
            kinds.append(m)
            n = bsz * args.grad_accum
            record = dict(loss=loss, lr=lr_at(tcfg, step), step_time_s=dt,
                          modality=m, samples_per_s=n / max(dt, 1e-9),
                          tokens_per_s=n * seq_len[m] / max(dt, 1e-9))
            scalars.write(step + 1, **record)
            logger.info(f"step {step + 1}/{total_steps} [{m}] "
                        f"loss={loss:.4f} ({dt:.2f}s)")
            if on_step is not None:
                on_step(step, trainer, record)
            if args.save_steps and ((step + 1) % args.save_steps == 0
                                    or step + 1 == total_steps):
                save_checkpoint(args.output_dir, step + 1, trainer.params,
                                trainer.opt_state)
    finally:
        # unblock the producer if the loop exits early
        prefetch.close()
        profiler.close()
        scalars.close()
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "steps": total_steps, "modalities": kinds,
            "params": trainer.params,
            "profile": getattr(profiler, "profile", None)}


def make_parser():
    p = argparse.ArgumentParser(description="Flash-VStream LLaVA training "
                                            "(PyTorch port)")
    p.add_argument("--stage", choices=["pretrain", "finetune"],
                   default="finetune")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--video-dir", type=str, default="")
    p.add_argument("--feature-dir", type=str, default=None)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="samples per micro-batch")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--video-max-frames", type=int, default=50)
    p.add_argument("--frame-bucket", type=int, default=16)
    p.add_argument("--pre-len", type=int, default=64,
                   help="fixed pre-image text length (left-padded)")
    p.add_argument("--post-len", type=int, default=192,
                   help="fixed post-image text length (right-padded)")
    p.add_argument("--text-len", type=int, default=512,
                   help="fixed sequence length of text-only batches")
    p.add_argument("--save-steps", type=int, default=100,
                   help="checkpoint every N steps and at the last; 0 = "
                        "none (unlike JAX, which always saves the last)")
    p.add_argument("--scalars-file", type=str, default=None,
                   help="JSONL scalars stream (default "
                        "<output-dir>/scalars.jsonl)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--profile-steps", type=int, default=3)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width (not ported: ROADMAP A16)")
    p.add_argument("--zero-stage", type=int, default=2, choices=(1, 2, 3),
                   help="one device runs the default only (ROADMAP A16)")
    p.add_argument("--offload-moments", action="store_true",
                   help="not ported: ROADMAP A16")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--synthetic-raw", action="store_true",
                   help="dry run on .npy frame directories, images and "
                        "text items instead of precomputed features")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run_training(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
