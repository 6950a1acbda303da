"""Real-time streaming QA server (CLI), Qwen family, one card.

Port of flash_vstream_tpu/serve/cli_server.py: a frame pacer drives clip
ingestion at --fps * --play_speed; questions fire every --question_interval
seconds and once after the stream ends; latency metrics print at the end
under the reference's names (memory_latency*, llm_latency*, conv_latency),
and the summary dict is the JAX server's.

    python -m flash_vstream_tpu_torch.serve.cli_server --dry-run --load-4bit
    python -m flash_vstream_tpu_torch.serve.cli_server --dry-run --device cpu

`--load-4bit` serves from a block-scaled int4 decoder base: every decode
matvec runs the CUDA kernel K6 (kernels/int4_matmul.py). `--load-8bit`
serves an int8 decoder and `--int8-vit` int8 ViT blocks; `--w8a8-prefill`
runs their prefill-scale matmuls as int8 x int8 products. Without a
checkpoint loader in the port (ROADMAP A10), the server builds its model
only with --dry-run (the tiny config, random weights from a torch generator
seeded 0, the byte tokenizer, 56 px frames); `run_server(args, session=...)`
serves a session built by the caller instead, such as a full-width model
from random weights. Flags of features the port does not have yet raise
NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from ..core.device import dry_run_dtype, resolve_device
from ..preprocess.video import SyntheticSource, load_video
from ..runtime.generation import GenerationConfig
from ..runtime.metrics import MetricMeter, Timer
from ..runtime.streaming import bucket_candidates, bucket_up
from ..utils.logging import build_logger

# flag (argparse attribute), its spelling, the ROADMAP item that ports it
_NOT_PORTED = (
    ("model_path", "--model-path (the checkpoint loader)", "A10"),
    ("kv_int8", "--kv-int8", "A10"),
    ("stream_output", "--stream-output", "A6/A7"),
    ("preempt", "--preempt", "A6/A7"),
    ("prefill_chunk", "--prefill-chunk", "A6/A7"),
    ("threaded_ingest", "--threaded-ingest", "A15"),
    ("save_session", "--save-session", "A7"),
    ("resume_session", "--resume-session", "A7"),
    ("ingest_devices", "--ingest-devices", "A16"),
    ("decode_devices", "--decode-devices", "A16"),
)


def _check_ported(args) -> None:
    if args.model_family != "qwen":
        raise NotImplementedError("the LLaVA family is not ported yet: "
                                  "ROADMAP A13")
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr, None):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP "
                                      f"{item}")


def _apply_quantization(params: dict, args) -> dict:
    """The reference's load_8bit / load_4bit loader options: the decoder's
    targeted weights become int8 or block-scaled int4 (`quantize_params`,
    `quantize_params4`), and with --int8-vit the ViT blocks int8 (the patch
    embedding and the merger stay as they are); --w8a8-prefill turns on the
    int8 x int8 product for prefill-scale int8 matmuls, process-wide, as
    the JAX server does."""
    from ..weights.quantize import (enable_w8a8_prefill, quantize_params,
                                    quantize_params4)
    if getattr(args, "load_4bit", False):
        params = dict(params, llm=quantize_params4(params["llm"]))
    elif getattr(args, "load_8bit", False):
        params = dict(params, llm=quantize_params(params["llm"]))
    if getattr(args, "int8_vit", False):
        params = dict(params, vit=quantize_params(params["vit"]))
    if getattr(args, "w8a8_prefill", False):
        enable_w8a8_prefill()
    return params


def build_session(args):
    """The --dry-run session: the tiny Qwen config, random weights from a
    torch generator seeded 0 on --device (f32 on the CPU, as the JAX dry
    run; bf16 on the card, the kernels' type), quantized as the flags ask,
    the byte tokenizer, 56 px frames."""
    _check_ported(args)
    if not args.dry_run:
        raise NotImplementedError(
            "serving a checkpoint needs the checkpoint loader, not ported "
            "yet: ROADMAP A10. Pass --dry-run, or a prebuilt session to "
            "run_server")
    from ..core.config import tiny_qwen_config
    from ..models.vstream_qwen import VStreamQwen, init_qwen_params
    from ..preprocess.qwen_processor import make_byte_qwen_tokenizer
    from ..runtime.streaming import QwenStreamSession
    device = resolve_device(args.device)
    cfg = tiny_qwen_config()
    params = init_qwen_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        dtype=dry_run_dtype(device))
    params = _apply_quantization(params, args)
    return QwenStreamSession(VStreamQwen(cfg, params),
                             make_byte_qwen_tokenizer(), frame_hw=(56, 56),
                             clip_size=args.clip_size,
                             bank_size=args.video_max_frames)


def _frame_side(args) -> int:
    return 56 if args.dry_run else args.frame_size


def prewarm_session(session, args, gen, logger):
    """Answer once in every memory-length bucket before the stream starts,
    then reset the stream. PyTorch compiles nothing, but the first call at a
    prompt shape pays for cuBLAS's first choices and the allocator's growth,
    and the first kernel launch loads the kernel library."""
    t0 = time.perf_counter()
    side = _frame_side(args)
    session.ingest_frames([np.zeros((side, side, 3), np.uint8)]
                          * args.clip_size)
    session.block_until_ingested()
    snapshot, _ = session._published
    q = args.question or "What is happening?"
    fm = session.cfg.flash_memory
    ns = sorted(set(bucket_candidates(fm.dam_grid_len))
                | set(bucket_candidates(fm.csm_grid_len)))
    seen = set()
    for n in ns:
        key = (bucket_up(min(n, fm.dam_grid_len), fm.dam_grid_len),
               bucket_up(min(n, fm.csm_grid_len), fm.csm_grid_len))
        if key not in seen:
            seen.add(key)
            session.answer_snapshot(snapshot, n, q, gen)
    session.reset()
    session.metrics = MetricMeter()
    logger.info(f"prewarmed {len(seen)} answer buckets in "
                f"{time.perf_counter() - t0:.1f}s")


def run_server(args, session=None) -> dict:
    """Stream the source through `session` (default: `build_session(args)`)
    and answer the questions; returns {"frames_ingested", "answers",
    "metrics"} and writes it to --output-file."""
    logger = build_logger("cli_server", args.log_file)
    _check_ported(args)
    if session is None:
        session = build_session(args)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           eos_token_ids=(session.tokenizer.eos_token_id,))
    if args.prewarm:
        prewarm_session(session, args, gen, logger)

    if args.video_file:
        src = load_video(args.video_file, fps=args.fps,
                         max_frames=args.video_max_frames)
    else:
        side = _frame_side(args)
        src = SyntheticSource(args.synthetic_frames, side, side, fps=args.fps)
    logger.info(f"stream source: {len(src)} frames at {args.fps} fps "
                f"(play_speed {args.play_speed})")

    questions: List[str] = []
    if args.questions_file:
        with open(args.questions_file) as f:
            questions = [line.strip() for line in f if line.strip()]
    elif args.question:
        questions = [args.question]

    metrics = session.metrics
    frame_interval = (1.0 / (args.fps * args.play_speed)
                      if args.play_speed > 0 else 0.0)
    next_q_time = args.question_interval
    q_idx = 0
    answers = []
    start = time.perf_counter()
    i = 0
    while i < len(src):
        clip = [src[j] for j in range(i, min(i + args.clip_size, len(src)))]
        target = start + i * frame_interval
        now = time.perf_counter()
        if args.play_speed > 0 and now < target:
            time.sleep(target - now)
        try:
            with Timer(metrics, "memory_latency"):
                session.ingest_frames(clip)
                if args.sync_every_clip:
                    session.block_until_ingested()
        except Exception as e:
            # keep streaming past a bad clip, as the reference does
            # (cli_video_stream.py:201-203)
            logger.error(f"ingest failed at frame {i}: {e}")
        i += len(clip)

        elapsed = time.perf_counter() - start
        if questions and elapsed >= next_q_time:
            q = questions[q_idx % len(questions)]
            q_idx += 1
            next_q_time += args.question_interval
            with Timer(metrics, "conv_latency"):
                ans = session.answer(q, gen)
            logger.info(f"[t={elapsed:.1f}s frames={i}] Q: {q}")
            logger.info(f"A: {ans}")
            answers.append({"t": elapsed, "frames": i, "question": q,
                            "answer": ans})

    session.block_until_ingested()
    if questions:                     # a final question after the stream
        q = questions[q_idx % len(questions)]
        with Timer(metrics, "conv_latency"):
            ans = session.answer(q, gen)
        answers.append({"t": time.perf_counter() - start, "frames": i,
                        "question": q, "answer": ans})

    summary = {"frames_ingested": i, "answers": answers,
               "metrics": metrics.as_dict()}
    logger.info("metrics:\n" + metrics.summary())
    if args.output_file:
        with open(args.output_file, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def make_parser():
    p = argparse.ArgumentParser(
        description="Flash-VStream streaming server (PyTorch port)")
    p.add_argument("--model-family", choices=["llava", "qwen"], default="qwen")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--video_file", type=str, default=None,
                   help="frame directory, or a file with a registered "
                        "decoder")
    p.add_argument("--synthetic-frames", type=int, default=64,
                   help="synthetic source length when no video given")
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--play_speed", type=float, default=1.0,
                   help="0 = ingest as fast as possible")
    p.add_argument("--video_max_frames", type=int, default=1200)
    p.add_argument("--clip-size", type=int, default=2)
    p.add_argument("--frame-size", type=int, default=224)
    p.add_argument("--question", type=str, default=None)
    p.add_argument("--questions-file", type=str, default=None)
    p.add_argument("--question_interval", type=float, default=10.0)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--flash-memory-dict", type=str, default=None)
    p.add_argument("--log_file", type=str, default=None)
    p.add_argument("--output-file", type=str, default=None)
    p.add_argument("--sync-every-clip", action="store_true")
    p.add_argument("--save-session", type=str, default=None,
                   help="not ported yet (ROADMAP A7)")
    p.add_argument("--resume-session", type=str, default=None,
                   help="not ported yet (ROADMAP A7)")
    p.add_argument("--prewarm", action="store_true",
                   help="answer once in every memory bucket before "
                        "streaming")
    p.add_argument("--load-8bit", action="store_true",
                   help="weight-only int8 decoder (reference load_8bit)")
    p.add_argument("--load-4bit", action="store_true",
                   help="block-scaled int4 decoder base (reference "
                        "load_4bit); decode matvecs run the K6 kernel")
    p.add_argument("--int8-vit", action="store_true",
                   help="weight-only int8 ViT blocks (patch merger stays "
                        "bf16)")
    p.add_argument("--w8a8-prefill", action="store_true",
                   help="with --load-8bit / --int8-vit: prefill-scale int8 "
                        "matmuls also quantize the activations per token "
                        "and run int8 x int8")
    p.add_argument("--kv-int8", action="store_true",
                   help="not ported yet (ROADMAP A10)")
    p.add_argument("--stream-output", action="store_true",
                   help="not ported yet (ROADMAP A6/A7)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="not ported yet (ROADMAP A6/A7)")
    p.add_argument("--preempt", type=int, default=0,
                   help="not ported yet (ROADMAP A6/A7)")
    p.add_argument("--ingest-devices", type=int, default=0,
                   help="not ported yet (ROADMAP A16)")
    p.add_argument("--decode-devices", type=int, default=0,
                   help="not ported yet (ROADMAP A16)")
    p.add_argument("--threaded-ingest", action="store_true",
                   help="not ported yet (ROADMAP A15)")
    p.add_argument("--dry-run", action="store_true")
    return p


def main(argv=None):
    return run_server(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
