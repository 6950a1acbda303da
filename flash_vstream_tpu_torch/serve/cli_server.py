"""Real-time streaming QA server (CLI), both families, one card.

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
runs their prefill-scale matmuls as int8 x int8 products. `--kv-int8`
keeps the answers' KV cache in int8 with per-position scales.
`--threaded-ingest` paces the ingest on a background thread
(`ThreadedIngestor`) while the questions are answered on the caller's, and
counts the clips whose work completed after their deadline
(`missed_clip_deadlines`). `--stream-output` prints each answer as it
decodes; `--preempt N` decodes
answers in chunks of N steps (and `--prefill-chunk M` prefills in chunks of
M tokens) with a host sync between chunks; `--resume-session` loads a
stream's memory before streaming and `--save-session` writes it after.
The server's model comes from `--model-path DIR`, an HF Qwen2-VL
checkpoint directory (the weights in bf16, the config from its
config.json, `--flash-memory-dict` over its Flash memory, the HF
tokenizer, which needs `transformers`, and frames of `--frame-size`), or
with --dry-run from the tiny config (random weights from a torch generator
seeded 0, the byte tokenizer, 56 px frames); `run_server(args,
session=...)` serves a session built by the caller instead.
`--model-family llava` serves a Flash-VStream-LLaVA model (CLIP, STAR
memory, projector, Vicuna): with --dry-run the tiny LLaVA config, else
the checkpoint directory in bf16 with the full config (frames resize to
CLIP's 224 px). `--ingest-devices N --decode-devices M` disaggregate a
Qwen session (parallel/serve.py): the vision tower and the memory on the
first visible card, the decoder tensor-parallel over the next M (with too
few cards the server says so and serves on one; under --device cpu the
devices are N + M CPU entries).

    python -m flash_vstream_tpu_torch.serve.cli_server --model-path DIR
    python -m flash_vstream_tpu_torch.serve.cli_server --model-family llava \
        --dry-run --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from ..preprocess.video import SyntheticSource, load_video
from ..runtime.generation import GenerationConfig
from ..runtime.metrics import MetricMeter, Timer
from ..utils.logging import build_logger

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


def _serve_placement(args):
    """The disaggregated placement --ingest-devices / --decode-devices ask
    for (JAX cli_server.py:77-94): over the visible cards, or under
    --device cpu over n_ingest + n_decode CPU entries (the counterpart of
    the JAX tests' virtual CPU devices). With too few cards it says so and
    returns None: the session serves on one device, as JAX's does."""
    from ..core.device import resolve_device
    from ..parallel.serve import make_serve_placement
    n_ingest = args.ingest_devices or 1
    n_decode = args.decode_devices or None
    device = resolve_device(args.device)
    if device.type == "cpu":
        devices = [device] * (n_ingest + (n_decode or 1))
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if len(devices) < n_ingest + 1:
        print(f"[serve] only {len(devices)} device(s) visible — "
              "disaggregation needs >= 2; falling back to the single-chip "
              "path (use --preempt so answers yield to clips)")
        return None
    return make_serve_placement(n_ingest=n_ingest, n_decode=n_decode,
                                devices=devices)


def build_session(args):
    """The server's session over `load_qwen_model`'s (or, for the LLaVA
    family, `load_llava_model`'s) model on --device (--dry-run or
    --model-path), quantized as the flags ask; a Qwen session is
    disaggregated when --ingest-devices or --decode-devices is given (the
    weights quantized first, then placed)."""
    kv_dtype = torch.int8 if args.kv_int8 else None
    if args.model_family == "llava":
        from ..runtime.pipeline import load_llava_model
        from ..runtime.streaming import LLaVAStreamSession
        cfg, params, tokenizer = load_llava_model(
            args.model_path, args.device, dry_run=args.dry_run)
        return LLaVAStreamSession(_apply_quantization(params, args), cfg,
                                  tokenizer, clip_size=args.clip_size,
                                  kv_cache_dtype=kv_dtype)
    from ..models.vstream_qwen import VStreamQwen
    from ..runtime.pipeline import load_qwen_model
    from ..runtime.streaming import QwenStreamSession
    cfg, params, tokenizer = load_qwen_model(
        args.model_path, args.device, dry_run=args.dry_run,
        flash_memory_dict=args.flash_memory_dict)
    params = _apply_quantization(params, args)
    placement = (_serve_placement(args)
                 if args.ingest_devices or args.decode_devices else None)
    side = _frame_side(args)
    return QwenStreamSession(VStreamQwen(cfg, params), tokenizer,
                             frame_hw=(side, side), clip_size=args.clip_size,
                             bank_size=args.video_max_frames,
                             kv_cache_dtype=kv_dtype, placement=placement)


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
    counts = session.prewarm_frame_counts()
    for n in counts:
        session.answer_tokens(snapshot, n, q, gen)
    session.reset()
    session.metrics = MetricMeter()
    logger.info(f"prewarmed {len(counts)} answer buckets in "
                f"{time.perf_counter() - t0:.1f}s")


def run_server(args, session=None) -> dict:
    """Stream the source through `session` (default: `build_session(args)`)
    and answer the questions; returns {"frames_ingested", "answers",
    "metrics"} and writes it to --output-file."""
    logger = build_logger("cli_server", args.log_file)
    if session is None:
        session = build_session(args)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           eos_token_ids=(session.tokenizer.eos_token_id,),
                           preemptible_chunk=args.preempt,
                           prefill_chunk=args.prefill_chunk)
    if args.prewarm:
        prewarm_session(session, args, gen, logger)
    # after the prewarm, which resets the stream (the JAX server loads
    # first, and its prewarm then drops what it loaded)
    if args.resume_session:
        session.load_session(args.resume_session)
        logger.info(f"resumed session memory from {args.resume_session} "
                    f"({session.n_frames} frame pairs already ingested)")

    def do_answer(q: str) -> str:
        """The whole answer, or with --stream-output each piece printed as
        it decodes."""
        if not args.stream_output:
            return session.answer(q, gen)
        print(f"Q: {q}\nA: ", end="", flush=True)
        pieces = []
        for piece in session.answer_stream(q, gen):
            print(piece, end="", flush=True)
            pieces.append(piece)
        print(flush=True)
        return "".join(pieces)

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

    def ask(elapsed: float, frames: int) -> None:
        nonlocal q_idx, next_q_time
        q = questions[q_idx % len(questions)]
        q_idx += 1
        next_q_time += args.question_interval
        with Timer(metrics, "conv_latency"):
            ans = do_answer(q)
        logger.info(f"[t={elapsed:.1f}s frames={frames}] Q: {q}")
        logger.info(f"A: {ans}")
        answers.append({"t": elapsed, "frames": frames, "question": q,
                        "answer": ans})

    if args.threaded_ingest:
        # a pacing thread ingests while this thread answers: a long answer
        # never holds the stream back
        from ..runtime.streaming import ThreadedIngestor
        ing = ThreadedIngestor(
            session, list(src),
            fps=args.fps * args.play_speed if args.play_speed > 0 else 0.0,
            clip_size=args.clip_size).start()
        while not ing.wait(timeout=0.05):
            elapsed = time.perf_counter() - start
            if session.n_frames == 0:
                continue                  # nothing published yet
            if questions and elapsed >= next_q_time:
                ask(elapsed, ing.frames_ingested)
        ing.stop()
        if ing.error is not None:
            logger.error(f"ingest failed at frame {ing.frames_ingested}: "
                         f"{ing.error}")
        i = ing.frames_ingested
        metrics.update("missed_clip_deadlines", ing.missed_deadlines)
    else:
        i = 0
        while i < len(src):
            clip = [src[j] for j in range(i, min(i + args.clip_size,
                                                 len(src)))]
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
                ask(elapsed, i)

    session.block_until_ingested()
    if questions:                     # a final question after the stream
        q = questions[q_idx % len(questions)]
        with Timer(metrics, "conv_latency"):
            ans = do_answer(q)
        answers.append({"t": time.perf_counter() - start, "frames": i,
                        "question": q, "answer": ans})

    summary = {"frames_ingested": i, "answers": answers,
               "metrics": metrics.as_dict()}
    if args.save_session:
        session.save_session(args.save_session)
        logger.info(f"saved session memory to {args.save_session}")
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
                   help="write the stream's memory here at the end "
                        "(resumable with --resume-session)")
    p.add_argument("--resume-session", type=str, default=None,
                   help="load a saved stream's memory before streaming")
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
                   help="int8 KV cache with per-position scales (half the "
                        "bf16 cache's bytes)")
    p.add_argument("--stream-output", action="store_true",
                   help="print each answer's text as it decodes (stepwise; "
                        "--preempt does not apply)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="with --preempt: prefill the prompt in sequence "
                        "chunks of this many tokens, a host sync after "
                        "each. 0 = one prefill")
    p.add_argument("--preempt", type=int, default=0,
                   help="decode answers in chunks of this many steps with "
                        "a host sync between chunks (0 = one loop)")
    p.add_argument("--ingest-devices", type=int, default=0,
                   help="disaggregated serve: vision tower + memory on the "
                        "first of this many devices (Qwen family)")
    p.add_argument("--decode-devices", type=int, default=0,
                   help="disaggregated serve: decoder tensor-parallel over "
                        "this many devices after the ingest ones (0 = the "
                        "rest; one under --device cpu)")
    p.add_argument("--threaded-ingest", action="store_true",
                   help="ingest on a pacing thread while answering on this "
                        "one; the summary's metrics count "
                        "missed_clip_deadlines")
    p.add_argument("--dry-run", action="store_true")
    return p


def main(argv=None):
    return run_server(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
