#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (flash_vstream_tpu_torch) on one
NVIDIA Hopper card.

    python3 chip_smoke.py [--only PHASE,...] [--profile DIR]

Phases, one or more lines each; any failure raises and exits non-zero
(serve_http, offline, train_slice, production and finetune_ckpt run the
Qwen2-VL-7B decoder at QWEN_LAYERS of its 28 layers, every width full):

1. environment: refuses to run without CUDA; prints the card's name and
   power limit (nvidia-smi) and the torch / CUDA versions;
2. build: compiles the CUDA kernels from csrc/ with nvcc into build/;
3. kernels: K1 (flash attention) and K2 (row gather) against their plain
   PyTorch versions at the slice's own shapes, with times; K1 first shows
   its ptxas registers and SASS counts, is held row by row at the ViT's
   224 and 448 px shapes, the prefill, a masked row, the varlen ViT of a
   448 x 448 and a 392 x 504 image (and two grids padded with -1) and the
   tile cases, equal bit for bit at every rows per block, and timed at
   each beside SDPA and its bound;
   int4_kernel: K6 (int4 decode matvec) against its plain version at the
   7B decoder's shapes (B 1; 8 and 32 for the MLP), with times, the bound
   and torch's own int4 matmul beside it, its plan (cluster, warps, rows),
   one launch a call and the same bits run to run; first the B = 1
   kernel's ptxas registers and spills and SASS counts (it fails without
   HMMA, with any I2F or with a spill);
4. reference: a small two-layer model (head dims 80 and 128, the 7B
   config cut in width and depth) streamed
   through the port on the card and on the CPU (plain versions), compared;
   int4_reference: that model's decoder quantized to int4, card (K6) vs
   CPU (dequantize path), prefill and 8 teacher-forced decode steps;
   entry: the driver-entry forward (flash_vstream_tpu_torch/entry.py) at
   its real scale: the 32-layer Qwen2-VL vision tower, Flash memory, the
   merger and a Qwen2-VL-2B-shaped decoder (28 layers, width 1,536) in
   bf16 over 16 frames of 224 px: finite logits, ms a forward, the peak
   memory, held to the same forward with K1's plain version within 5e-2
   of each logit row's max, and against the same weights in f32 no
   further than 1.05 times the plain bf16 forward (a planted fault, K1's
   output x 0.95, must fail both);
5. slice: the full-width Qwen2-VL-7B streaming session with random weights:
   21 clips ingested (one warm-up), memory saturated, 3 greedy answers,
   with the launch counts of both kernels during ingest and answering;
   disaggregated (right after slice, on its weights at all 28 layers):
   serving across devices on one card, its devices listed more than
   once: a placed session (ingest on the card, the decoder split over
   [card] * 2) against a one-device session over 16 clips of 8 frames
   (snapshots bit-equal), two answers and a stream, ids by the near-tie
   rule on teacher-forced logits within OFFLINE_LOGIT_TOL; the decoder at
   tp 1, 2 and 4 (prefill ms, decode ms/token; busy with --profile), tp
   4's ids and a planted fault (a partial left out of the all-reduce); an
   answer on a thread while clips ingest; save / reset / load keep the
   placement;
   video_io (right after disaggregated, on the slice's weights at
   QWEN_LAYERS): real video in: the host I/O library built from its C++
   source with the host compiler, the committed MJPEG mp4 fixture
   (tests/data/video) demuxed and decoded by the port's own JPEG decoder
   bit-equal to its JPEG frame directory and to the expected frames, the
   load_video chain as the machine has it, decode ms a frame at 224 and
   448 px; cli_server's --video_file path in process over the mp4 (16
   frames of 224 px in clips of 8, one answer of up to 17 ids) with the
   answer's ids equal to the same session fed the frames as arrays; ingest
   ms/clip with the decode inline and through PrefetchLoader;
   serve_http: the port's HTTP server over the slice's weights, two
   streams (the second a clone) fed .npy frames, greedy, SSE, preemptible
   (decode chunks of 8, prefill chunks of 512), speculative (k 4) and
   sampled answers over HTTP, each held to the greedy ids or to itself,
   `_sample` card vs CPU, a clone's memory against a solo session's, a
   save/load round trip; seconds and ms/token per answer, the prefill
   one-shot and in chunks, speculation's acceptance, the K1/K2 launches;
   offline: offline QA over the slice's weights: QwenPipeline answers a
   question over 240 frames of 448 px (S about 11.6k; encode, prefill and
   decode timed, the peak memory), its one-shot prefill held to a prefill
   in chunks of 2,048 (first-token logits, greedy ids) and to itself with
   one seed, two images (448 x 448, 392 x 504) through the varlen ViT; the
   weights written as a sharded safetensors checkpoint and loaded back
   bit-equal (write and load timed); the eval worker on the loaded weights
   (an MCQ sample and a consistency pair, each pred the in-memory
   pipeline's) and `eval_any_dataset --dry-run --num-chunks 2` with two
   card workers; K1's launches checked against the reckoned count;
   llava: the LLaVA family at full width (VStreamLLaVAConfig(): CLIP
   ViT-L/14, STAR memory, mlp2x_gelu, Vicuna-7B) on random bf16 weights:
   a stream of 80 frames in clips of 8 (the 64-frame bank wraps) answered
   before saturation and after the wrap (ingest ms a clip, prefill,
   ms/token, busy; answer_stream, preemptible, prefill-chunked and
   speculative ids against greedy, parting only at a tie of greedy's bf16
   logits; an int8 cache teacher-forced), LLaVAPipeline over 50 frames and
   a 336 x 448 image, card vs CPU at 2 + 2 layers, `run_server
   --model-family llava --load-4bit` (K6 at Vicuna's shapes, timed beside
   `_weight_int4pack_mm`), a depth-4 checkpoint round trip; K1 and K6
   launches against the counts reckoned as the steps run;
6. backward: K4/K5's ptxas registers and SASS counts first; K3 (forward +
   lse), K4 (dq) and K5 (dk/dv) against their plain versions at the
   training shape, two small edge cases and the tile cases, K4/K5 equal bit
   for bit run to run and at 64 and 128 rows per block, with times (K4/K5
   at each rows per block);
7. function: FlashAttentionFunction on the card against autograd of the
   plain attention;
8. train_reference: one LoRA loss + backward of the small model on the card
   (kernels, bf16) and on the CPU (plain versions, f32 on the same bf16
   weights), compared; two faults planted in the card's attention
   backward, dk x 0.9 and a misrouted dq, must fail;
   dry_run_train: the trainer's --dry-run on the card (C1): the entry
   point with no --device, then its inputs in bf16 through K3, K4, K5 at
   the tiny head dims (zero-padded to 64) against the CPU run, the
   adapters' updates after step 2 compared;
   train_parallel: training across ranks at full width (QWEN_LAYERS
   decoder layers), two ranks on the one card over gloo: sp 2 and pp 2
   against one rank's decoder (hidden states, adapter and final_norm
   gradients; a ring step that moves nothing and final_norm summed over pp
   twice must fail), run_training --zero-stage 3 --offload-moments over 2
   ranks against one rank at the global batch (first-step gradients, the
   adapters after 2 steps, each rank's share of the base); finetune_flash
   --dry-run --pp 2 and --sp 2 under torch.distributed.run; at world 1
   --zero-stage 3 --offload-moments bit-equal to --zero-stage 2; tp 2:
   LLaVA stage 2 at full width (Vicuna-7B at 4 layers, CLIP at 2) through
   train.run_training --tp 2 against one rank at the global batch (losses,
   first-step gradients gathered over tp, updates after 2 steps, CLIP's
   split features; a row product left unsummed on one rank must fail); the
   path's K1/K3/K4/K5 launches summed over the ranks (--ranks 4 on a
   four-card machine: a card a rank over NCCL, dp 2 x tp 2);
9. train_slice: `run_training` on Qwen2-VL-7B at full width (random bf16
   base, the serving slice's weights), 240 frames of 224 px, max_len 4096,
   grad_accum 2, 3 optimizer steps, with the launch counts of K1, K3, K4, K5;
10. production: one step at 448 px, 240 frames, max_len 14,000, its peak
   memory; then K4, K5 and SDPA's backward timed at the step's own
   attention shape and segment ids (read from its first backward call);
   finetune_ckpt: `run_training --model-path` on the offline phase's 7B
   checkpoint, 2 steps each over the bf16, int8 and int4 (QLoRA) bases at
   the train slice's shape: finite losses, adapters moved, the base
   bit-identical, K3 = 2 x K4 and K6 never under autograd; the bf16 run's
   --export-merged file read back and equal bit for bit to merge_lora on
   the card; one int4 step at the production shape, its peak memory below
   the bf16 step's;
   serve_kv8: the streaming session over an int8 KV cache at full width,
   saturated: greedy answers against the bf16 cache's (31 of 32 tokens),
   preemptible and speculative answers equal to greedy, the decoder's
   ms/token and cache bytes over both caches, and --load-4bit --kv-int8
   with K6 at 197 launches a decode step;
11. serve4: the CLI server over the slice's weights quantized to a 4-bit
   decoder (--load-4bit): 168 frames paced at 8 fps, 3 answers, K6 in every
   decode matvec, K1/K2/K6 launched exactly as reckoned and no error logged;
   full-width logits K6 vs the dequantize path; decode and prefill times;
   the --dry-run --load-4bit server as a subprocess;
12. bank_gather: P1 (bulk-copy bank gather) bit-exact against its plain
   version in bf16 and f32 at the DAM-gather probe's shape and odd shapes,
   each launched grid (as the C entry reports it) the plan's and one wave
   (no more blocks than the driver says the card holds at once), its plan
   printed; P1, K2, index_select and the one-hot matmul
   timed, and P1 at K 1; the probe (scripts/probe_bank_gather.py) at its
   defaults, P1/K2 launches exact;
13. vit_probe: P2 (frame-local attention) against its plain version at the
   ViT's 224 and 448 px frame shapes, head blocks 1 and 8 bit for bit,
   timed beside K1 and SDPA, with its ptxas registers and SASS counts; the
   ViT probe (scripts/probe_vit_variants.py) at full width, every mode,
   bf16, --int8-weight-only and --int8, and at 448 px base, framekernel
   and xlaattn in bf16, K1/P2 launches exact; w8a8 `dense`
   against weight-only int8 at prefill shapes; the --dry-run --load-8bit
   --int8-vit --w8a8-prefill server as a subprocess;
14. int4_probe: P3 (int4 matvec variants v1-v5, v7) and P4 (bf16 matvec
   v6) against their plain versions at the int4 probe's default shape and
   small odd shapes at 4, 8 and 16 packed rows per thread per step, timed
   beside their bound, torch's int4 or bf16 matmul and K6, with the SASS
   instruction counts of the built kernels; v1, v2, v3, v5 and v7 (K6's
   B = 1 kernel with the unbiased, per-element, unscaled, packed and ones
   conversions) and v6 (its own B = 1 bf16 kernel, csrc/bf16_b1.cuh) first
   with their ptxas registers and spills and SASS counts (each fails
   without HMMA or with a spill at group 4, v2 without I2FP, the others
   with any I2F or I2FP, v6 also with any F2FP, v1 without its bf16x2
   subtract HADD2.BF16_V2, v3 and v7 with any LDGSTS), then bit-identical
   run to run and one device kernel a call; the probe
   (scripts/probe_int4_variants.py) at its defaults through main and main2,
   every variant's launches exact;
15. llava_train (after multistream, on the llava phase's weights, trained
   in place): the LLaVA family's training at the full width of
   VStreamLLaVAConfig(): K3/K4/K5 against their plain versions at the
   finetune stage's attention shape [16, 32, 937, 128] (causal, the
   collator's -1 padding) and K1 at the raw-frame step's CLIP shape, timed
   beside SDPA; the card against the CPU at reduced depth (loss and every
   trained leaf's gradient, then two steps' bf16 update sliced on the
   card against the CPU's whole update on the same gradients, each with
   a planted fault refused); then the path:
   stage 1 (--stage pretrain, micro-batch 32) and stage 2 (--stage
   finetune, micro-batch 16, every Vicuna-7B leaf trained on the card)
   through run_training over synthetic features at the real shape (S
   937): step s, tokens/s, peak beside the reckoned state, launches a
   step, which parts moved; one step each of raw `.npy` frames, images and
   text; run_training's entry point at decoder depth 4 with a resume equal
   to an uninterrupted run; extract_features and the eval worker, its ids
   equal to LLaVAPipeline's.

`--profile DIR` also traces one training-slice step with torch.profiler and
writes its kernel table there, and profiles the disaggregated phase's
decode at tp 1, 2 and 4 (device busy a token; about 30 s a session).
The line before the last is one JSON object
with each kernel's launches (in the run of the path it was ported for, and
per path under `launches_by_path`), error, times, bound and the unit they
are per (`per`: one call, or K6's decode token); the last is the device
record {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import contextlib
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 0
N_CLIPS = 20
# decoder depth of the Qwen2-VL-7B paths serve_http, offline, train_slice,
# production and finetune_ckpt (views of the slice's first layers), of the
# config's 28, every width full: the script's time limit (the whole script
# read 1,201-1,222 s at 28 on a slower host). slice, serve_kv8, serve4 and
# multistream keep 28: at 12, serve_kv8's speculative int8 answer parted
# from greedy at a near tie of two alternating tokens
QWEN_LAYERS = 12
PEAK_BF16 = 989e12       # H100 SXM dense bf16 FLOP/s
PEAK_HBM = 3.35e12       # H100 SXM HBM bytes/s
QUESTIONS = ("What is happening in the video?",
             "Which objects appear most often?",
             "Describe the last scene in one sentence.")


def _ms(fn, iters, windows=3):
    """Device time per call in ms: `iters` calls captured in one CUDA graph,
    replayed `windows` times between CUDA events, best window. Replay keeps
    the host's launch overhead out of the number. `fn(i)` gets the call's
    index, so a caller can rotate through inputs."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    best = float("inf")
    for _ in range(windows):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / iters)
    del graph
    return best


def _eager_ms(fn, iters):
    """Time per call of `iters` eager calls between CUDA events: the device
    time or the host's time to launch the call, whichever is longer (for a
    kernel of a few microseconds, the wrapper's host cost)."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations over the bf16 tensor-core peak and the bytes over the
    HBM rate."""
    t_ops, t_mem = flops / PEAK_BF16 * 1e3, nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _visible_pairs(q, k, causal, q_seg, kv_seg):
    """(query, key) pairs that attend, summed over batch and q heads."""
    from flash_vstream_tpu_torch.kernels.flash_attention import _visible
    return int(_visible(q, k, causal, q_seg, kv_seg).sum()) * q.shape[1]


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def _tree_float(tree):
    """A nested dict (or list) of tensors with its floating leaves in
    f32."""
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_float(v) for v in tree)
    if hasattr(tree, "is_floating_point") and tree.is_floating_point():
        return tree.float()
    return tree


def _tree_nbytes(tree):
    """Bytes of a nested dict (or list) of tensors and tuple leaves
    (quantized weights, NTMParams)."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_nbytes(v) for v in tree)
    return _nbytes(*tree) if isinstance(tree, tuple) else _nbytes(tree)


def _row_err(got, want, rows):
    """The largest, over the rows selected by `rows` (a bool mask of the
    leading dims), of the row's max |got - want| over its own max |want|.
    Each row is held to its own scale, so the large gradients of a causal
    run's first rows cannot hide an error in the many small later ones."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    r = (err / scale)[rows]
    return r.max().item() if r.numel() else 0.0


# FlashAttentionFunction's gradients against autograd of the plain attention,
# relative L2 per head. The two formulations alone read ~3.5e-3 in bf16 on
# the CPU (tests/test_torch_attention_backward.py reads it).
HEAD_L2_LIMIT = 1e-2


def head_l2_err(got, want):
    """The largest, over heads (dim 1), of |got - want| / |want| in L2."""
    d = (got.float() - want.float()).square().sum((0, 2, 3)).sqrt()
    return (d / want.float().square().sum((0, 2, 3)).sqrt()
            .clamp_min(1e-30)).max().item()


def _grad_rows(q, k, kw):
    """Rows to hold one by one: of dq, the queries that see two keys or more
    (a query that sees one key has a gradient of 0 up to rounding, held by
    the whole-tensor bound); of dk/dv, the keys some query sees. [B, Hq, Sq]
    and [B, Hkv, Skv] bool."""
    from flash_vstream_tpu_torch.kernels.flash_attention import _visible
    vis = _visible(q, k, kw.get("causal", False), kw.get("q_segment_ids"),
                   kw.get("kv_segment_ids"))[:, 0, 0]          # [B, Sq, Skv]
    return ((vis.sum(-1) >= 2)[:, None].expand(-1, q.shape[1], -1),
            vis.any(1)[:, None].expand(-1, k.shape[1], -1))


def _sdpa(q, k, v, causal):
    """torch's fused attention at the same shape (GQA, no segment mask):
    the library yardstick, timed only."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def _k1_instance(name):
    """The K1/K3 kernel instance a SASS or ptxas function name matches
    (flash_fwd<D>), or None."""
    m = re.search(r"flash_fwd_kernelILi(\d+)E", name)
    return f"flash_fwd<{m.group(1)}>" if m else None


K1_INSTANCES = 3           # head dims 64, 80, 128
K1_SASS = ("LDSM", "LDGSTS", "HMMA", "MUFU", "LDS.U16")


def check_k1_build():
    """K1/K3's ptxas registers and spills and its SASS counts per instance;
    fails unless every instance loads fragments by ldmatrix (LDSM) and K/V
    by cp.async (LDGSTS), and none reads shared memory 16 bits at a time
    (the first version's V loads)."""
    from flash_vstream_tpu_torch.kernels import _build
    lib = _build.library_path()
    ptxas = _ptxas_counts(lib.with_suffix(".log"), _k1_instance)
    sass = _sass_counts(lib, _k1_instance, full=True)
    counts = {}
    for inst in sorted(ptxas):
        regs, st, ld = ptxas[inst]
        ops = sass.get(inst, {}) if isinstance(sass, dict) else {}
        counts[inst] = {op: sum(n for o, n in ops.items()
                                if o == op or o.startswith(op + "."))
                        for op in K1_SASS}
        print(f"K1 ptxas {inst}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B; sass instructions={sum(ops.values())} "
              + " ".join(
                  f"{op}={n}" for op, n in counts[inst].items()), flush=True)
    if not isinstance(sass, dict) or len(ptxas) < K1_INSTANCES or not all(
            c["LDSM"] and c["LDGSTS"] and not c["LDS.U16"]
            for c in counts.values()):
        raise AssertionError(f"K1: ptxas {ptxas}, sass {counts}: expected "
                             f"{K1_INSTANCES} instances, each with LDSM and "
                             f"LDGSTS and no LDS.U16")


def _bwd_instance(name):
    """The K4 or K5 kernel instance a SASS or ptxas function name matches
    (dq<D>, dkv<D>; not K5's second pass, which sums partials), or None."""
    m = re.search(r"flash_bwd_(dq|dkv)_kernelILi(\d+)E", name)
    return f"{m.group(1)}<{m.group(2)}>" if m else None


BWD_INSTANCES = 6          # K4 and K5 at head dims 64, 80, 128


def check_bwd_build():
    """K4/K5's ptxas registers and spills and their SASS counts per
    instance; fails unless every instance loads fragments by ldmatrix
    (LDSM) and its tiles by cp.async (LDGSTS), and none reads shared memory
    16 bits at a time (the first version's B fragments)."""
    from flash_vstream_tpu_torch.kernels import _build
    lib = _build.library_path()
    ptxas = _ptxas_counts(lib.with_suffix(".log"), _bwd_instance)
    sass = _sass_counts(lib, _bwd_instance, full=True)
    counts = {}
    for inst in sorted(ptxas):
        regs, st, ld = ptxas[inst]
        ops = sass.get(inst, {}) if isinstance(sass, dict) else {}
        counts[inst] = {op: sum(n for o, n in ops.items()
                                if o == op or o.startswith(op + "."))
                        for op in K1_SASS}
        print(f"backward ptxas {inst}: {regs} registers, spill stores {st} "
              f"B, spill loads {ld} B; sass instructions={sum(ops.values())} "
              + " ".join(
                  f"{op}={n}" for op, n in counts[inst].items()), flush=True)
    if not isinstance(sass, dict) or len(ptxas) < BWD_INSTANCES or not all(
            c["LDSM"] and c["LDGSTS"] and not c["LDS.U16"]
            for c in counts.values()):
        raise AssertionError(f"K4/K5: ptxas {ptxas}, sass {counts}: expected "
                             f"{BWD_INSTANCES} instances, each with LDSM and "
                             f"LDGSTS and no LDS.U16")


def check_bwd_bits(name, args, kw, grads):
    """K4 then K5 at every rows per block the C entries take, the plan's
    first (so it runs twice: run to run): dq, delta, dk and dv the same
    bits as `grads`, the plan's first run."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    q, k, v, out, do, lse = args
    causal = kw.get("causal", False)
    seg = (kw.get("q_segment_ids"), kw.get("kv_segment_ids"))
    for rows in (None, *fa.BWD_ROWS_PER_BLOCK):
        dq, delta = torch.empty_like(q), torch.empty_like(lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        fa._launch_bwd("dq", q, k, v, out, do, lse, delta, dq, None, None,
                       causal, *seg, None, rows_per_block=rows)
        fa._launch_bwd("dkv", q, k, v, out, do, lse, delta, None, dk, dv,
                       causal, *seg, None, rows_per_block=rows)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv),
                                                     grads)):
            raise AssertionError(f"backward {name}: "
                                 f"{rows or 'the plan'}'s rows per block "
                                 f"differ from the first run's bits")


def _fwd_seen(q, k, kw):
    """[B, Hq, Sq] bool: the query rows that see at least one key."""
    from flash_vstream_tpu_torch.kernels.flash_attention import _visible
    return (_visible(q, k, kw.get("causal", False), kw.get("q_segment_ids"),
                     kw.get("kv_segment_ids"))[:, 0, 0].any(-1)[:, None]
            .expand(-1, q.shape[1], -1))


def check_fwd(name, got, want, q, k, kw):
    """K1/K3's output against the plain version's: (max abs err, row err).
    Fails past 2e-2 absolute over the tensor, past ROW_TOL of its own max
    in any row that sees a key (`_row_err`), or if a row that sees no key
    is not exactly 0."""
    import torch
    from flash_vstream_tpu_torch.kernels.flash_attention import ROW_TOL
    seen = _fwd_seen(q, k, kw)
    err = (got.float() - want.float()).abs().max().item()
    row = _row_err(got, want, seen)
    if not torch.isfinite(got).all() or err > 2e-2 or row > ROW_TOL:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} (limit 2e-2), "
                             f"row err {row:.3e} (limit {ROW_TOL:.0e} of the "
                             f"row's max) or non-finite output")
    if got[~seen].any():
        raise AssertionError(f"{name}: a row that sees no key is not 0")
    return err, row


def check_fwd_bits(name, args, kw, out, lse=None):
    """K1 (lse None) or K3 at every rows per block the C entry takes: the
    same output (and lse) bits as the plan's."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    for rows in fa.ROWS_PER_BLOCK:
        l2 = None if lse is None else torch.empty_like(lse)
        o2, _ = fa._launch_fwd(*args, l2, kw.get("causal", False),
                               kw.get("q_segment_ids"),
                               kw.get("kv_segment_ids"), None, name,
                               rows_per_block=rows)
        torch.cuda.synchronize()
        if not torch.equal(o2, out) or (lse is not None
                                        and not torch.equal(l2, lse)):
            raise AssertionError(f"{name}: {rows} rows per block differ from "
                                 f"the plan's bits")


def _fwd_ms_by_rows(args, kw, iters, lse=None):
    """K1 (or K3, given an lse buffer) timed at every rows per block the C
    entry takes, as one printable string: what the plan's choice is
    measured against."""
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    times = [_ms(lambda i: fa._launch_fwd(
        *args, lse, kw.get("causal", False), kw.get("q_segment_ids"),
        kw.get("kv_segment_ids"), None, "K1", rows_per_block=rows), iters)
        for rows in fa.ROWS_PER_BLOCK]
    return "ms by rows per block " + " ".join(
        f"{r}={t:.4f}" for r, t in zip(fa.ROWS_PER_BLOCK, times))


def tile_case(dev, g, name):
    """A TILE_CASES entry as bf16 card tensors (from `g`) and keywords."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Sq, Skv, D, causal, q_runs, kv_runs = fa.TILE_CASES[name]
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev)
               .to(torch.bfloat16)
               for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    return (q, k, v), dict(
        causal=causal, q_segment_ids=fa.segment_ids(q_runs, B, Sq, dev),
        kv_segment_ids=fa.segment_ids(kv_runs, B, Skv, dev))


def check_kernels(dev):
    """K1 and K2 against their plain versions at the slice's shapes. K1:
    its ptxas and SASS counts first; the ViT's frame attention at 224 and
    448 px (strided views), the answer prefill, a masked row, the varlen
    ViT of a 448 x 448 and a 392 x 504 image and of two grids padded with
    -1, and the tile cases (`TILE_CASES`), each held by `check_fwd` and
    equal bit for bit at every rows per block; the timed shapes beside SDPA
    and the bound."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_reference)
    from flash_vstream_tpu_torch.kernels.gather_rows import (
        gather_rows_cuda, gather_rows_reference)
    from flash_vstream_tpu_torch.models.qwen2_vit import prepare_vit_inputs

    check_k1_build()
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def heads(T, P, H, D):      # the ViT's [T, P, H, D] -> [T, H, P, D] view
        return randn(T, P, H, D).transpose(1, 2)

    # a prompt's segment row as the session builds it: text, memory with a
    # -1 run of padded slots, the question, a -1 tail
    S = 3008
    seg = torch.zeros(1, S, dtype=torch.int32, device=dev)
    seg[:, 64 + 1920 + 720:64 + 2880] = -1
    seg[:, 64 + 2880 + 40:] = -1
    # the LLaVA answer's prompt: 35 text ids, 681 memory slots of which the
    # last 17 are padding (-1, inside the sequence), the question padded
    # from 20 to 32 ids
    S_v = 35 + 681 + 32
    seg_v = torch.zeros(1, S_v, dtype=torch.int32, device=dev)
    seg_v[:, 35 + 664:35 + 681] = -1
    seg_v[:, 35 + 681 + 20:] = -1
    q_seg = torch.zeros(2, 100, dtype=torch.int32, device=dev)
    q_seg[:, 17] = 5                      # an id no key has: a masked row
    kv_seg = torch.zeros(2, 100, dtype=torch.int32, device=dev)
    cases = {
        "vit_full": ((heads(4, 256, 16, 80), heads(4, 256, 16, 80),
                      heads(4, 256, 16, 80)), {}),
        "vit_small": ((heads(4, 64, 16, 80), heads(4, 64, 16, 80),
                       heads(4, 64, 16, 80)), {}),
        "vit_448": ((heads(4, 1024, 16, 80), heads(4, 1024, 16, 80),
                     heads(4, 1024, 16, 80)), {}),
        "prefill": ((randn(1, 28, S, 128), randn(1, 4, S, 128),
                     randn(1, 4, S, 128)),
                    dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)),
        "masked_row": ((randn(2, 4, 100, 64), randn(2, 4, 100, 64),
                        randn(2, 4, 100, 64)),
                       dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg)),
        # CLIP ViT-L/14 over a clip of 8 frames: 257 tokens, head_dim 64
        "clip_l14": ((heads(8, 257, 16, 64), heads(8, 257, 16, 64),
                      heads(8, 257, 16, 64)), {}),
        "vicuna_prefill": ((randn(1, 32, S_v, 128), randn(1, 32, S_v, 128),
                            randn(1, 32, S_v, 128)),
                           dict(causal=True, q_segment_ids=seg_v,
                                kv_segment_ids=seg_v)),
    }
    # the varlen ViT of a still image (one segment of h*w tokens, mha's
    # [1, S, H, D] -> [1, H, S, D] views): 448 x 448 px and 392 x 504 px,
    # then two grids padded with -1 to a length that is no multiple of 64
    for name, grids, pad in (("vit_image_448", [(1, 32, 32)], 1024),
                             ("vit_image_392x504", [(1, 28, 36)], 1008),
                             ("vit_varlen_padded", [(1, 28, 36), (1, 4, 6)],
                              1100)):
        _, ids = prepare_vit_inputs(grids, pad)
        ids = torch.as_tensor(ids, device=dev)[None].contiguous()
        cases[name] = ((heads(1, pad, 16, 80), heads(1, pad, 16, 80),
                        heads(1, pad, 16, 80)),
                       dict(q_segment_ids=ids, kv_segment_ids=ids))
    cases.update({name: tile_case(dev, g, name) for name in fa.TILE_CASES})
    timed = ("vit_full", "vit_small", "vit_448", "prefill", "vit_image_448",
             "vit_image_392x504", "clip_l14", "vicuna_prefill")
    k1_err, k1_times = 0.0, {}
    for name, (args, kw) in cases.items():
        out = flash_attention_cuda(*args, **kw)
        ref = flash_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err, row = check_fwd(f"K1 {name}", out, ref, args[0], args[1], kw)
        check_fwd_bits(f"K1 {name}", args, kw, out)
        k1_err = max(k1_err, err)
        plan = fa._launch_plan(*args[0].shape)
        line = (f"K1 {name}: shape q{tuple(args[0].shape)} "
                f"k{tuple(args[1].shape)} "
                f"{kw.get('causal', False) and 'causal ' or ''}"
                f"{'segments ' if 'q_segment_ids' in kw else ''}"
                f"max_abs_err={err:.3e} row_err={row:.3e} (limit "
                f"{fa.ROW_TOL:.0e} of the row's max), equal bit for bit at "
                f"rows per block {'/'.join(map(str, fa.ROWS_PER_BLOCK))}; "
                f"plan {plan.blocks} blocks of {plan.rows_per_block} rows")
        if name in timed:
            q, k, v = args
            iters = 50 if name in ("vit_full", "vit_small", "clip_l14") else 20
            ms = _ms(lambda i: flash_attention_cuda(*args, **kw), iters)
            plain = _ms(lambda i: flash_attention_reference(*args, **kw), 5)
            lib = _ms(lambda i: _sdpa(q, k, v, kw.get("causal", False)),
                      iters)
            bound = _bound(
                _visible_pairs(q, k, kw.get("causal", False),
                               kw.get("q_segment_ids"),
                               kw.get("kv_segment_ids")) * 4 * q.shape[-1],
                _nbytes(q, k, v, q, kw.get("q_segment_ids"),
                        kw.get("kv_segment_ids")))     # o is q-sized
            k1_times[name] = (ms, plain, lib, bound)
            line += (f" kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                     f"bound_ms={bound[0]:.4f} ({bound[1]}) library_ms="
                     f"{lib:.4f} (scaled_dot_product_attention"
                     f"{', causal only, no segment mask' if kw else ''}); "
                     + _fwd_ms_by_rows(args, kw, iters))
        print(line, flush=True)
    ms, plain, k1_lib, k1_bound = k1_times["prefill"]

    # 30 frames out of the 1024-frame bank; 32 index sets rotate so the
    # timed reads come from device memory, not from the 50 MB L2
    bank = randn(1024, 256, 1280)
    idxs = [torch.randint(0, 1024, (30,), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32) for _ in range(32)]
    for idx in idxs:
        if not torch.equal(gather_rows_cuda(bank, idx),
                           gather_rows_reference(bank, idx)):
            raise AssertionError("K2: gather is not bit-exact")
    k2_ms = _ms(lambda i: gather_rows_cuda(bank, idxs[i % 32]), 64)
    k2_plain = _ms(lambda i: gather_rows_reference(bank, idxs[i % 32]), 64)
    lidx = [i.long() for i in idxs]
    k2_lib = _ms(lambda i: bank.index_select(0, lidx[i % 32]), 64)
    k2_bound = _bound(0, 2 * _nbytes(bank[:30]) + _nbytes(idxs[0]))
    print(f"K2 dam_gather: bank{tuple(bank.shape)} bf16 idx[30] bit-exact "
          f"kernel_ms={k2_ms:.4f} plain_ms={k2_plain:.4f} "
          f"bound_ms={k2_bound[0]:.4f} ({k2_bound[1]}) "
          f"library_ms={k2_lib:.4f} (index_select)", flush=True)
    return {
        "flash_attention_fwd": dict(
            max_abs_err=k1_err, ms=ms, plain_ms=plain, bound_ms=k1_bound[0],
            bound_by=k1_bound[1], library_ms=k1_lib),
        "gather_rows": dict(
            max_abs_err=0.0, ms=k2_ms, plain_ms=k2_plain,
            bound_ms=k2_bound[0], bound_by=k2_bound[1], library_ms=k2_lib),
    }


# K6 at the 7B decoder's shapes: (name, din, dout, calls per decode token)
K6_SHAPES = (("wq/wo", 3584, 3584, 56), ("wk/wv", 3584, 512, 56),
             ("gate/up", 3584, 18944, 56), ("down", 18944, 3584, 28),
             ("lm_head", 3584, 152064, 1))
# K6 at Vicuna-7B's shapes (the LLaVA family under --load-4bit): 32 layers of
# wq/wk/wv/wo, gate/up and down, and the lm_head: 7 x 32 + 1 = 225 calls
K6_VICUNA_SHAPES = (("wq/wk/wv/wo", 4096, 4096, 128),
                    ("gate/up", 4096, 11008, 64),
                    ("down", 11008, 4096, 32),
                    ("lm_head", 4096, 32000, 1))
# K6 against its plain version: max |err| over max |plain|. The kernel
# writes bf16 (one rounding, 2^-9 of the value) of f32 sums taken in
# another order than the plain version's.
K6_TOL = 1e-2


def _int4pack_mm(x, qw, zero=0.0):
    """torch's own int4 matmul on the same weights (groups of din / nb along
    din, (u - 8) * scale + zero, bf16 scales), timed as the library
    yardstick only: (callable, None) or (None, why not)."""
    import torch
    try:
        u = torch.cat([qw.q4 & 0xF, qw.q4 >> 4]).T.contiguous()  # [dout, din]
        packed = torch._convert_weight_to_int4pack(
            ((u[:, ::2] << 4) | u[:, 1::2]).contiguous(), 8)
        group = u.shape[1] // qw.scale.shape[0]
        sz = torch.stack([qw.scale, torch.full_like(qw.scale, zero)],
                         dim=-1).to(torch.bfloat16).contiguous()
        fn = lambda: torch._weight_int4pack_mm(x, packed, group, sz)  # noqa
        fn()
        return fn, None
    except Exception as e:                 # an older torch or another shape
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"


def check_int4_kernel(dev, shapes=K6_SHAPES, multi_b=("gate/up", "down"),
                      model="7B", check_build=True):
    """K6 against its plain version at the five 7B shapes at B = 1, gate/up
    and down also at B = 8 and 32 (down has nb = 148 scale blocks); device
    times by CUDA-graph replay rotating through enough weight copies to
    exceed the 50 MB L2 (a decode step finds each weight cold); the bound
    (bytes); torch's int4 matmul, a bf16 matmul of the dequantized weight
    and dequantize + matmul on the same inputs. Returns K6's row, summed
    over one decode token's calls (197). With `shapes` (the llava phase's
    K6_VICUNA_SHAPES) another `model`'s shapes, each first put to the gate
    JAX's kernel uses; `check_build` runs the build's ptxas check first."""
    import torch
    from flash_vstream_tpu_torch.kernels.int4_matmul import (
        int4_matmul_cuda, int4_matmul_reference)
    from flash_vstream_tpu_torch.weights.quantize import (
        QuantWeight4, dequantize_weight4, quantize_weight4)

    from flash_vstream_tpu_torch.kernels import _build
    from flash_vstream_tpu_torch.kernels.int4_matmul import _plan, _sms

    from flash_vstream_tpu_torch.kernels.int4_matmul import (
        int4_matmul_supported)
    if check_build:
        check_k6_build(_build.library_path())
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    per_token = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    worst = 0.0
    lib_missing = None
    for name, din, dout, calls in shapes:
        scale = 0.02 if name == "lm_head" else din ** -0.5   # the init's
        qw = quantize_weight4(torch.randn(din, dout, generator=g,
                                          device=dev) * scale)
        gate = int4_matmul_supported(1, din // 2, qw.scale.shape[0], dout)
        print(f"K6 gate {model} {name}: [{din}, {dout}] nb={qw.scale.shape[0]} at "
              f"B=1 {'passes' if gate else 'FAILS'}", flush=True)
        if not gate:
            raise AssertionError(f"K6 gate refuses {model} {name} [{din}, "
                                 f"{dout}]")
        nbytes = _nbytes(*qw)
        copies = [qw] + [QuantWeight4(qw.q4.clone(), qw.scale.clone())
                         for _ in range(min(63, -(-100_000_000 // nbytes)) - 1)]
        n = len(copies)
        for B in ((1, 8, 32) if name in multi_b else (1,)):
            x = torch.randn(B, din, generator=g, device=dev).to(torch.bfloat16)
            n0 = int4_matmul_cuda.launches
            got = int4_matmul_cuda(x, *qw)
            per_call = int4_matmul_cuda.launches - n0
            again = int4_matmul_cuda(x, *qw)
            want = int4_matmul_reference(x, *qw, torch.float32)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not torch.isfinite(got).all() or rel > K6_TOL:
                raise AssertionError(f"K6 {model} {name} B={B}: max err "
                                     f"{err} is {rel:.3e} of max |plain| > "
                                     f"{K6_TOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"K6 {model} {name} B={B}: two runs "
                                     f"differ")
            plan = _plan(B, din // 2, qw.scale.shape[0], dout,
                         _sms(dev.index))
            # the kernel's own launches per call (a second, the reduction
            # of the f32 partials, follows at B > 1 where split > 1)
            kernels_per_call = 1 + (B > 1 and plan.split > 1)
            if per_call != 1:
                raise AssertionError(f"K6 {model} {name} B={B}: {per_call} "
                                     f"counted launches per call")
            worst = max(worst, err)
            iters = max(20, 2 * n)
            ms = _ms(lambda i: int4_matmul_cuda(x, *copies[i % n]), iters)
            eager = _eager_ms(lambda i: int4_matmul_cuda(x, *copies[i % n]),
                              200)
            plain = _ms(lambda i: int4_matmul_reference(x, *copies[i % n]),
                        min(iters, 8))
            bound = _bound(2 * B * din * dout,
                           _nbytes(x, *qw) + B * dout * 2)
            lib, why = _int4pack_mm(x, qw)
            lib_ms = _ms(lambda i: lib(), 20) if lib else None
            lib_err = ((lib().float() - want).abs().max().item()
                       / want.abs().max().item()) if lib else None
            w16 = dequantize_weight4(qw, torch.bfloat16)
            bf16_ms = _ms(lambda i: torch.matmul(x, w16), 20)
            del w16
            deq_ms = _ms(lambda i: torch.matmul(
                x, dequantize_weight4(copies[i % n], torch.bfloat16)),
                min(iters, 8))
            print(f"K6 {model} {name}: x[{B}, {din}] @ int4[{din}, {dout}] nb="
                  f"{qw.scale.shape[0]} max_abs_err={err:.3e} "
                  f"({rel:.2e} of max, limit {K6_TOL:.0e}) kernel_ms="
                  f"{ms:.4f} eager_ms={eager:.4f} plain_ms={plain:.4f} "
                  f"bound_ms={bound[0]:.4f} "
                  f"({bound[1]}) int4pack_ms="
                  + (f"{lib_ms:.4f} (err {lib_err:.2e})" if lib
                     else f"none ({why})")
                  + f" bf16_matmul_ms={bf16_ms:.4f} dequant_matmul_ms="
                  f"{deq_ms:.4f} ({n} weight copies rotated); plan "
                  + (f"cluster={plan.split} warps={plan.warps} rows="
                     f"{plan.rows}" if B == 1 else
                     f"splits={plan.split} rows={plan.rows}")
                  + f", {kernels_per_call} kernel launch(es) per call, "
                  f"bit-identical run to run", flush=True)
            if B == 1:
                per_token["ms"] += calls * ms
                per_token["plain_ms"] += calls * plain
                per_token["bound_ms"] += calls * bound[0]
                if lib:
                    per_token["library_ms"] += calls * lib_ms
                else:
                    lib_missing = why
        del copies, qw
        torch.cuda.empty_cache()
    if lib_missing:
        per_token["library_ms"] = None
    n_calls = sum(c for *_, c in shapes)
    print(f"K6 per decode token ({n_calls} calls at B=1, {model}): "
          f"kernel_ms="
          f"{per_token['ms']:.4f} plain_ms={per_token['plain_ms']:.4f} "
          f"bound_ms={per_token['bound_ms']:.4f} (bytes) library_ms="
          + (f"{per_token['library_ms']:.4f}" if per_token["library_ms"]
             is not None else f"none ({lib_missing})"), flush=True)
    return {"int4_matmul": dict(
        max_abs_err=worst, bound_by="bytes",
        per=f"decode token: {n_calls} calls at B=1 over the "
            f"{len(shapes)} {model} shapes", **per_token)}


def _fold_instance(name):
    """(conversion, steps of loads in flight) of the B = 1 kernel template
    (csrc/int4_b1.cuh `int4_fold_kernel<Conv, kSteps>`) that a SASS or
    ptxas function name is an instance of, or None."""
    m = re.search(r"int4_fold_kernelI\w*?(Packed|PerElement|Unbiased|Floor"
                  r"|Ones)ELi(\d+)E", name)
    return (m.group(1), int(m.group(2))) if m else None


def _k6_instance(name):
    """K6's B = 1 kernel instance (the Packed conversion, one step of loads
    in flight) a SASS or ptxas function name matches, or None."""
    return ("int4_fold_kernel" if _fold_instance(name) == ("Packed", 1)
            else None)


def check_k6_build(lib_path):
    """K6's B = 1 kernel as built: ptxas registers and spills, and SASS
    counts of HMMA, PRMT, LOP3, I2F and 128-bit global loads. It fails
    without HMMA (the products on the tensor cores), with any I2F (a nibble
    converted on the FP32 pipe) or with a spill."""
    regs = _ptxas_counts(lib_path.with_suffix(".log"), _k6_instance)
    sass = _sass_counts(lib_path, _k6_instance, full=True)
    if "int4_fold_kernel" not in regs:
        raise AssertionError("K6 ptxas: no int4_fold_kernel in the build log")
    r, st, ld = regs["int4_fold_kernel"]
    line = (f"K6 ptxas int4_fold_kernel (B=1): registers={r} spill stores="
            f"{st} B spill loads={ld} B")
    if isinstance(sass, str):
        print(line + f"; SASS {sass}", flush=True)
    else:
        c = sass.get("int4_fold_kernel", {})
        pick = lambda f: sum(v for k, v in c.items() if f(k))  # noqa: E731
        n = {"HMMA": pick(lambda k: k.startswith("HMMA")),
             "PRMT": pick(lambda k: k.startswith("PRMT")),
             "LOP3": pick(lambda k: k.startswith("LOP3")),
             "I2F": pick(lambda k: k.startswith("I2F")),
             "LDG.128": pick(lambda k: k.startswith("LDG")
                             and ".128" in k)}
        print(line + "; SASS " + " ".join(f"{k}={v}" for k, v in n.items())
              + f" of {sum(c.values())} instructions", flush=True)
        if not n["HMMA"] or n["I2F"]:
            raise AssertionError(f"K6 SASS: HMMA {n['HMMA']}, I2F {n['I2F']}")
    if st or ld:
        raise AssertionError("K6 ptxas: int4_fold_kernel spills")


def _int4_route(mode):
    """How the decoder computes an int4 matvec that passes the K6 gate, for
    the checks: "kernel" (as served: K6 on the card), "dequant" (dequantize
    + matmul, the JAX package's path for other shapes), "plain" (K6's plain
    version, on any device) or "fault" (the plain version with the high
    half's scale blocks off by one: block nb/2 + i/bs + 1, the last kept).
    A context manager that swaps `dense` in the decoder's modules; the
    other routes launch no K6."""
    import contextlib
    import math as _math
    import torch
    from flash_vstream_tpu_torch.kernels.int4_matmul import (
        int4_matmul_reference, int4_matmul_supported)
    from flash_vstream_tpu_torch.models import layers, llm
    from flash_vstream_tpu_torch.weights.quantize import dequantize_weight4
    served = layers.dense

    def dense(x, w, b=None):
        if not hasattr(w, "q4"):
            return served(x, w, b)
        rows = _math.prod(x.shape[:-1])
        if mode == "dequant" or not (w.q4.dim() == 2 and int4_matmul_supported(
                rows, w.q4.shape[0], w.scale.shape[0], w.q4.shape[1])):
            out = torch.matmul(x, dequantize_weight4(w, x.dtype))
        else:
            scale = w.scale
            if mode == "fault":
                nbh = scale.shape[0] // 2
                scale = torch.cat([scale[:nbh], scale[nbh + 1:], scale[-1:]])
            out = int4_matmul_reference(x.reshape(rows, x.shape[-1]), w.q4,
                                        scale, x.dtype)
            out = out.reshape(*x.shape[:-1], w.q4.shape[-1])
        return out if b is None else out + b.to(out.dtype)

    @contextlib.contextmanager
    def route():
        if mode != "kernel":
            layers.dense = llm.dense = dense
        try:
            yield
        finally:
            layers.dense = llm.dense = served
    return route()


# The int4 references hold each logit vector's max |error| over its max
# |logit|, card K6 against the dequantize path. bf16 sets the floor: on the
# CPU, the kernel's arithmetic (its plain version) against the dequantize
# path reads up to 2.6e-2 on the small model over a prefill and 8
# teacher-forced steps, while the high half's scale blocks off by one reads
# 1.0e-1 to 1.6e-1 on those steps (tests/test_torch_int4_matmul.py reads
# both).
INT4_REF_LIMIT = 6e-2


def int4_reference_case():
    """The small model's decoder (hidden 256, intermediate 512, vocab 512,
    two layers, head_dim 128, GQA 2/1) with bf16 weights quantized by
    `quantize_params4`: every projection and the lm_head pass the K6 gate
    (nb 2 or 4, dout a multiple of 128). A 200-token prompt of embedded
    random ids and 8 teacher-forced tokens."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.models.llm import init_llm_params
    from flash_vstream_tpu_torch.weights.quantize import quantize_params4
    cfg = _small_cfg().llm
    params = init_llm_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                             dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    S = 200
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)))
    return dict(cfg=cfg, qparams=quantize_params4(params),
                embeds=params["embed"][ids],
                positions=torch.arange(S)[None].expand(3, 1, S).contiguous(),
                tokens=[int(t) for t in rng.integers(0, cfg.vocab_size, 8)])


def int4_logits(generator, embeds, positions, tokens, segment_ids=None,
                last_idx=None, decode_start=None):
    """f32 logits [1 + len(tokens), V] on the CPU: the prefill's, then one
    per teacher-forced decode step."""
    import torch
    S = embeds.shape[1]
    cache = generator.new_cache(1, generator._active_len(S, len(tokens)))
    out = [generator.prefill(embeds, positions, cache, segment_ids, last_idx)]
    start = S if decode_start is None else int(decode_start)
    for i, t in enumerate(tokens):
        tok = torch.tensor([t], device=embeds.device)
        out.append(generator.step(tok, start + i, cache))
    return torch.cat(out).float().cpu()


def logit_errors(got, want):
    """Per row (logit vector): max |got - want| over max |want|."""
    return ((got - want).abs().amax(1)
            / want.abs().amax(1).clamp_min(1e-30)).tolist()


def int4_reference_logits(case, device, mode="kernel"):
    from flash_vstream_tpu_torch.models.llm import Qwen2Decoder
    from flash_vstream_tpu_torch.runtime.generation import Generator
    model = Qwen2Decoder(case["cfg"], case["qparams"]).to(device)
    with _int4_route(mode):
        return int4_logits(Generator(model, max_len=256),
                           case["embeds"].to(device),
                           case["positions"].to(device), case["tokens"])


def check_int4_reference(dev):
    """The small int4 decoder on the card (K6 in every projection and the
    lm_head at decode) against the same int4 weights on the CPU (the
    dequantize path): a prefill's logits and 8 teacher-forced decode steps,
    each within INT4_REF_LIMIT of its max |logit|; K6 launched 15 times per
    step (7 projections x 2 layers + lm_head) and once for the prefill's
    last row."""
    import torch
    from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_cuda
    case = int4_reference_case()
    n0 = int4_matmul_cuda.launches
    card = int4_reference_logits(case, dev)
    launched = int4_matmul_cuda.launches - n0
    cpu = int4_reference_logits(case, torch.device("cpu"), "dequant")
    errs = logit_errors(card, cpu)
    print(f"int4_reference: small int4 decoder, card (K6, {launched} "
          f"launches) vs CPU dequantize path, err/max per logit vector: "
          f"prefill {errs[0]:.3e}, decode max {max(errs[1:]):.3e} (limit "
          f"{INT4_REF_LIMIT:.0e}; steps " + " ".join(f"{e:.2e}" for e in errs)
          + ")", flush=True)
    want = 15 * len(case["tokens"]) + 1
    if launched != want:
        raise AssertionError(f"int4_reference: K6 launched {launched} times, "
                             f"not {want}")
    if not torch.isfinite(card).all() or max(errs) > INT4_REF_LIMIT:
        raise AssertionError("int4_reference: the card's logits are off")


def check_backward_kernels(dev):
    """K3, K4 and K5 against their plain versions: the training shape (q
    [1, 28, 4096, 128], k/v [1, 4, 4096, 128], causal, the prompt's segment
    row with a -1 run inside and a -1 tail), a ragged GQA case at head_dim
    80, one with a fully masked row and the tile cases (`TILE_CASES`); then
    times at the training shape. Bounds: out by `check_fwd` (2e-2 abs,
    ROW_TOL of each row's max), out and lse equal bit for bit at every rows
    per block; lse 1e-3 abs where finite and -inf exactly where the plain
    version has it; dq/dk/dv 2e-2 x max |plain| over the whole tensor and,
    row by row, 2e-2 x the row's max |plain| (bf16 outputs of f32 sums in
    another order); masked rows exactly 0; dq, delta, dk and dv equal bit
    for bit run to run and at every rows per block (`check_bwd_bits`).
    K4/K5's ptxas and SASS counts come first (`check_bwd_build`)."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa

    check_bwd_build()
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    S = 4096
    train_seg = fa.segment_ids([(3000, 3100, -1), (3900, S, -1)], 1, S, dev)
    rag_q = fa.segment_ids([(300, 333, -1)], 2, 333, dev)
    rag_k = fa.segment_ids([(290, 301, -1)], 2, 301, dev)
    mq = fa.segment_ids([(17, 18, 5)], 1, 100, dev)  # row 17: an id no key has
    mk = fa.segment_ids([], 1, 100, dev)
    cases = {
        "train": ((randn(1, 28, S, 128), randn(1, 4, S, 128),
                   randn(1, 4, S, 128)),
                  dict(causal=True, q_segment_ids=train_seg,
                       kv_segment_ids=train_seg)),
        "ragged_gqa_d80": ((randn(2, 6, 333, 80), randn(2, 2, 301, 80),
                            randn(2, 2, 301, 80)),
                           dict(q_segment_ids=rag_q, kv_segment_ids=rag_k)),
        "masked_row_d64": ((randn(1, 4, 100, 64), randn(1, 1, 100, 64),
                            randn(1, 1, 100, 64)),
                           dict(q_segment_ids=mq, kv_segment_ids=mk)),
    }
    cases.update({name: tile_case(dev, g, name) for name in fa.TILE_CASES})
    errs = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    for name, ((q, k, v), kw) in cases.items():
        do = randn(*q.shape)
        out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, out, do, lse, delta,
                                                 **kw)
        p_out, p_lse = fa.flash_attention_fwd_lse_reference(q, k, v, **kw)
        # K4/K5's plain version on K4/K5's own inputs (K3's out and lse):
        # delta = rowsum(do * out) cancels against dp where attention is
        # peaked, so one bf16 ulp of out apart would show as row noise
        p_dq, p_dk, p_dv = fa.flash_attention_bwd_reference(
            q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        for x in (out, lse[torch.isfinite(p_lse)], dq, dk, dv):
            if not torch.isfinite(x).all():
                raise AssertionError(f"backward {name}: non-finite values")
        fin = torch.isfinite(p_lse)
        if not torch.equal(torch.isfinite(lse), fin) or not bool(
                (lse[~fin] == float("-inf")).all()):
            raise AssertionError(f"K3 {name}: lse is not -inf exactly where "
                                 f"the plain version has -inf")
        e_out, r_out = check_fwd(f"K3 {name}", out, p_out, q, k, kw)
        check_fwd_bits(f"K3 {name}", (q, k, v), kw, out, lse)
        check_bwd_bits(name, (q, k, v, out, do, lse), kw, (dq, delta, dk, dv))
        e_lse = (lse[fin] - p_lse[fin]).abs().max().item()
        q_rows, k_rows = _grad_rows(q, k, kw)
        grads = (("dq", dq, p_dq, q_rows), ("dk", dk, p_dk, k_rows),
                 ("dv", dv, p_dv, k_rows))
        rel = {n: ((a.float() - b.float()).abs().max()
                   / b.float().abs().max().clamp_min(1e-30)).item()
               for n, a, b, _ in grads}
        row = {n: _row_err(a, b, r) for n, a, b, r in grads}
        if (e_out > 2e-2 or e_lse > 1e-3 or max(rel.values()) > 2e-2
                or max(row.values()) > 2e-2):
            raise AssertionError(
                f"backward {name}: out {e_out:.3e} lse {e_lse:.3e} grads/max "
                + " ".join(f"{n}={rel[n]:.3e}" for n in rel) + " by row "
                + " ".join(f"{n}={row[n]:.3e}" for n in row))
        # rows no key reaches, and keys no query reaches, are exactly 0
        dead_q = ~fin                                           # [B, Hq, Sq]
        seen_k = (fa._visible(q, k, kw.get("causal", False),
                              kw["q_segment_ids"], kw["kv_segment_ids"])
                  .any(dim=3)[:, 0, 0])                         # [B, Skv]
        if dead_q.any() and (out[dead_q].abs().max() != 0
                             or dq[dead_q].abs().max() != 0):
            raise AssertionError(f"backward {name}: a masked query row is "
                                 f"not exactly 0")
        unseen = ~seen_k
        if unseen.any() and (dk.transpose(1, 2)[unseen].abs().max() != 0
                             or dv.transpose(1, 2)[unseen].abs().max() != 0):
            raise AssertionError(f"backward {name}: dk/dv of a key no query "
                                 f"sees is not exactly 0")
        errs["K3"] = max(errs["K3"], e_out)
        errs["K4"] = max(errs["K4"], (dq.float() - p_dq.float()).abs().max()
                         .item())
        errs["K5"] = max(errs["K5"], max(
            (dk.float() - p_dk.float()).abs().max().item(),
            (dv.float() - p_dv.float()).abs().max().item()))
        print(f"backward {name}: q{tuple(q.shape)} k{tuple(k.shape)} "
              f"{'causal ' if kw.get('causal') else ''}max_abs_err out="
              f"{e_out:.3e} (by row {r_out:.3e}, equal bit for bit at every "
              f"rows per block) lse={e_lse:.3e} dq/max={rel['dq']:.3e} "
              f"dk/max={rel['dk']:.3e} dv/max={rel['dv']:.3e} by row: "
              f"dq={row['dq']:.3e} dk={row['dk']:.3e} dv={row['dv']:.3e} "
              f"({int(q_rows.sum())} dq rows, {int(k_rows.sum())} dk/dv rows); "
              f"{int(dead_q.sum())} masked query rows, "
              f"{int(unseen.sum())} unseen keys exactly 0; dq/dk/dv equal bit "
              f"for bit run to run and at every rows per block; plan rows "
              f"K4 {_bwd_plan('dq', q, k).rows_per_block} "
              f"K5 {_bwd_plan('dkv', q, k).rows_per_block}", flush=True)
        del p_out, p_lse, p_dq, p_dk, p_dv

    # times at the training shape
    (q, k, v), kw = cases["train"]
    do = randn(*q.shape)
    out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    D = q.shape[-1]
    pairs = _visible_pairs(q, k, True, train_seg, train_seg)
    seg_b = 2 * _nbytes(train_seg)
    res = {}
    ms = _ms(lambda i: fa.flash_attention_fwd_lse_cuda(q, k, v, **kw), 10)
    k3_rows = _fwd_ms_by_rows((q, k, v), kw, 10, lse.clone())
    plain = _ms(lambda i: fa.flash_attention_fwd_lse_reference(q, k, v, **kw),
                2)
    lib = _ms(lambda i: _sdpa(q, k, v, True), 10)
    res["flash_attention_fwd_lse"] = (ms, plain, lib, _bound(
        pairs * 4 * D, _nbytes(q, k, v, out, lse) + seg_b))
    plain_bwd = _ms(lambda i: fa.flash_attention_bwd_reference(
        q, k, v, out, do, lse, **kw), 1)
    lib_bwd = _sdpa_bwd_ms(q, k, v, do)
    ms, by_rows = _bwd_ms((q, k, v, out, do, lse, delta), kw)
    res["flash_attention_bwd_dq"] = (ms[0], plain_bwd, lib_bwd, _bound(
        pairs * 6 * D, _nbytes(q, k, v, out, do, lse, dq, delta) + seg_b))
    res["flash_attention_bwd_dkv"] = (ms[1], plain_bwd, lib_bwd, _bound(
        pairs * 8 * D, _nbytes(q, k, v, do, lse, delta, k, v) + seg_b))
    out_rows = {}
    for (name, (ms, plain, lib, (bound, by))), kid in zip(
            res.items(), ("K3", "K4", "K5")):
        print(f"{kid} {name}: q{tuple(q.shape)} k{tuple(k.shape)} causal "
              f"segments kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={bound:.4f} ({by}) library_ms={lib:.4f} "
              f"({'SDPA forward' if kid == 'K3' else 'SDPA backward, dq+dk+dv'}"
              f", causal only)"
              + ("; " + k3_rows if kid == "K3" else
                 " plain = the one plain backward; " + by_rows[kid]),
              flush=True)
        out_rows[name] = dict(max_abs_err=errs[kid], ms=ms, plain_ms=plain,
                              bound_ms=bound, bound_by=by, library_ms=lib)
    return out_rows


def _bwd_plan(kernel, q, k):
    """The plan K4 ("dq") or K5 ("dkv") launches with for q and k."""
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    B, Hq, Sq, D = q.shape
    return fa._bwd_launch_plan(kernel, B, Hq, k.shape[1], Sq, k.shape[2], D)


def _sdpa_bwd_ms(q, k, v, do):
    """The library backward: SDPA's gradient for q, k, v (one call computes
    all three; GQA, causal, no segment mask), timed with events around
    autograd over a kept graph."""
    import torch
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    lo = _sdpa(ql, kl, vl, True)
    for _ in range(2):
        torch.autograd.grad(lo, (ql, kl, vl), do, retain_graph=True)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(5):
        torch.autograd.grad(lo, (ql, kl, vl), do, retain_graph=True)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 5


def _bwd_ms(args, kw, iters=10):
    """K4's and K5's ms at the plan's rows per block, and each timed at
    every rows per block the C entries take ({"K4": str, "K5": str}): what
    the plan's choice is measured against."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    q, k, v, out, do, lse, delta = args
    causal = kw.get("causal", False)
    seg = (kw.get("q_segment_ids"), kw.get("kv_segment_ids"))
    ms = (_ms(lambda i: fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse,
                                                       **kw), iters),
          _ms(lambda i: fa.flash_attention_bwd_dkv_cuda(
              q, k, v, out, do, lse, delta, **kw), iters))
    by_rows = {}
    for kid, kernel in (("K4", "dq"), ("K5", "dkv")):
        outs = ((torch.empty_like(q), torch.empty_like(lse), None, None)
                if kernel == "dq" else
                (None, delta, torch.empty_like(k), torch.empty_like(v)))
        times = [_ms(lambda i: fa._launch_bwd(
            kernel, q, k, v, out, do, lse, outs[1], outs[0], outs[2],
            outs[3], causal, *seg, None, rows_per_block=rows), iters)
            for rows in fa.BWD_ROWS_PER_BLOCK]
        by_rows[kid] = (f"plan rows {_bwd_plan(kernel, q, k).rows_per_block},"
                        " ms by rows per block " + " ".join(
                            f"{r}={t:.4f}" for r, t in
                            zip(fa.BWD_ROWS_PER_BLOCK, times)))
    return ms, by_rows


def check_function(dev):
    """FlashAttentionFunction (K3 forward, K4 + K5 backward) against
    autograd of the plain attention on the same bf16 inputs, at a mid shape
    (B 1, Hq 4, Hkv 2, S 1000, D 128, causal, a -1 tail): grads within
    2e-2 x max |plain grad| and, head by head, HEAD_L2_LIMIT in relative L2
    norm. Not row by row: the Function takes delta from its bf16 output and
    autograd does not, and where attention is peaked delta cancels against
    dp, so a few small rows differ by their own size in both plain
    formulations."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    q, k, v = (torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((1, 4, 1000, 128), (1, 2, 1000, 128),
                         (1, 2, 1000, 128)))
    seg = torch.zeros(1, 1000, dtype=torch.int32, device=dev)
    seg[:, 950:] = -1
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    grads = []
    n3 = fa.flash_attention_fwd_lse_cuda.launches
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*xs, **kw)
        grads.append(torch.autograd.grad(out, xs, do))
    if fa.flash_attention_fwd_lse_cuda.launches != n3 + 1:
        raise AssertionError("function: flash_attention with grad did not "
                             "launch K3")
    rel = [((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()
           for a, b in zip(*grads)]
    head = [head_l2_err(a, b) for a, b in zip(*grads)]
    if (max(rel) > 2e-2 or max(head) > HEAD_L2_LIMIT
            or not all(torch.isfinite(x).all() for x in grads[0])):
        raise AssertionError(f"function: grads/max {rel} (limit 2e-2), rel "
                             f"L2 per head {head} (limit {HEAD_L2_LIMIT})")
    print(f"function: FlashAttentionFunction vs autograd of the plain "
          f"attention, q(1, 4, 1000, 128) GQA 4/2 causal: dq/dk/dv err/max "
          f"{rel[0]:.3e} {rel[1]:.3e} {rel[2]:.3e}, rel L2 per head (max) "
          f"{head[0]:.3e} {head[1]:.3e} {head[2]:.3e}", flush=True)


def _frames(rng, n, hw):
    import numpy as np
    return list(rng.integers(0, 256, size=(n, *hw, 3), dtype=np.uint8))


def _qwen_config():
    """VStreamQwenConfig() with its decoder cut to QWEN_LAYERS layers."""
    import dataclasses
    from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
    cfg = VStreamQwenConfig()
    return cfg.replace(llm=dataclasses.replace(cfg.llm,
                                               num_layers=QWEN_LAYERS))


def _qwen_cut(params):
    """The slice's weights with the decoder's first QWEN_LAYERS layers
    (views)."""
    from flash_vstream_tpu_torch.models.layers import layer_slice
    return dict(params, llm=dict(params["llm"], layers=layer_slice(
        params["llm"]["layers"], slice(0, QWEN_LAYERS))))


def _small_cfg():
    """The 7B config cut to two layers of each tower, narrow, keeping the
    head dims (ViT 80, decoder 128), M-RoPE and GQA; Flash memory of 4 CSM
    clusters and 2 DAM frames."""
    import dataclasses
    from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
    full = VStreamQwenConfig()
    return full.replace(
        vit=dataclasses.replace(full.vit, hidden_size=160,
                                intermediate_size=320, num_layers=2,
                                num_heads=2, merger_out_dim=256),
        llm=dataclasses.replace(full.llm, vocab_size=512, hidden_size=256,
                                intermediate_size=512, num_layers=2,
                                num_heads=2, num_kv_heads=1),
        flash_memory=dataclasses.replace(full.flash_memory,
                                         temporal_length=8, spatial_length=4))


def check_reference(dev):
    """A small model (ViT head_dim 80, LLM head_dim 128, two layers each)
    streamed on the card (kernels) and on the CPU (plain versions) from the
    same bf16 weights and frames: positions must match and features agree to
    bf16 rounding; the answer's prefill logits must agree."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.models.vstream_qwen import (
        VStreamQwen, init_qwen_params)
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession

    cfg = _small_cfg()
    params = init_qwen_params(cfg, torch.Generator().manual_seed(SEED),
                              "cpu", dtype=torch.bfloat16)
    sessions = []
    for d in (dev, torch.device("cpu")):
        model = VStreamQwen(cfg, params).to(d)
        sessions.append(QwenStreamSession(
            model, make_byte_qwen_tokenizer(), frame_hw=(112, 112),
            clip_size=2, bank_size=16, max_len=1024))
    rng = np.random.default_rng(SEED)
    scenes = rng.integers(0, 256, size=(3, 112, 112, 3))
    t_dam = cfg.flash_memory.dam_grid_len
    worst, ties = 0.0, 0
    for i in range(7):
        frames = [np.clip(scenes[(i // 2) % 3]
                          + rng.integers(-64, 65, scenes[0].shape), 0, 255)
                  .astype(np.uint8) for _ in range(2)]
        for s in sessions:
            s.ingest_frames(frames)
        (gp, gt, gx, gtx), (cp, ct, cx, ctx) = (
            [x.cpu().float() for x in s._published[0]] for s in sessions)
        if not torch.equal(gt, ct):
            raise AssertionError(f"reference: ingest {i} CSM positions "
                                 f"differ: {gt.tolist()} / {ct.tolist()}")
        worst = max(worst, (gtx - ctx).abs().max().item())
        for j in range(t_dam):
            if gp[j] == cp[j]:
                worst = max(worst, (gx[j] - cx[j]).abs().max().item())
            elif _dam_tie(sessions[1].state, t_dam, j, int(gp[j]), int(cp[j])):
                ties += 1
            else:
                raise AssertionError(f"reference: ingest {i} DAM slot {j}: "
                                     f"card frame {int(gp[j])}, CPU frame "
                                     f"{int(cp[j])}, not a tie")
    if worst > 5e-2:
        raise AssertionError(f"reference: snapshot features differ by {worst}")
    # prefill logits of the two models from the card's snapshot
    snap, n = sessions[0]._published
    logits = []
    for s, sn in ((sessions[0], snap), (sessions[1], [x.cpu() for x in snap])):
        h = s._prompt_host(QUESTIONS[0], n)
        embeds, pos, _, seg = s._prompt_inputs(sn, h)
        cache = s.generator.new_cache(1, s.generator._active_len(h["S"], 8))
        logits.append(s.generator.prefill(embeds, pos, cache, seg,
                                          h["last_real"]).cpu())
    lerr = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    if not torch.isfinite(logits[0]).all() or lerr > 5e-2 * scale:
        raise AssertionError(f"reference: prefill logits differ by {lerr} "
                             f"(max |logit| {scale})")
    print(f"reference: 7 ingests + prefill, card vs CPU plain: CSM positions "
          f"equal, DAM positions equal but {ties} exact k-means ties, max "
          f"feature diff {worst:.3e}, max logit diff {lerr:.3e} of max "
          f"|logit| {scale:.3e}", flush=True)


def _dam_tie(state, t_dam, j, p_card, p_cpu):
    """Whether DAM slot j's query cluster (from the CPU state) is as near to
    frame p_card as to p_cpu, up to bf16 rounding: a two-frame cluster of
    equal weights has its centroid midway, and rounding picks the side."""
    import torch
    from flash_vstream_tpu_torch.ops.retrieval import topk_by_weight
    w = torch.where(state.tem_valid, state.tem_weights, float("-inf"))
    q = state.tem_x[topk_by_weight(w, t_dam)[j]].float().flatten()

    def dist(p):
        slot = int((state.bank_pos == p).nonzero()[0, 0])
        return ((state.bank_small[slot].float().flatten() - q) ** 2).sum().item()

    return dist(p_card) <= dist(p_cpu) * 1.01 + 1e-6


def run_slice(dev):
    """The full-width Qwen2-VL-7B streaming session through its public
    entry points, with the kernels' launch counts per phase."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.models.vstream_qwen import (
        VStreamQwen, VStreamQwenConfig, init_qwen_params)
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession

    cfg = VStreamQwenConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_qwen_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                              device=dev, dtype=torch.bfloat16)
    model = VStreamQwen(cfg, params)
    tok = make_byte_qwen_tokenizer()
    sess = QwenStreamSession(model, tok, frame_hw=(224, 224), clip_size=8,
                             bank_size=1024, max_len=4096)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: Qwen2-VL-7B full width, random bf16 weights "
          f"({n_params / 1e9:.3f} B params), init {time.perf_counter() - t0:.3f} s",
          flush=True)

    rng = np.random.default_rng(SEED)
    flash_attention_cuda.launches = 0
    gather_rows_cuda.launches = 0
    sess.ingest_frames(_frames(rng, 8, (224, 224)))           # warm-up clip
    sess.block_until_ingested()
    times = []
    for _ in range(N_CLIPS):
        frames = _frames(rng, 8, (224, 224))
        t0 = time.perf_counter()
        sess.ingest_frames(frames)
        sess.block_until_ingested()
        times.append((time.perf_counter() - t0) * 1e3)
    k1_ingest, k2_ingest = flash_attention_cuda.launches, gather_rows_cuda.launches

    snap, n = sess._published
    spa_pos, tem_pos, spa_x, tem_x = snap
    fm = cfg.flash_memory
    h = sess._prompt_host(QUESTIONS[0], n)
    n_csm = int(sess.state.tem_valid.sum())
    ok = (n == 4 * (N_CLIPS + 1) and n_csm == fm.csm_grid_len
          and tuple(spa_x.shape) == (fm.dam_grid_len, 256, 1280)
          and tuple(tem_x.shape) == (fm.csm_grid_len, 64, 1280)
          and bool((spa_pos >= 0).all()) and h["n_vis"] == 2880
          and bool(torch.isfinite(spa_x).all() and torch.isfinite(tem_x).all()))
    print(f"ingest: {N_CLIPS} clips x 8 frames (224x224) after 1 warm-up: "
          f"ms/clip mean={np.mean(times):.2f} best={min(times):.2f} "
          f"median={np.median(times):.2f}; frame pairs={n} CSM={n_csm}/"
          f"{fm.csm_grid_len} DAM={spa_x.shape[0]}/{fm.dam_grid_len} "
          f"visual tokens/answer={h['n_vis']}", flush=True)
    if not ok:
        raise AssertionError("ingest: memory not saturated as expected")

    flash_attention_cuda.launches = 0
    gather_rows_cuda.launches = 0
    gen = GenerationConfig(max_new_tokens=32, eos_token_ids=(tok.eos_token_id,))
    for q in QUESTIONS:
        t0 = time.perf_counter()
        text = sess.answer(q, gen)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        ntok = int(sess.metrics.get("answer_tokens").val)
        print(f"answer: S={sess._prompt_host(q, n)['S']} tokens={ntok} "
              f"seconds={dt:.3f} text={text[:40]!r}", flush=True)
    k1_answer, k2_answer = flash_attention_cuda.launches, gather_rows_cuda.launches
    print(f"launches: K1 ingest={k1_ingest} answer={k1_answer}; "
          f"K2 ingest={k2_ingest} answer={k2_answer}", flush=True)
    if not (k1_ingest > 0 and k1_answer > 0 and k2_ingest > 0):
        raise AssertionError("a kernel of the main path was never launched")

    embeds, pos, _, seg = sess._prompt_inputs(snap, h)
    cache = sess.generator.new_cache(1, sess.generator._active_len(h["S"], 32))
    logits = sess.generator.prefill(embeds, pos, cache, seg, h["last_real"])
    if logits.shape != (1, cfg.llm.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite")
    print(f"prefill logits: shape {tuple(logits.shape)} finite, "
          f"max |logit| {logits.abs().max().item():.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    return k1_ingest + k1_answer, k2_ingest + k2_answer, params


DIS_CLIPS = 16          # clips of 8 frames: 64 frame pairs, the 60 CSM
#                         slots saturate
# ids a question: a prefill and 11 decode steps (the script's time limit;
# `_teacher_forced` times the steps before its last 8)
DIS_TOKENS = 12
DIS_TP = (2, 4)         # the decoder's shards, all on the one card


def run_disaggregated(dev, smi, params, work, profile=False):
    """Serving across devices (ROADMAP A16's serving half) at full width
    on one card: the slice's Qwen2-VL-7B weights (all 28 layers), a
    one-device session and a disaggregated one
    (`make_serve_placement(1, 2, [card] * 3)`: ingest, two decode
    shards). The placed session ingests DIS_CLIPS clips (its
    snapshots bit-equal to the one-device session's) and answers two
    questions and one `answer_stream`: the path's K1/K2 launches. Then the
    checks: its ids against the one-device ids by the near-tie rule
    (`_batched_rule`: teacher-forced logits within OFFLINE_LOGIT_TOL of max
    |logit|, the shards' bf16 partial sums of wo and down rounding in
    another order than one matmul; a parting only at a near tie); the
    decoder at tp 1, 2 and
    4 (prefill ms, decode ms/token, and with `profile` the device's busy
    ms a token, a torch.profiler session each, about 30 s apiece: the
    sharded code's cost on one card, not multi-card speed), tp 4's ids by
    the same rule and a planted fault (one shard's partial left out of the
    all-reduce) refused; an answer on a thread while two more clips
    ingest equal to the same snapshot's answer; save / reset / load
    keeping the placement. Returns the path's (K1, K2) launches."""
    import threading
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.models.vstream_qwen import (
        VStreamQwen, VStreamQwenConfig)
    from flash_vstream_tpu_torch.parallel import inference
    from flash_vstream_tpu_torch.parallel.serve import make_serve_placement
    from flash_vstream_tpu_torch.parallel.sharding import create_mesh
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.generation import (
        GenerationConfig, Generator)
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession

    t_phase = time.perf_counter()
    cfg = VStreamQwenConfig()
    model = VStreamQwen(cfg, params)
    tok = make_byte_qwen_tokenizer()
    kw = dict(frame_hw=(224, 224), clip_size=8, bank_size=1024, max_len=4096)
    rng = np.random.default_rng(SEED + 1)
    clips = [_frames(rng, 8, (224, 224)) for _ in range(DIS_CLIPS + 2)]
    gen = GenerationConfig(max_new_tokens=DIS_TOKENS)   # no EOS: whole rows

    ref = QwenStreamSession(model, tok, **kw)
    want = []
    for c in clips[:DIS_CLIPS]:
        ref.ingest_frames(c)
        want.append(ref._published[0])
    t0 = time.perf_counter()
    pl = make_serve_placement(n_ingest=1, n_decode=2, devices=[dev] * 3)
    dis = QwenStreamSession(model, tok, placement=pl, **kw)
    torch.cuda.synchronize(dev)
    place_s = time.perf_counter() - t0

    # the path: ingest, two answers and a stream, their ids recorded
    ids = []
    generate, generate_stream = (dis.generator.generate,
                                 dis.generator.generate_stream)

    def recorded(*a, **k):
        out = generate(*a, **k)
        ids.append(list(out))
        return out

    def recorded_stream(*a, **k):
        out = []
        for t in generate_stream(*a, **k):
            out.append(t)
            yield t
        ids.append(out)
    dis.generator.generate = recorded
    dis.generator.generate_stream = recorded_stream
    flash_attention_cuda.launches = gather_rows_cuda.launches = 0
    ms = []
    for i, c in enumerate(clips[:DIS_CLIPS]):
        t0 = time.perf_counter()
        dis.ingest_frames(c)
        dis.block_until_ingested()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.equal(a, b) for a, b in zip(dis._published[0],
                                                      want[i])):
            raise AssertionError(f"disaggregated: ingest {i}'s snapshot is "
                                 f"not the one-device session's")
    t0 = time.perf_counter()
    texts = [dis.answer(q, gen) for q in QUESTIONS[:2]]
    texts.append("".join(dis.answer_stream(QUESTIONS[2], gen)))
    torch.cuda.synchronize(dev)
    answer_s = (time.perf_counter() - t0) / 3
    k1, k2 = flash_attention_cuda.launches, gather_rows_cuda.launches
    del dis.generator.generate, dis.generator.generate_stream
    n = dis.n_frames
    n_csm = int(dis.state.tem_valid.sum())
    if (n_csm != cfg.flash_memory.csm_grid_len or len(ids) != 3
            or dis.state.tem_x.device != pl.ingest_device
            or min(k1, k2) == 0):
        raise AssertionError(f"disaggregated: CSM {n_csm}, {len(ids)} "
                             f"answers, state on {dis.state.tem_x.device}, "
                             f"K1 {k1} K2 {k2}")
    print(f"disaggregated: placement ingest {pl.ingest_device}, decode tp "
          f"{pl.decode_mesh.shape['tp']} on "
          f"{[str(d) for d in pl.decode_mesh.devices[0]]} "
          f"(shards placed in {place_s:.3f} s); {DIS_CLIPS} clips ms/clip "
          f"mean={np.mean(ms):.2f} median={np.median(ms):.2f}, snapshots "
          f"bit-equal to the one-device session's at every ingest; frame "
          f"pairs {n} CSM {n_csm}; 3 answers of {DIS_TOKENS} ids "
          f"{answer_s:.3f} s each; texts {[t[:16] for t in texts]!r}; at "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # the one-device ids; the decoder at tp 1, 2 and 4 teacher-forced on
    # the first question's, timed; a later question's logits only where
    # its ids part
    prompts, single = [], []
    for q in QUESTIONS:
        h = ref._prompt_host(q, n)
        e, pos, start, seg = ref._prompt_inputs(ref._published[0], h)
        de, dpos, _, _ = dis._prompt_inputs(dis._published[0], h)
        if not (torch.equal(e, de) and torch.equal(pos, dpos)):
            raise AssertionError("disaggregated: the placed session's "
                                 "prompt embeddings are not the one-device "
                                 "session's")
        prompts.append((e, pos, seg, h["last_real"], [int(start)]))
        single.append(ref.generator.generate(
            e, pos, gen, decode_pos_start=start, segment_ids=seg,
            last_real_idx=h["last_real"]))
    print(f"disaggregated: one-device answers at "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    args = prompts[0]
    S = args[0].shape[1]
    gens = {1: ref.generator, 2: dis.generator}
    timing, logits = {}, {}
    for tp in (1,) + DIS_TP:
        if tp not in gens:
            tpd, _ = inference.shard_params_for_inference(
                model.llm, mesh=create_mesh(dp=1, tp=tp, devices=[dev] * tp))
            gens[tp] = Generator(tpd, max_len=4096)
        g = gens[tp]
        lg, host_ms, busy = _teacher_forced(g, *args, [single[0]],
                                            profile=profile)
        logits[tp] = lg[0]
        pre = []
        for _ in range(2):
            cache = g.new_cache(1, g._active_len(S, DIS_TOKENS))
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            g.prefill(args[0], args[1], cache, args[2], args[3])
            torch.cuda.synchronize(dev)
            pre.append((time.perf_counter() - t0) * 1e3)
        timing[tp] = (min(pre), host_ms, busy)
    print(f"disaggregated [{smi}]: decoder over [card] * tp at S={S}, "
          + "; ".join(f"tp {tp} prefill {p:.2f} ms, decode {h:.2f} ms/token"
                      + (f" busy {b:.2f} (idle {1 - b / h:.2f})" if profile
                         else "")
                      for tp, (p, h, b) in timing.items())
          + " (one card: the sharded code's cost, not multi-card speed); "
          f"at {time.perf_counter() - t_phase:.1f} s", flush=True)
    parted = [i for i in range(1, len(QUESTIONS)) if ids[i] != single[i]]
    single_lg, tp_lg = [logits[1]], [logits[2]]
    for i in parted:
        single_lg.append(_teacher_forced(ref.generator, *prompts[i],
                                         [single[i]])[0][0])
        tp_lg.append(_teacher_forced(dis.generator, *prompts[i],
                                     [single[i]])[0][0])
    worst, parts, shifts = _batched_rule(
        "disaggregated tp 2", [single[i] for i in [0] + parted], single_lg,
        [ids[i] for i in [0] + parted], tp_lg)
    print(f"disaggregated tp 2: teacher-forced logits {worst:.3e} of max "
          f"from the one-device decoder's (limit {OFFLINE_LOGIT_TOL}); the "
          f"placed session's ids {'equal' if ids == single else 'part'} "
          f"(questions {[0] + parted} held to the rule; partings: "
          f"(question, step, gap, shift in bf16 steps) {parts}; shift "
          f"elsewhere median {shifts[0]:.3f} max {shifts[1]:.3f} bf16 "
          f"steps)", flush=True)
    # tp 4's ids: the argmax of its teacher-forced steps, which are its
    # greedy decode's steps up to a first parting (the rule reads no
    # further)
    tp = DIS_TP[-1]
    g = gens.pop(tp)
    got = logits[tp].argmax(dim=-1).tolist()
    w, p, _ = _batched_rule(f"disaggregated tp {tp}", single[:1],
                            [logits[1]], [got], [logits[tp]])
    # a planted fault: the all-reduce leaves the last shard's partial out
    reduce = inference.TPGroup.all_reduce
    inference.TPGroup.all_reduce = (
        lambda self, parts: reduce(self, parts[:-1]))
    try:
        cache = g.new_cache(1, g._active_len(S, DIS_TOKENS))
        bad = g.prefill(args[0], args[1], cache, args[2], args[3])
    finally:
        inference.TPGroup.all_reduce = reduce
    fault = ((bad[0] - logits[1][0]).abs().max()
             / logits[1][0].abs().max()).item()
    if fault <= OFFLINE_LOGIT_TOL:
        raise AssertionError(f"disaggregated tp {tp}: a dropped partial "
                             f"reads {fault:.3e}, within the limit")
    del g, tpd, cache, bad
    print(f"disaggregated tp {tp}: teacher-forced logits {w:.3e} of max "
          f"(limit {OFFLINE_LOGIT_TOL}); the argmax ids of its "
          f"teacher-forced steps {'equal' if got == single[0] else 'part'} "
          f"{p}; planted fault "
          f"(one shard's partial left out of the all-reduce) {fault:.3e}, "
          f"refused; at {time.perf_counter() - t_phase:.1f} s", flush=True)

    # an answer on a thread while two more clips ingest
    snap, nf = dis._published
    before = [x.clone() for x in snap]
    gen8 = GenerationConfig(max_new_tokens=8)
    baseline = dis.answer_snapshot(snap, nf, QUESTIONS[0], gen8)
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "a", dis.answer_snapshot(snap, nf, QUESTIONS[0], gen8)))
    th.start()
    for c in clips[DIS_CLIPS:]:
        dis.ingest_frames(c)
    dis.block_until_ingested()
    th.join(timeout=300)
    if th.is_alive() or out.get("a") != baseline or dis.n_frames != n + 8:
        raise AssertionError(f"disaggregated: the concurrent answer "
                             f"{out.get('a')!r} against {baseline!r}, "
                             f"frame pairs {dis.n_frames}")
    if not all(torch.equal(a, b) for a, b in zip(snap, before)):
        raise AssertionError("disaggregated: an ingest changed a published "
                             "snapshot")
    t_save = time.perf_counter()

    # save / reset / load keep the placement
    os.makedirs(work, exist_ok=True)
    saved = dis._published
    path = dis.save_session(os.path.join(work, "disaggregated.pt"))
    dis.reset()
    if dis.n_frames or dis.state.tem_x.device != pl.ingest_device:
        raise AssertionError("disaggregated: reset lost the placement")
    dis.load_session(path)
    os.remove(path)
    if not (dis.placement is pl and dis.state.tem_x.device == pl.ingest_device
            and dis.n_frames == saved[1]
            and all(torch.equal(a, b) for a, b in zip(dis._published[0],
                                                      saved[0]))):
        raise AssertionError("disaggregated: save / load lost the stream or "
                             "the placement")
    print(f"disaggregated: concurrent answer equal to its baseline while 2 "
          f"clips ingest, the snapshot unchanged; save / reset / load keep "
          f"the placement (state on {dis.state.tem_x.device}, "
          f"{time.perf_counter() - t_save:.1f} s); launches of "
          f"the path K1={k1} K2={k2}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1, k2


VIDEO_DIR = os.path.join("tests", "data", "video")   # the committed fixture
VIDEO_FPS = 8.0           # the fixture's rate: all 16 frames, clips of 8
VIDEO_TOKENS = 17         # the answer's new ids at most
VIDEO_Q = "What is happening in the video?"
# cv2's FFmpeg decoder parts from libjpeg's (its own IDCT and chroma
# upsampling): read 6 levels max, 0.76 mean on the fixture on the CPU
VIDEO_CV2_MAX, VIDEO_CV2_MEAN = 12, 1.5


def _per_frame_ms(fn, n_frames, reps=5):
    """Host ms a frame of `fn` (a decode of n_frames), after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / (reps * n_frames)


def run_video_io(dev, params, root):
    """Real video in (ROADMAP A1) on the slice's weights (the decoder at
    QWEN_LAYERS): the port's I/O library built from its source with the
    host C++ compiler; the committed MJPEG mp4 fixture demuxed and decoded
    (preprocess/mp4.py, the port's own JPEG decoder) and its JPEG frame
    directory loaded, bit-equal to each other and to the fixture's expected
    frames (PIL's decode, the CPU test's limit: 0); load_video's chain as
    this machine has it (cv2 first when importable) within VIDEO_CV2_MAX;
    decode ms a frame at 224 px (the frames' size) and 448 px (decode +
    bilinear), from files and from memory; then cli_server's --video_file
    path in process (`run_server` over a session at VStreamQwenConfig()'s
    width, 16 frames of 224 px in clips of 8, one answer of up to
    VIDEO_TOKENS ids) with cv2 hidden, so that the chain reaches the
    demuxer: its ids must equal those of the same session fed the
    fixture's frames as arrays; and once more with the chain as it stands
    (cv2's frames: ids printed). Ingest ms/clip with the decode inline and
    through PrefetchLoader, in turns. Returns the K1/K2 launches of the
    demuxer run of cli_server."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
    from flash_vstream_tpu_torch.native import io as vio
    from flash_vstream_tpu_torch.preprocess import video as video_mod
    from flash_vstream_tpu_torch.preprocess.mp4 import (decode_mjpeg,
                                                        demux_mjpeg)
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    from flash_vstream_tpu_torch.serve.cli_server import (make_parser,
                                                          run_server)

    t_phase = time.perf_counter()
    vdir = os.path.join(root, VIDEO_DIR)
    mp4 = os.path.join(vdir, "scene.mp4")
    fdir = os.path.join(vdir, "scene_frames")
    cxx = vio._compiler()
    with tempfile.TemporaryDirectory() as tmp:   # a build of its own
        t0 = time.perf_counter()
        vio.build(vio.SOURCE, tmp)
        build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = vio.build()
    vio.library()
    print(f"video_io: the I/O library built from its source with {cxx} in "
          f"{build_s:.2f} s; {os.path.relpath(lib, root)} ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    want = np.load(os.path.join(vdir, "scene_expected.npz"))["frames"]
    mj = np.stack(decode_mjpeg(mp4, fps=VIDEO_FPS))
    fd = np.stack(list(video_mod.load_frame_dir(fdir, fps=VIDEO_FPS,
                                                source_fps=VIDEO_FPS)))
    if not (mj.shape == fd.shape == want.shape == (16, 224, 224, 3)
            and np.array_equal(mj, fd) and np.array_equal(mj, want)):
        raise AssertionError("video_io: the mp4's frames, the directory's "
                             "and the expected frames are not bit-equal")
    try:
        import cv2  # noqa: F401
        chain = "cv2"
    except ImportError:
        chain = "demuxer"
    lv = np.stack(list(video_mod.load_video(mp4, fps=VIDEO_FPS)))
    err = np.abs(lv.astype(np.int32) - want)
    print(f"video_io: MJPEG mp4 (16 frames, 224 px) demuxed and decoded == "
          f"its JPEG directory == the expected frames, bit for bit; "
          f"load_video's chain here ({chain} first): max |diff| "
          f"{int(err.max())}, mean {err.mean():.4f}", flush=True)
    if lv.shape != want.shape or err.max() > VIDEO_CV2_MAX or (
            err.mean() > VIDEO_CV2_MEAN):
        raise AssertionError("video_io: load_video's frames are off")

    paths = [os.path.join(fdir, n) for n in sorted(os.listdir(fdir))]
    blobs, _ = demux_mjpeg(mp4)
    ms = {
        "file 224": _per_frame_ms(
            lambda: vio.decode_batch(paths, 224, 224), len(paths)),
        "file 448": _per_frame_ms(
            lambda: vio.decode_batch(paths, 448, 448), len(paths)),
        "memory 224": _per_frame_ms(
            lambda: [vio.decode_bytes(b) for b in blobs], len(blobs)),
        "loader 224": _per_frame_ms(
            lambda: list(vio.PrefetchLoader(paths, 224, 224)), len(paths)),
    }
    print("video_io: decode ms a frame (host, one thread; 224 px JPEGs "
          "of the fixture): " + ", ".join(
              f"{k} {v:.4f}" for k, v in ms.items()), flush=True)

    cfg = _qwen_config()
    tok = make_byte_qwen_tokenizer()
    sess = QwenStreamSession(VStreamQwen(cfg, params), tok,
                             frame_hw=(224, 224), clip_size=8,
                             bank_size=1024, max_len=4096)
    captured = []
    real = sess.answer_tokens

    def answer_tokens(*a, **k):
        ids = real(*a, **k)
        captured.append([int(i) for i in ids])
        return ids
    sess.answer_tokens = answer_tokens
    args = make_parser().parse_args([
        "--device", str(dev), "--video_file", mp4, "--fps", str(VIDEO_FPS),
        "--clip-size", "8", "--frame-size", "224", "--play_speed", "0",
        "--question", VIDEO_Q, "--question_interval", "1e9",
        "--max-new-tokens", str(VIDEO_TOKENS)])
    gen = GenerationConfig(max_new_tokens=VIDEO_TOKENS,
                           eos_token_ids=(tok.eos_token_id,),
                           preemptible_chunk=args.preempt,
                           prefill_chunk=args.prefill_chunk)

    def reset():
        sess.reset()
        sess.metrics = type(sess.metrics)()

    # the session fed the fixture's frames as arrays
    reset()
    for c in range(0, 16, 8):
        sess.ingest_frames(list(want[c:c + 8]))
    sess.block_until_ingested()
    ref = [int(i) for i in real(*sess._published, VIDEO_Q, gen)]

    reset()
    _reset_launches()
    saved = sys.modules.get("cv2", None)
    sys.modules["cv2"] = None          # the chain as on a machine without
    try:                               # OpenCV: the MJPEG demuxer
        t0 = time.perf_counter()
        summary = run_server(args, session=sess)
        torch.cuda.synchronize(dev)
        cli_s = time.perf_counter() - t0
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    k1, k2 = flash_attention_cuda.launches, gather_rows_cuda.launches
    got = captured[-1]
    print(f"video_io: cli_server --video_file {VIDEO_DIR}/scene.mp4 (the "
          f"demuxer branch): {summary['frames_ingested']} frames, "
          f"{len(summary['answers'])} answer of {len(got)} ids in "
          f"{cli_s:.3f} s; ids == the array-fed session's: {got == ref} "
          f"({got[:8]}...); launches K1={k1} K2={k2}", flush=True)
    if summary["frames_ingested"] != 16 or got != ref or not got:
        raise AssertionError("video_io: the --video_file answer parts from "
                             "the array-fed session's")
    if min(k1, k2) == 0:
        raise AssertionError("video_io: a kernel of the path was never "
                             "launched")

    reset()
    run_server(args, session=sess)
    print(f"video_io: cli_server --video_file with the chain as it stands "
          f"({chain} first): ids == the array-fed session's: "
          f"{captured[-1] == ref}", flush=True)

    def ingest(prefetch):
        reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loader = (vio.PrefetchLoader(paths, 224, 224, prefetch_depth=16)
                  if prefetch else None)
        for c in range(0, 16, 8):
            frames = ([next(loader) for _ in range(8)] if prefetch
                      else list(vio.decode_batch(paths[c:c + 8], 224, 224)))
            sess.ingest_frames(frames)
            sess.block_until_ingested()
        torch.cuda.synchronize(dev)
        if loader is not None:
            loader.close()
        return (time.perf_counter() - t0) * 1e3 / 2
    ingest(False)                              # warm-up
    turns = {False: [], True: []}
    for prefetch in (False, True, True, False, False, True):
        turns[prefetch].append(ingest(prefetch))
    print(f"video_io: ingest ms/clip (8 frames of 224 px from JPEG files, "
          f"in turns): decode inline {np.mean(turns[False]):.3f} "
          f"{[round(x, 3) for x in turns[False]]}, PrefetchLoader "
          f"{np.mean(turns[True]):.3f} {[round(x, 3) for x in turns[True]]};"
          f" phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1, k2


# the forward against the same forward with K1's plain version, of each
# logit row's max: K1's own card limit (2e-2) holds one call; over the 32
# ViT and 28 decoder layers in bf16 the rows read 2.679e-2 (NVIDIA H100
# 80GB HBM3, 700 W). The witness is the same weights in f32: there K1's
# forward reads 2.322e-2 and the plain bf16 forward 2.302e-2, so each bf16
# forward is already past 2e-2 from the truth and the two may part by
# about their sum; the limit is the full-width logit limit the offline and
# reference checks use. K1's forward may sit at most ENTRY_F32_RATIO times
# the plain bf16 forward's distance from f32 (read 1.009). A planted fault
# (K1's output x 0.95 in every call) must fail both.
ENTRY_ROW_TOL = 5e-2
ENTRY_F32_RATIO = 1.05
ENTRY_FAULT = 0.95


def run_entry(dev):
    """The driver-entry forward (flash_vstream_tpu_torch/entry.py) at its
    real scale: the 32-layer Qwen2-VL vision tower, Flash memory, the
    merger and a Qwen2-VL-2B-shaped decoder (28 layers, width 1,536) in
    bf16 over 16 frames of 224 px; one forward (the path's run, K1's
    launches counted), finite logits; then timed (CUDA events, 3 runs) and
    held to the same forward with K1's plain version on the card, at
    ENTRY_ROW_TOL of each logit row's max, which K1's output scaled by
    ENTRY_FAULT must exceed. The witness of that limit: the same weights
    in f32 (plain attention, no TF32) give the truth, and K1's forward
    and the plain bf16 forward are each read against it. Returns K1's
    launches."""
    import torch
    from flash_vstream_tpu_torch.entry import entry
    from flash_vstream_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    fn, args = entry(device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    gb = _tree_nbytes(args[0]) / 1e9
    _reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    k1 = fa.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if not torch.isfinite(out).all():
        raise AssertionError("entry: logits are not finite")

    def timed(n=3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / n

    ms = timed()
    real = fa.flash_attention_cuda
    fa.flash_attention_cuda = (
        lambda q, k, v, **kw: fa.flash_attention_reference(q, k, v, **kw))
    try:
        want = fn(*args)
        plain_ms = timed()
    finally:
        fa.flash_attention_cuda = real
    def faulty(*a, **kw):
        return real(*a, **kw) * ENTRY_FAULT
    faulty.launches = 0              # the kernel's wrapper counts on it
    fa.flash_attention_cuda = faulty
    try:
        fault = fn(*args)
    finally:
        fa.flash_attention_cuda = real
    errs = logit_errors(out[0].float(), want[0].float())
    fault_err = max(logit_errors(fault[0].float(), want[0].float()))
    # the f32 truth of these weights: plain attention, f32 products
    params32 = _tree_float(args[0])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.flash_attention_cuda = (
        lambda q, k, v, **kw: fa.flash_attention_reference(q, k, v, **kw))
    try:
        truth = fn(params32, *args[1:])[0].float()
    finally:
        fa.flash_attention_cuda = real
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del params32
    k1_f32 = max(logit_errors(out[0].float(), truth))
    plain_f32 = max(logit_errors(want[0].float(), truth))
    fault_f32 = max(logit_errors(fault[0].float(), truth))
    print(f"entry: Qwen2-VL ViT (32 layers) + Flash memory + merger + "
          f"2B-shaped decoder (28 layers, 1536) in bf16, {gb:.3f} GB of "
          f"weights (init {init_s:.2f} s), 16 frames of 224 px: logits "
          f"{tuple(out.shape)} finite; {ms:.3f} ms a forward (plain K1 "
          f"{plain_ms:.3f} ms); peak {peak:.3f} GiB; K1 launches {k1}; "
          f"worst row err vs plain K1 {max(errs):.5f}, with K1's output x "
          f"{ENTRY_FAULT} {fault_err:.5f} (limit {ENTRY_ROW_TOL}); against "
          f"the f32 forward: K1's {k1_f32:.5f}, the plain bf16 "
          f"{plain_f32:.5f}, the fault's {fault_f32:.5f} (limit "
          f"{ENTRY_F32_RATIO} x the plain bf16's)", flush=True)
    f32_limit = ENTRY_F32_RATIO * plain_f32
    if (max(errs) > ENTRY_ROW_TOL or k1_f32 > f32_limit
            or fault_err <= ENTRY_ROW_TOL or fault_f32 <= f32_limit
            or k1 == 0):
        raise AssertionError("entry: the forward parts from the plain "
                             "version's or sits further from f32, the "
                             "fault passes, or K1 never launched")
    return k1


# C2: K1's distance from f32 attention against the Pallas arithmetic it
# keeps. At each K1 shape of the entry forward (the ViT's full and small
# frames, the decoder's prefill) and of train_reference's frozen ViT,
# C2_SEEDS draws of bf16 q/k/v at the path's own inputs' scale (each
# tensor's std), with the call's segment ids and causal flag, go through
# K1, the plain version (`xla_attention`'s arithmetic: p normalised in f32,
# then rounded) and the emulation of the Pallas forward
# (`flash_attention_pallas_emulation`: p unnormalised, rounded, l from
# the unrounded p), each read against f32 attention on the same inputs
# widened (no TF32): the worst row's max error over that row's max |f32|.
# K1 is at fault where its mean over the draws exceeds the emulation's by
# more than the draws' spread (the larger of the two's max - min); a
# planted fault (K1's output x C2_FAULT) must read as one. The path's own
# captured inputs are read once beside them.
C2_SEEDS = 5
C2_FAULT = 0.99


def _c2_capture(store):
    """A stand-in for K1's wrapper that keeps the first call's inputs of
    each (q shape, k shape, causal, segments) in `store`, then launches."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    real = fa.flash_attention_cuda

    def rec(q, k, v, **kw):
        key = (tuple(q.shape), tuple(k.shape), bool(kw.get("causal")),
               kw.get("q_segment_ids") is not None)
        if key not in store:
            store[key] = (q.clone(), k.clone(), v.clone(), {
                n: x.clone() if torch.is_tensor(x) else x
                for n, x in kw.items()})
        return real(q, k, v, **kw)
    rec.launches = 0                 # the kernel's wrapper counts on it
    return real, rec


def _c2_readings(dev, q, k, v, kw, real):
    """{form: [distance per draw]} over C2_SEEDS draws at the scale of
    (q, k, v), and {form: distance} on (q, k, v) themselves."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    forms = {"K1": lambda *a: real(*a, **kw),
             "plain": lambda *a: fa.flash_attention_reference(*a, **kw),
             "emulation": lambda *a: fa.flash_attention_pallas_emulation(
                 *a, **kw)}

    def read(qb, kb, vb):
        truth = fa.flash_attention_reference(qb.float(), kb.float(),
                                             vb.float(), **kw)
        rows = truth.abs().amax(-1) > 0
        out = {n: _row_err(f(qb, kb, vb), truth, rows)
               for n, f in forms.items()}
        out["fault"] = _row_err(real(qb, kb, vb, **kw).float() * C2_FAULT,
                                truth, rows)
        return out
    draws = []
    for seed in range(C2_SEEDS):
        g = torch.Generator(device=dev).manual_seed(seed)
        qb, kb, vb = ((torch.randn(x.shape, generator=g, device=dev)
                       * x.float().std()).to(torch.bfloat16).contiguous()
                      for x in (q, k, v))
        draws.append(read(qb, kb, vb))
    return ({n: [d[n] for d in draws] for n in draws[0]}, read(q, k, v))


def check_c2(dev):
    """C2's readings (see C2_SEEDS) at the K1 shapes of the entry forward
    and of train_reference's frozen ViT; prints a line a shape and fails
    if K1 sits further from f32 than the emulation beyond the draws'
    spread at any shape, or if the planted fault does not."""
    import torch
    from flash_vstream_tpu_torch.entry import entry
    from flash_vstream_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    shapes = {}
    fn, args = entry(device=dev)
    store = {}
    real, rec = _c2_capture(store)
    fa.flash_attention_cuda = rec
    try:
        fn(*args)
    finally:
        fa.flash_attention_cuda = real
    del fn, args
    _release(dev)
    for key, val in store.items():
        shapes[("entry decoder" if key[0][-1] == 128 else "entry vit")
               + f" {list(key[0])}"] = val
    store = {}
    real, rec = _c2_capture(store)
    fa.flash_attention_cuda = rec
    try:
        lora_leaf_grads(train_reference_case(), dev, torch.bfloat16)
    finally:
        fa.flash_attention_cuda = real
    for key, val in store.items():
        shapes[f"train_reference vit {list(key[0])}"] = val
    faults = []
    for name, (q, k, v, kw) in shapes.items():
        draws, own = _c2_readings(dev, q, k, v, kw, real)
        mean = {n: sum(x) / len(x) for n, x in draws.items()}
        spread = max(max(draws[n]) - min(draws[n]) for n in ("K1",
                                                               "emulation"))
        k1_fault = mean["K1"] - mean["emulation"] > spread
        caught = mean["fault"] - mean["emulation"] > spread
        print(f"c2 {name} causal={bool(kw.get('causal'))} "
              f"segments={kw.get('q_segment_ids') is not None}: distance "
              f"from f32 (worst row, of its max) over {C2_SEEDS} draws, "
              + ", ".join(f"{n} mean {mean[n]:.4e} (min {min(draws[n]):.4e} "
                          f"max {max(draws[n]):.4e})"
                          for n in ("K1", "plain", "emulation"))
              + f"; spread {spread:.4e}; the path's own inputs: "
              + ", ".join(f"{n} {own[n]:.4e}"
                          for n in ("K1", "plain", "emulation"))
              + f"; K1 x {C2_FAULT} mean {mean['fault']:.4e} "
              f"({'caught' if caught else 'NOT caught'}); K1 "
              f"{'FURTHER than its emulation' if k1_fault else 'as close as its emulation'}",
              flush=True)
        if k1_fault or not caught:
            faults.append(name)
    print(f"c2: {len(shapes)} shapes in {time.perf_counter() - t0:.1f} s; "
          + (f"K1 at fault or the planted fault missed at {faults}" if faults
             else "K1 is as close to f32 as the Pallas arithmetic at every "
                  "shape, and the planted fault reads as one"), flush=True)
    if faults or len(shapes) < 3:
        raise AssertionError(f"c2: {faults or 'too few shapes captured'}")


SERVE_Q = "What is happening in the video?"


def _http(base, path, body=None, content_type="application/json"):
    """One request to the port's HTTP server: (status, JSON reply, seconds).
    A status other than 200 or 201 raises."""
    import urllib.error
    import urllib.request
    if isinstance(body, dict):
        body = json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST")
    if body is not None:
        req.add_header("Content-Type", content_type)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, out = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, out = e.code, e.read()
    dt = time.perf_counter() - t0
    if code not in (200, 201):
        raise AssertionError(f"serve_http: {path} answered {code}: {out[:300]}")
    if out.startswith(b"data: "):
        return code, out, dt
    return code, json.loads(out), dt


def _sse_deltas(raw: bytes):
    """The text deltas of an SSE answer; it must end in data: [DONE]."""
    events = [line[len(b"data: "):] for line in raw.split(b"\n\n")
              if line.startswith(b"data: ")]
    if not events or events[-1] != b"[DONE]":
        raise AssertionError("serve_http: the SSE answer did not end in "
                             "data: [DONE]")
    return [json.loads(e)["delta"] for e in events[:-1]]


def _npy(frames):
    import io
    import numpy as np
    buf = io.BytesIO()
    np.save(buf, np.stack(frames))
    return buf.getvalue()


def run_serve_http(dev, params, work):
    """The port's HTTP server (serve/http_server.py) in a thread on an
    ephemeral port over the slice's full-width bf16 weights (Qwen2-VL-7B,
    224 px, clip 8, bank 1,024, max_len 4,096), its chunk sizes those of
    `--preempt 8 --prefill-chunk 512`. Two streams, the second a clone of
    the first: each gets 4 clips of .npy frames and a flushed partial clip
    of 3, different frames on each. Over HTTP, with the ids of each answer
    read from the session's `answer_tokens`: a greedy answer of 32 tokens
    (its ids those of `answer_tokens` called directly on the same snapshot;
    the SSE deltas, joined, its text up to the whitespace the plain answer
    strips), a preemptible one (decode chunks of 8, the prompt of about
    2,460 tokens prefilled in chunks of 512: the first chunk launches K1,
    the rest take the q_offset > 0 path) and a speculative one (k 4), each
    the greedy ids; a sampled one (temperature 0.8, top_k 50, top_p 0.9,
    seed 0) twice, the same ids; `_sample` on the card and on the CPU on the
    same logits and noise, the same ids. Stream B's snapshot against a solo
    session fed the same frames (the same positions, features within bf16
    rounding) and against stream A's (different features). Stream A saved,
    loaded into a fresh clone and answered: the greedy ids. Every failed
    check is printed, then the phase raises. Then the prompt's prefill
    alone, one-shot and in chunks of 512, timed in turn. Returns the K1
    and K2 launches of the path (the prefill timing's not counted)."""
    import threading
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.generation import (
        GenerationConfig, _sample)
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    from flash_vstream_tpu_torch.serve.http_server import serve_http

    cfg = _qwen_config()
    model = VStreamQwen(cfg, params)
    tok = make_byte_qwen_tokenizer()

    def new_session():
        return QwenStreamSession(model, tok, frame_hw=(224, 224), clip_size=8,
                                 bank_size=1024, max_len=4096)

    rng = np.random.default_rng(SEED + 2)
    clips = {s: [_frames(rng, 8, (224, 224)) for _ in range(4)]
             + [_frames(rng, 3, (224, 224))] for s in ("a", "b")}
    failed = []

    def check(ok, what):
        print(f"serve_http: {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            failed.append(what)

    httpd = serve_http(new_session, port=0, preempt_chunk=8,
                       prefill_chunk=512)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    flash_attention_cuda.launches = 0
    gather_rows_cuda.launches = 0
    try:
        t0 = time.perf_counter()
        for sid in ("a", "b"):
            _http(base, "/v1/streams", {"id": sid})
            for i, clip in enumerate(clips[sid]):
                flush = "?flush=1" if i == len(clips[sid]) - 1 else ""
                _http(base, f"/v1/streams/{sid}/frames{flush}", _npy(clip),
                      "application/octet-stream")
        torch.cuda.synchronize(dev)
        ingest_s = time.perf_counter() - t0
        sa = httpd.registry.get("a").session
        sb = httpd.registry.get("b").session
        check(sb is not sa and sb.model is sa.model
              and sb.generator is sa.generator,
              "stream b is a clone of stream a's session (one model, one "
              "Generator)")
        check(sa.n_frames == sb.n_frames == 4 * 4 + 2,
              f"frame pairs a={sa.n_frames} b={sb.n_frames} (18 each)")

        ids = []                           # each HTTP answer's token ids
        tokens = sa.answer_tokens

        def recorded(*a, **k):
            out = tokens(*a, **k)
            ids.append(list(out))
            return out
        sa.answer_tokens = recorded
        q = {"question": SERVE_Q, "max_new_tokens": 32}
        url = "/v1/streams/a/answer"
        eos = (tok.eos_token_id,)
        _, greedy, greedy_s = _http(base, url, q)
        greedy_ids = ids[-1]
        n = {"greedy": len(greedy_ids), "sse": len(greedy_ids)}
        h = sa._prompt_host(SERVE_Q, sa.n_frames)
        direct = tokens(*sa._published, SERVE_Q,
                        GenerationConfig(max_new_tokens=32, eos_token_ids=eos))
        check(greedy_ids == direct and len(direct) >= 1,
              f"greedy over HTTP = answer_tokens on the snapshot "
              f"({len(direct)} tokens, S={h['S']})")
        _, raw, sse_s = _http(base, url, dict(q, stream=True))
        deltas = _sse_deltas(raw)
        check("".join(deltas).strip() == greedy["answer"],
              f"SSE: {len(deltas)} deltas join into the answer "
              f"{greedy['answer'][:24]!r}")
        _, _, preempt_s = _http(base, url, dict(q, preemptible_chunk=1))
        n["preemptible"] = len(ids[-1])
        check(ids[-1] == greedy_ids,
              "preemptible (decode chunks of 8, prefill chunks of 512) = "
              "greedy ids" + ("" if ids[-1] == greedy_ids else
                              f": {ids[-1]} vs {greedy_ids}"))
        _, _, spec_s = _http(base, url, dict(q, speculative_k=4))
        spec = dict(sa.generator.last_spec)
        n["speculative"] = len(ids[-1])
        check(ids[-1] == greedy_ids, "speculative (k 4) = greedy ids" + (
            "" if ids[-1] == greedy_ids else f": {ids[-1]} vs {greedy_ids}"))
        sample = dict(q, temperature=0.8, top_k=50, top_p=0.9)
        _, _, sample_s = _http(base, url, sample)
        n["sampled"] = len(ids[-1])
        _http(base, url, sample)
        check(ids[-1] == ids[-2] and len(ids[-1]) >= 1,
              "sampled (0.8, top_k 50, top_p 0.9, seed 0) twice: same ids")
        del sa.answer_tokens
        g = torch.Generator().manual_seed(SEED)
        logits = torch.randn(4, cfg.llm.vocab_size, generator=g) * 3
        logits[:, :60] = logits[:, :1]               # ties at the top
        noise = -torch.log(-torch.log(torch.rand(logits.shape, generator=g)))
        for kw in (dict(temperature=0.8, top_k=50, top_p=0.9),
                   dict(temperature=1.3), dict(temperature=0.6, top_k=5)):
            gen = GenerationConfig(**kw)
            cpu = _sample(logits, gen, noise)
            card = _sample(logits.to(dev), gen, noise.to(dev)).cpu()
            check(torch.equal(cpu, card),
                  f"_sample card = CPU at {kw}: {card.tolist()}")

        solo = new_session()
        for clip in clips["b"]:
            solo.ingest_frames(clip)
        sb_snap = [x.float() for x in sb._published[0]]
        solo_snap = [x.float() for x in solo._published[0]]
        sa_snap = [x.float() for x in sa._published[0]]
        feat = max((x - y).abs().max().item()
                   for x, y in zip(sb_snap[2:], solo_snap[2:]))
        apart = (sb_snap[2] - sa_snap[2]).abs().max().item()
        check(all(torch.equal(x, y) for x, y in zip(sb_snap[:2],
                                                     solo_snap[:2]))
              and feat <= 5e-2 and apart > 0.5,
              f"stream b = a solo session on its frames (positions equal, "
              f"features {feat:.3e} apart), and not stream a (features "
              f"{apart:.3f} apart)")
        del solo

        os.makedirs(work, exist_ok=True)
        path = os.path.join(work, "stream_a.pt")
        t0 = time.perf_counter()
        sa.save_session(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        resumed = sa.clone_fresh()
        t0 = time.perf_counter()
        resumed.load_session(path)
        load_s = time.perf_counter() - t0
        os.remove(path)
        again = resumed.answer_tokens(
            *resumed._published, SERVE_Q,
            GenerationConfig(max_new_tokens=32, eos_token_ids=eos))
        check(again == greedy_ids and resumed.n_frames == sa.n_frames,
              f"save ({size / 2**30:.3f} GiB, {save_s:.2f} s) and load "
              f"({load_s:.2f} s) into a clone: greedy ids")
        del resumed
        k1, k2 = flash_attention_cuda.launches, gather_rows_cuda.launches
        # the prompt's prefill alone, one-shot (K1) and in chunks of 512
        # (the first through K1, the rest on the q_offset > 0 path), in turn
        embeds, pos, _, seg = sa._prompt_inputs(sa._published[0], h)
        gen_ = sa.generator
        prefill_ms = {"one-shot": [], "chunks of 512": []}
        for mode in ("one-shot", "chunks of 512", "chunks of 512",
                     "one-shot"):
            cache = gen_.new_cache(1, gen_._active_len(h["S"], 32))
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if mode == "one-shot":
                gen_.prefill(embeds, pos, cache, seg, h["last_real"])
            else:
                gen_._prefill_chunked(embeds, pos, cache, seg, h["last_real"],
                                      512)
            torch.cuda.synchronize(dev)
            prefill_ms[mode].append((time.perf_counter() - t0) * 1e3)
        del cache
        torch.cuda.synchronize(dev)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    print(f"serve_http: 2 streams x 35 frames (4 clips + a partial clip) "
          f"ingested over HTTP in {ingest_s:.2f} s; S={h['S']}", flush=True)
    for name, sec in (("greedy", greedy_s), ("sse", sse_s),
                      ("preemptible", preempt_s), ("speculative", spec_s),
                      ("sampled", sample_s)):
        print(f"serve_http: {name} answer {sec:.3f} s over HTTP, "
              f"{1e3 * sec / n[name]:.1f} ms/token ({n[name]} tokens)",
              flush=True)
    print(f"serve_http: prefill S={h['S']} in turn: " + ", ".join(
        f"{k} {' '.join(f'{v:.1f}' for v in ms)} ms"
        for k, ms in prefill_ms.items()), flush=True)
    rate = spec["accepted"] / max(spec["drafted"], 1)
    print(f"serve_http: speculation k 4: {spec['rounds']} verify rounds, "
          f"{spec['accepted']} of {spec['drafted']} drafted tokens accepted "
          f"(acceptance {rate:.3f}), "
          f"{n['speculative'] / max(spec['rounds'], 1):.2f} "
          f"tokens a forward (random weights)", flush=True)
    print(f"serve_http: launches K1={k1} K2={k2}", flush=True)
    if not (k1 > 0 and k2 > 0):
        raise AssertionError("serve_http: a kernel of the path was never "
                             "launched")
    if failed:
        raise AssertionError(f"serve_http: {len(failed)} checks failed: "
                             f"{failed}")
    return k1, k2


OFFLINE_FRAMES = 240        # frames of the offline video question
OFFLINE_SIDE = 448          # their side in px: a (120, 32, 32) grid
OFFLINE_CHUNK = 2048        # the chunked prefill's sequence chunk
OFFLINE_Q = "What happens in the video, scene by scene?"
OFFLINE_SHARD = 5 * 10 ** 9  # the checkpoint's largest shard, bytes
# First-token logits of the one-shot prefill (K1 over the whole prompt)
# against the prefill in chunks of 2,048 (K1 on the first chunk, the plain
# cache path's f32 scores on the rest), max |diff| over max |logit|: both
# run the bf16 weights and round bf16 activations in different places, as
# check_reference's card vs CPU prefill does, under the same limit.
OFFLINE_LOGIT_TOL = 5e-2


def _offline_frames(rng, n, side, n_scenes=8):
    """n uint8 frames of side x side px in n_scenes scenes, each scene a
    random texture plus fresh noise on every frame, so that k-means has
    clusters to find and no two frames are equal."""
    import numpy as np
    out = []
    for i in range(n_scenes):
        scene = rng.integers(0, 256, size=(side, side, 3), dtype=np.int16)
        for _ in range(n // n_scenes + (i < n % n_scenes)):
            noise = rng.integers(-24, 25, size=scene.shape, dtype=np.int16)
            out.append(np.clip(scene + noise, 0, 255).astype(np.uint8))
    return out


def _write_checkpoint(params, cfg, ckpt, dev):
    """The slice's weights as an HF checkpoint with its config.json, in
    shards of at most OFFLINE_SHARD bytes (the offline phase writes it,
    finetune_ckpt trains from it). Returns (shard names, tensor bytes,
    seconds of the write alone)."""
    import torch
    from flash_vstream_tpu_torch.weights.export import (
        export_llama, export_qwen_vit, hf_qwen_config, save_hf_checkpoint)
    sd = export_llama(params["llm"], cfg.llm)
    sd.update(export_qwen_vit(params["vit"], cfg.vit))
    total = sum(t.numel() * t.element_size() for t in sd.values())
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    names = save_hf_checkpoint(ckpt, sd, config=hf_qwen_config(cfg),
                               max_shard_bytes=OFFLINE_SHARD)
    return names, total, time.perf_counter() - t0


def _leaf_pairs(a, b, path=""):
    """(path, leaf of a, leaf of b) over two trees with the same keys
    (dicts, and lists or NamedTuples of leaves, as the LLaVA tree's
    projector layers and NTMParams)."""
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: {len(a)} entries, the loaded "
                                 f"tree {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaf_pairs(x, y, f"{path}{i}/")
        return
    if not isinstance(a, dict):
        yield path.rstrip("/"), a, b
        return
    if sorted(a) != sorted(b):
        raise AssertionError(f"offline: {path or 'the tree'} has keys "
                             f"{sorted(a)}, the loaded one {sorted(b)}")
    for k in sorted(a):
        yield from _leaf_pairs(a[k], b[k], f"{path}{k}/")


def _npy_video(root, name, frames):
    """A frame directory of one `.npy` file per frame."""
    import numpy as np
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        np.save(os.path.join(d, f"frame_{i:06d}.npy"), f)


def _answers(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_offline(dev, params, work, card, root, keep_ckpt=False):
    """Offline QA at full width on the slice's weights (Qwen2-VL-7B, random
    bf16), through QwenPipeline, the checkpoint loaders and the eval
    harness. 1. A question over 240 frames of 448 px (grid (120, 32, 32):
    7,680 DAM + 3,840 CSM tokens, S about 11.6k): the encode, the one-shot
    prefill and the decode timed, the peak memory; its first-token logits
    against the prefill in chunks of 2,048 and its greedy ids against the
    chunked answer's, and `answer_tokens` twice with one seed, all equal.
    2. `answer_image_tokens` on a 448 x 448 and a 392 x 504 image. 3. The
    weights exported, written by the port's safetensors writer in shards
    of at most 5 GB under build/offline_ckpt with a Qwen2-VL-7B
    config.json, read back to the same config and loaded onto the card
    bit-equal, write and load timed; the directory is deleted. 4. The eval
    worker (`run_inference`) on the loaded weights over `.npy` frame
    directories: an MCQ sample and a consistency pair, every id answered,
    each pred the in-memory pipeline's answer, then `calc_mcq_result`.
    5. `eval_any_dataset --dry-run --num-chunks 2` as a subprocess with no
    --device: two card workers, both exit 0, every id in their answers.
    Returns K1's launches in 1-4, checked against the count reckoned from
    the calls (2 x 32 ViT + 1 a decoder layer a video answer's prefill, 32
    + 1 a layer an image answer, 1 a layer a prefill alone; a chunked
    prefill launches K1 on its first chunk only). With `keep_ckpt` the checkpoint directory stays for
    finetune_ckpt, which deletes it."""
    import dataclasses
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.eval import inference_mcq_vqa as worker
    from flash_vstream_tpu_torch.eval.scoring import calc_mcq_result
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.models.vstream_qwen import (
        image_token_count, visual_token_count)
    from flash_vstream_tpu_torch.preprocess.image import smart_resize
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        _video_pad_id, build_video_prompt, make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    from flash_vstream_tpu_torch.runtime.pipeline import QwenPipeline
    from flash_vstream_tpu_torch.weights.convert import (
        load_qwen_checkpoint, qwen_config_from_hf)

    cfg = _qwen_config()
    tok = make_byte_qwen_tokenizer()
    pipe = QwenPipeline(params, cfg, tok, max_len=16384,
                        max_pixels=4 * 224 * 224)
    g = pipe.generator
    gen = GenerationConfig(max_new_tokens=32,
                           eos_token_ids=(tok.eos_token_id,))
    # K1 launches of each call kind: a video's ViT runs both resolution
    # streams through every layer, an image's its one segment
    per_call = {"video": 2 * cfg.vit.num_layers, "image": cfg.vit.num_layers,
                "prefill": cfg.llm.num_layers}
    calls = dict.fromkeys(per_call, 0)
    tag = f"offline [{card}]:"
    options = "\nA. a street\nB. a kitchen\nC. a forest\nD. a beach"

    def sync():
        torch.cuda.synchronize(dev)

    rng = np.random.default_rng(SEED)
    frames = _offline_frames(rng, OFFLINE_FRAMES, OFFLINE_SIDE)
    _release(dev)
    flash_attention_cuda.launches = 0

    # 1. the video question
    sync()
    t0 = time.perf_counter()
    embeds, pos, start = pipe.video_inputs(frames, OFFLINE_Q, seed=SEED)
    sync()
    encode_s = time.perf_counter() - t0
    calls["video"] += 1
    peak_encode = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    grid = (OFFLINE_FRAMES // 2, OFFLINE_SIDE // 14, OFFLINE_SIDE // 14)
    dam, csm = visual_token_count(cfg, *grid)
    ids, (v0, n_vis) = build_video_prompt(cfg, tok, OFFLINE_Q, grid=grid)
    S = embeds.shape[1]
    n_pads = int((ids == _video_pad_id(tok, cfg)).sum())
    if not (n_vis == n_pads == dam + csm and S == len(ids) and tuple(pos.shape) == (3, 1, S)
            and bool(torch.isfinite(embeds).all())):
        raise AssertionError(f"offline: visual tokens {dam} + {csm}, "
                             f"{n_pads} pads in the prompt, S {S}")
    cache = g.new_cache(1, g._active_len(S, gen.max_new_tokens))
    sync()
    t0 = time.perf_counter()
    logits = g.prefill(embeds, pos, cache)
    sync()
    prefill_s = time.perf_counter() - t0
    del cache
    cache = g.new_cache(1, g._active_len(S, gen.max_new_tokens))
    t0 = time.perf_counter()
    logits_c = g._prefill_chunked(embeds, pos, cache, None, None,
                                  OFFLINE_CHUNK)
    sync()
    chunked_s = time.perf_counter() - t0
    del cache
    calls["prefill"] += 2
    scale = logits.float().abs().max().item()
    lerr = (logits_c.float() - logits.float()).abs().max().item()
    if not (torch.isfinite(logits).all() and torch.isfinite(logits_c).all()
            and lerr <= OFFLINE_LOGIT_TOL * scale):
        raise AssertionError(f"offline: first-token logits one-shot vs "
                             f"chunks of {OFFLINE_CHUNK} differ by {lerr:.3e}"
                             f" (max |logit| {scale:.3e}, limit "
                             f"{OFFLINE_LOGIT_TOL:.0e} of it)")
    t0 = time.perf_counter()
    ids_a = g.generate(embeds, pos, gen, decode_pos_start=start)
    sync()
    decode_s = time.perf_counter() - t0 - prefill_s
    ids_c = g.generate(embeds, pos, dataclasses.replace(
        gen, preemptible_chunk=8, prefill_chunk=OFFLINE_CHUNK),
        decode_pos_start=start)
    calls["prefill"] += 2
    del embeds, pos
    ids_1 = pipe.answer_tokens(frames, OFFLINE_Q, gen, seed=SEED)
    ids_2 = pipe.answer_tokens(frames, OFFLINE_Q, gen, seed=SEED)
    calls["video"] += 2
    calls["prefill"] += 2
    sync()
    peak_video = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not (ids_c == ids_a and ids_1 == ids_2 == ids_a and 1 <= len(ids_a)
            and all(0 <= t < cfg.llm.vocab_size for t in ids_a)):
        raise AssertionError(f"offline: greedy ids one-shot {ids_a}, in "
                             f"prefill chunks {ids_c}, answer_tokens "
                             f"{ids_1} / {ids_2}")
    print(f"{tag} video {OFFLINE_FRAMES} frames {OFFLINE_SIDE}x"
          f"{OFFLINE_SIDE} grid {grid}: {dam} DAM + {csm} CSM visual tokens "
          f"= the prompt's {n_pads} pads, S={S}; encode_s={encode_s:.3f} "
          f"prefill_s={prefill_s:.3f} (one-shot, K1) "
          f"prefill_chunked_s={chunked_s:.3f} (chunks of {OFFLINE_CHUNK}) "
          f"decode_s={decode_s:.3f} for {len(ids_a)} tokens "
          f"({decode_s / len(ids_a) * 1e3:.1f} ms/token); peak memory "
          f"{peak_encode:.2f} GiB after the encode, {peak_video:.2f} GiB "
          f"over the answers", flush=True)
    print(f"{tag} first-token logits one-shot vs chunks of {OFFLINE_CHUNK}: "
          f"max diff {lerr:.3e} of max |logit| {scale:.3e} (limit "
          f"{OFFLINE_LOGIT_TOL:.0e} of it); greedy ids one-shot = chunked "
          f"prefill (decode chunks of 8) = answer_tokens twice with seed "
          f"{SEED}: {len(ids_a)} tokens, text "
          f"{tok.decode(ids_a, skip_special_tokens=True)[:32]!r}", flush=True)

    # 2. two images
    for name, hw in (("448x448", (448, 448)), ("392x504", (392, 504))):
        image = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
        gh, gw = (x // 14 for x in smart_resize(*hw, factor=56,
                                                max_pixels=pipe.max_pixels))
        sync()
        t0 = time.perf_counter()
        ids_i = pipe.answer_image_tokens(image, "What is shown?", gen)
        sync()
        calls["image"] += 1
        calls["prefill"] += 1
        if not (1 <= len(ids_i) and all(0 <= t < cfg.llm.vocab_size
                                        for t in ids_i)):
            raise AssertionError(f"offline: image {name} ids {ids_i}")
        print(f"{tag} image {name} grid {gh}x{gw} ({gh * gw} ViT tokens in "
              f"one segment, {image_token_count(gh, gw)} visual tokens): "
              f"{len(ids_i)} ids in {time.perf_counter() - t0:.3f} s",
              flush=True)

    # 3. the checkpoint round trip
    ckpt = os.path.join(root, "build", "offline_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        names, total, write_s = _write_checkpoint(params, cfg, ckpt, dev)
        sizes = [os.path.getsize(os.path.join(ckpt, n)) for n in names]
        lcfg = qwen_config_from_hf(ckpt)
        if lcfg != cfg or max(sizes) > OFFLINE_SHARD + 2 ** 20:
            raise AssertionError(f"offline: config.json reads back as "
                                 f"{lcfg}; shards {sizes}")
        t0 = time.perf_counter()
        loaded = load_qwen_checkpoint(ckpt, lcfg, dtype=torch.bfloat16,
                                      device=dev)
        sync()
        load_s = time.perf_counter() - t0
        n_leaves = 0
        for path, a, b in _leaf_pairs(params, loaded):
            n_leaves += 1
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"offline: loaded leaf {path} differs")
        print(f"{tag} checkpoint {total / 1e9:.2f} GB in {len(names)} shards "
              f"(largest {max(sizes) / 1e9:.2f} GB): write_s={write_s:.2f} "
              f"({total / 1e9 / write_s:.2f} GB/s) load_s={load_s:.2f} "
              f"({total / 1e9 / load_s:.2f} GB/s, read back from the page "
              f"cache); config.json = the config ({cfg.llm.num_layers} "
              f"decoder layers); {n_leaves} leaves "
              f"bit-equal", flush=True)
        if not keep_ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)

        # 4. the eval worker on the loaded weights
        data = os.path.join(work, "offline_eval")
        shutil.rmtree(data, ignore_errors=True)       # no answers to resume
        _npy_video(os.path.join(data, "frames"), "v0", frames)
        _npy_video(os.path.join(data, "frames"), "v1",
                   _offline_frames(rng, OFFLINE_FRAMES, OFFLINE_SIDE))
        del frames
        qa = {"mcq": [{"id": "mcq", "video_id": "v0", "answer": 1,
                       "question": "Where is the video taken?" + options}],
              "pair": [{"id": "pair", "video_id": "v1", "answer": 2,
                        "question1": "Where does it happen?" + options,
                        "question2": "What is the place?" + options}]}
        lpipe = QwenPipeline(loaded, lcfg, tok, max_pixels=pipe.max_pixels)
        t0 = time.perf_counter()
        for name, samples in qa.items():
            with open(os.path.join(data, f"{name}.json"), "w") as f:
                json.dump(samples, f)
            args = worker.make_parser().parse_args([
                "--dataset", "mvbench", "--video-dir",
                os.path.join(data, "frames"), "--data-file",
                os.path.join(data, f"{name}.json"), "--output-dir",
                os.path.join(data, name), "--max-frames",
                str(OFFLINE_FRAMES), "--max-new-tokens", "32"])
            recs = _answers(worker.run_inference(args, pipeline=lpipe))
            if [r["id"] for r in recs] != [s["id"] for s in samples]:
                raise AssertionError(f"offline: the worker's answers file "
                                     f"holds ids {[r['id'] for r in recs]}"
                                     f" (a failed sample is printed above)")
            for rec in recs:
                paths = worker.sample_frame_paths(
                    os.path.join(data, "frames", rec["video_id"]), None,
                    OFFLINE_FRAMES)
                video = worker.load_frames(paths)
                keys = (("pred", "question"),) if "pred" in rec else (
                    ("pred1", "question1"), ("pred2", "question2"))
                for pk, qk in keys:
                    q, _ = worker.build_question(rec, "mvbench",
                                                 q_base=rec[qk])
                    want = pipe.answer(video, q + "\nBest option: (", gen)
                    calls["video"] += 2
                    calls["prefill"] += 2
                    if rec[pk] != want:
                        raise AssertionError(
                            f"offline: worker {rec['id']} {pk} {rec[pk]!r}, "
                            f"in-memory pipeline {want!r}")
        worker_s = time.perf_counter() - t0
        acc = calc_mcq_result(os.path.join(data, "mcq"), 1,
                              os.path.join(data, "mcq.json"),
                              dataset_name="mvbench")["acc"]
        print(f"{tag} eval worker on the loaded weights: MCQ sample + "
              f"consistency pair over {OFFLINE_FRAMES} .npy frames, every "
              f"id answered, 3 preds = the in-memory pipeline's; "
              f"calc_mcq_result acc {acc}; {worker_s:.1f} s with the "
              f"in-memory answers", flush=True)
        del loaded, lpipe
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise
    if not keep_ckpt:
        shutil.rmtree(ckpt, ignore_errors=True)
    k1 = flash_attention_cuda.launches
    want_k1 = sum(per_call[k] * n for k, n in calls.items())
    if k1 != want_k1:
        raise AssertionError(f"offline: K1 launched {k1} times, reckoned "
                             f"{want_k1} from {calls}")

    # K1 at the answer prefill's own shape, timed (not counted above)
    q = torch.randn(1, cfg.llm.num_heads, S, cfg.llm.head_dim, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(1, cfg.llm.num_kv_heads, S, cfg.llm.head_dim,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    ms = _ms(lambda i: flash_attention_cuda(q, k, v, causal=True), 5)
    lib = _ms(lambda i: _sdpa(q, k, v, True), 5)
    bound = _bound(_visible_pairs(q, k, True, None, None) * 4 * q.shape[-1],
                   _nbytes(q, k, v, q))
    print(f"{tag} K1 at the offline prefill q{tuple(q.shape)} "
          f"k{tuple(k.shape)} causal: kernel_ms={ms:.4f} bound_ms="
          f"{bound[0]:.4f} ({bound[1]}) library_ms={lib:.4f} "
          f"(scaled_dot_product_attention)", flush=True)
    del q, k, v

    # 5. the launcher, its workers on the card
    launch = os.path.join(work, "offline_launch")
    shutil.rmtree(launch, ignore_errors=True)
    for i in range(2):
        _npy_video(os.path.join(launch, "mvbench", "frames"), f"vid{i}",
                   [rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
                    for _ in range(4)])
    with open(os.path.join(launch, "mvbench", "test_qa.json"), "w") as f:
        json.dump([{"id": str(i), "video_id": f"vid{i % 2}", "answer": 0,
                    "question": f"Q{i}?" + options} for i in range(4)], f)
    out = os.path.join(launch, "out")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "flash_vstream_tpu_torch.eval.eval_any_dataset",
         "--dry-run", "--num-chunks", "2", "--dataset", "mvbench",
         "--data-root", launch, "--output-dir", out, "--max-frames", "4"],
        cwd=root, capture_output=True, text=True, timeout=600)
    launch_s = time.perf_counter() - t0
    held = {i: sorted(r["id"] for r in _answers(
        os.path.join(out, f"2_{i}.json"))) for i in range(2)
        if os.path.exists(os.path.join(out, f"2_{i}.json"))}
    if (proc.returncode != 0 or "worker exited with" in proc.stdout
            or held != {0: ["0", "2"], 1: ["1", "3"]}):
        raise AssertionError(f"offline: eval_any_dataset exited "
                             f"{proc.returncode}, answers {held}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    print(f"{tag} eval_any_dataset --dry-run --num-chunks 2: two card "
          f"workers exit 0, answers 2_0 {held[0]} 2_1 {held[1]}, "
          f"{launch_s:.1f} s", flush=True)
    print(f"{tag} launches K1={k1} = {per_call['video']} x {calls['video']} "
          f"video encodes + {per_call['image']} x {calls['image']} image "
          f"encodes + {per_call['prefill']} x {calls['prefill']} prefills",
          flush=True)
    return k1


def _tree_to(tree, device, dtype=None):
    """A tree of dicts, lists and NamedTuples of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(v, device, dtype) for v in tree))
    return tree.to(device, dtype)


def _scene_frames(rng, n_scenes, side):
    """Temporal pairs of two equal frames; each scene has an exact pair
    followed by two noisy ones, so each scene's exact pair is the clear
    nearest frame to the scene's cluster mean."""
    import numpy as np
    frames = []
    for _ in range(n_scenes):
        scene = rng.integers(0, 256, size=(side, side, 3))
        for noise in (0, 48, 48):
            f = np.clip(scene + rng.integers(-noise, noise + 1, scene.shape),
                        0, 255).astype(np.uint8)
            frames += [f, f]
    return frames


# Card against card (train_parallel) holds each adapter leaf's gradient to
# this relative L2 error. bf16 sets the floor: on the CPU alone, two bf16
# runs that differ only in summation order differ by up to ~4e-2 in a leaf,
# while dk scaled by 0.9 in the attention backward moves wk's leaves by
# ~1e-1 (tests/test_torch_train_reference.py reads both).
TRAIN_REF_LIMIT = 8e-2
# The training reference holds each adapter leaf's bf16 gradient on the
# card to the CPU's f32 gradient on the same bf16 weights upcast (a bf16
# reference on the CPU moved with the host: 1.286e-1 and 6.822e-2 on two
# hosts at one card loss). Two limits a leaf. Its relative L2 error: bf16
# takes it to 1.084e-1 on an H100 (a merger leaf, the same run to run;
# 7.46e-2 with K1's plain version in the frozen ViT, whose output the
# merger takes) and to 7.2e-2-1.35e-1 on CPUs; a misrouted dq reads
# 2.24e-1 on the card (TRAIN_REF_FAULTS). Its gain,
# |<g, ref> / <ref, ref> - 1|, the error along the reference, which bf16
# keeps at 4.83e-2 on the card and 3.8e-2 on the CPU while dk x 0.9 in the
# attention backward reads 1.26e-1-1.32e-1 in wk's leaves on the card and
# 1.09e-1-1.12e-1 on the CPU: a scaled gradient fails the gain where its
# L2 error (1.44e-1-1.46e-1 on the card) sits near bf16's
# (tests/test_torch_train_reference.py reads both on the CPU, and the
# card's gap to f32 kernel by kernel).
TRAIN_REF_F32_LIMIT = 1.5e-1
TRAIN_REF_GAIN_LIMIT = 8e-2
# The faults train_reference plants in the card's attention backward (K4
# + K5's dq, dk, dv), each with the limit it must fail: dk x 0.9 keeps the
# gradient's direction, so the gain sees it where the rel L2 hardly does;
# a fifth of each query's dq added to the next query's (a misrouted
# gradient, nearly orthogonal to the reference) moves the rel L2 past its
# limit (2.76e-1 on the CPU) while the gain stays under its own (4.35e-2).
TRAIN_REF_FAULTS = {
    "dk x 0.9": ("gain", lambda dq, dk, dv: (dq, dk * 0.9, dv)),
    "dq + 0.2 x the query before's": (
        "rel L2", lambda dq, dk, dv: (dq + 0.2 * dq.roll(1, dims=2), dk, dv)),
}


def train_reference_case():
    """The small model's LoRA sample (ViT head_dim 80, decoder head_dim
    128, two layers each): bf16 weights, rank-8 adapters with b != 0 (so a
    has a gradient), four scenes of frames and k-means draws that seed one
    cluster at each scene, so the clustering has one answer everywhere."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.models.vstream_qwen import init_qwen_params
    from flash_vstream_tpu_torch.preprocess.image import qwen_preprocess
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.train.finetune_flash import (
        preprocess_qwen_sample)
    from flash_vstream_tpu_torch.train.lora import (QWEN_TARGETS,
                                                    init_lora_params)

    cfg = _small_cfg()
    gen = torch.Generator().manual_seed(SEED)
    params = init_qwen_params(cfg, gen, "cpu", dtype=torch.bfloat16)
    lora = init_lora_params(gen, params, rank=8, targets=QWEN_TARGETS)
    for ab in lora.values():                  # b != 0, so a has a gradient
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.05
    rng = np.random.default_rng(SEED)
    n_scenes = 4
    patches, grid = qwen_preprocess(_scene_frames(rng, n_scenes, 112),
                                    max_pixels=112 * 112)
    item = {"conversations": [
        {"from": "human", "value": "<video>\nWhat happens?"},
        {"from": "gpt", "value": "Four scenes, one after another."}]}
    max_len = 512
    ids, labels, (start, n_vis) = preprocess_qwen_sample(
        item, make_byte_qwen_tokenizer(), cfg, grid, max_len)
    pad = max_len - len(ids)
    seg = np.concatenate([np.zeros(len(ids), np.int32),
                          np.full(pad, -1, np.int32)])
    ids, labels = np.pad(ids, (0, pad)), np.pad(labels, (0, pad),
                                                constant_values=-100)
    draws = torch.full((grid[0],), 0.9)
    draws[::3] = torch.linspace(0.1, 0.2, n_scenes)  # one seed per scene
    return dict(cfg=cfg, params=params, lora=lora, patches=patches,
                grid=grid, ids=ids, labels=labels, seg=seg, start=start,
                n_vis=n_vis, draws=draws)


def lora_leaf_grads(case, device, dtype):
    """One LoRA loss + backward of `train_reference_case` on `device` with
    the base in `dtype`: (loss, {"<path>.<a|b>": gradient, f32 on the
    CPU})."""
    import torch
    from flash_vstream_tpu_torch.train.finetune_flash import sample_loss
    lp = {p: {k: v.to(device).requires_grad_() for k, v in ab.items()}
          for p, ab in case["lora"].items()}
    names = [f"{p}.{k}" for p, ab in sorted(lp.items()) for k in sorted(ab)]
    leaves = [lp[p][k] for p in sorted(lp) for k in sorted(lp[p])]
    t = lambda x: torch.from_numpy(x).to(device)
    loss = sample_loss(
        case["cfg"], _tree_to(case["params"], device, dtype), lp,
        t(case["patches"]), case["grid"], t(case["ids"]), t(case["labels"]),
        t(case["seg"]), case["start"], case["n_vis"],
        lambda n, d=case["draws"].to(device): d, alpha=16, rank=8,
        vit_chunk=4)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {n: g.float().cpu() for n, g in zip(names, grads)}


def leaf_errors(got, want):
    """{leaf: |got - want| / |want|} in L2 norm, one adapter leaf at a time,
    so a fault in one leaf cannot hide in the norm of all."""
    return {n: ((got[n] - w).norm() / w.norm().clamp_min(1e-30)).item()
            for n, w in want.items()}


def leaf_gains(got, want):
    """{leaf: |<got, want> / <want, want> - 1|}: the error along the
    reference, which a scaled gradient moves in full and rounding noise,
    nearly orthogonal to it, hardly at all."""
    return {n: abs(((got[n] * w).sum() / (w * w).sum().clamp_min(1e-60)
                    ).item() - 1) for n, w in want.items()}


def _train_reference_reading(case, dev, g_cpu, l_cpu, tag):
    """The card's bf16 LoRA step of `case` against the CPU's f32 one:
    {"sound": the loss within 1e-2 relative and every value finite,
    "rel L2": the worst leaf's, "gain": the worst leaf's}; prints the
    readings."""
    import numpy as np
    import torch
    _reset_launches()
    l_card, g_card = lora_leaf_grads(case, dev, torch.bfloat16)
    if not all(_launches()[k] for k in ("K1", "K3", "K4", "K5")):
        raise AssertionError(f"train_reference: the card's LoRA step "
                             f"launched {_launches()}")
    errs = leaf_errors(g_card, g_cpu)
    gains = leaf_gains(g_card, g_cpu)
    worst = max(errs, key=errs.get)
    steep = max(gains, key=gains.get)
    flat = [torch.cat([g[n].flatten() for n in sorted(g)])
            for g in (g_card, g_cpu)]
    vs_cpu = ((flat[0] - flat[1]).abs().max() / flat[1].abs().max()).item()
    print(f"train_reference{tag}: small model LoRA loss card {l_card:.5f} "
          f"CPU f32 {l_cpu:.5f}; adapter grads, card bf16 vs CPU f32 on the "
          f"bf16 weights, per leaf: rel L2 max {errs[worst]:.3e} ({worst}) "
          f"limit {TRAIN_REF_F32_LIMIT:.1e}, gain max {gains[steep]:.3e} "
          f"({steep}) limit {TRAIN_REF_GAIN_LIMIT:.0e}; all leaves max err / "
          f"max |grad| {vs_cpu:.3e}", flush=True)
    print(f"train_reference{tag}: per leaf (rel L2, gain) " + " ".join(
        f"{n}={e:.3e},{gains[n]:.3e}" for n, e in sorted(errs.items())),
        flush=True)
    sound = bool(np.isfinite(l_card)
                 and abs(l_card - l_cpu) <= 1e-2 * abs(l_cpu)
                 and all(torch.isfinite(g).all() for g in g_card.values()))
    return {"sound": sound, "rel L2": errs[worst], "gain": gains[steep]}


def check_train_reference(dev):
    """One LoRA loss + backward of the small model on the card (K1, K3, K4,
    K5) in bf16, against the CPU's (plain versions) in f32 on the same bf16
    weights upcast. The loss agrees within 1e-2 relative, and every adapter
    leaf's gradient within TRAIN_REF_F32_LIMIT in relative L2 norm (see
    there for why this limit) and its gain within TRAIN_REF_GAIN_LIMIT.
    Then each of TRAIN_REF_FAULTS in the card's attention backward must
    fail the limit named beside it."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa

    case = train_reference_case()
    l_cpu, g_cpu = lora_leaf_grads(case, torch.device("cpu"), torch.float32)
    limits = {"rel L2": TRAIN_REF_F32_LIMIT, "gain": TRAIN_REF_GAIN_LIMIT}
    r = _train_reference_reading(case, dev, g_cpu, l_cpu, "")
    if not (r["sound"] and all(r[k] <= v for k, v in limits.items())):
        raise AssertionError("train_reference: the card's loss or adapter "
                             "gradients are off")
    real = fa.flash_attention_bwd_cuda
    for name, (limit, fault) in TRAIN_REF_FAULTS.items():
        fa.flash_attention_bwd_cuda = (
            lambda *a, fault=fault, **kw: fault(*real(*a, **kw)))
        try:
            r = _train_reference_reading(case, dev, g_cpu, l_cpu,
                                         f" (planted {name})")
        finally:
            fa.flash_attention_bwd_cuda = real
        failed = r[limit] > limits[limit]
        print(f"train_reference: the planted {name} reads rel L2 "
              f"{r['rel L2']:.3e}, gain {r['gain']:.3e}; its {limit} limit "
              f"{limits[limit]:.1e}: "
              f"{'failed, as it must' if failed else 'passed (wrong)'}",
              flush=True)
        if not failed:
            raise AssertionError(f"train_reference: a planted {name} passed "
                                 f"its {limit} limit")


def _train_args(dev, out_dir, data_path, max_len, steps, grad_accum,
                profile_dir=None):
    from flash_vstream_tpu_torch.train.finetune_flash import make_parser
    argv = ["--device", str(dev), "--output-dir", out_dir,
            "--data-path", data_path, "--video-dir", os.path.dirname(data_path),
            "--max-steps", str(steps), "--grad-accum", str(grad_accum),
            "--max-frames", "240", "--max-len", str(max_len),
            "--save-steps", "1000"]
    if profile_dir:
        argv += ["--profile-dir", profile_dir, "--profile-steps", "1"]
    return make_parser().parse_args(argv)


DRY_RUN_ARGS = ("--dry-run", "--max-steps", "2", "--max-frames", "8",
                "--max-len", "128")
# The card dry run holds each adapter leaf's update after step 2 (adapter
# minus its init; only the b leaves move, a gets no gradient while b is 0)
# to this relative L2 error against the CPU run on the same bf16 base (plain
# versions), worst leaf. Adam's first steps normalize each element by its
# own gradient, so small gradients amplify rounding: on the CPU the bf16
# base against the f32 one reads 0.115-0.162 per leaf (why the card is held
# to the bf16 run), and dk scaled by 0.9 in the attention backward reads
# 0.245 in the worst leaf (tests/test_torch_train_reference.py reads both);
# the card against the CPU read 0.108 in the worst leaf on an H100.
DRY_RUN_LIMIT = 1.5e-1


def dry_run_case(work):
    """The card dry run's inputs, made on the CPU so that both runs start
    alike: the tiny config, its f32 base from a CPU generator seeded 0,
    adapters from one seeded 1 (the entry point's seeds) and the synthetic
    dataset of `--dry-run`."""
    import torch
    from flash_vstream_tpu_torch.core.config import tiny_qwen_config
    from flash_vstream_tpu_torch.models.vstream_qwen import init_qwen_params
    from flash_vstream_tpu_torch.train.finetune_flash import (
        build_synthetic_dataset, make_parser)
    from flash_vstream_tpu_torch.train.lora import (QWEN_TARGETS,
                                                    init_lora_params)
    rank = make_parser().parse_args(
        [*DRY_RUN_ARGS, "--output-dir", work]).lora_rank
    cfg = tiny_qwen_config()
    params = init_qwen_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = init_lora_params(torch.Generator().manual_seed(1), params,
                            rank=rank, targets=QWEN_TARGETS)
    data = build_synthetic_dataset(os.path.join(work, "synthetic"))
    return dict(cfg=cfg, params=params, lora=lora, data=data, work=work)


def dry_run_updates(case, device, dtype, tag):
    """`run_training` as `--dry-run` runs it (2 steps, 8 frames, max_len
    128) on `device` with the case's base in `dtype` and its f32 adapters:
    (losses, {"<path>.<a|b>": adapter after step 2 minus its init, f32 on
    the CPU})."""
    import torch
    from flash_vstream_tpu_torch.train.finetune_flash import (make_parser,
                                                              run_training)
    args = make_parser().parse_args([
        *DRY_RUN_ARGS, "--device", str(device), "--output-dir",
        os.path.join(case["work"], tag), "--data-path", case["data"][0],
        "--video-dir", case["data"][1]])
    lora = {p: {k: v.to(device).clone() for k, v in ab.items()}
            for p, ab in case["lora"].items()}
    res = run_training(args, cfg=case["cfg"],
                       params=_tree_to(case["params"], device, dtype),
                       lora=lora)
    return res["losses"], {
        f"{p}.{k}": res["lora"][p][k].float().cpu() - v.float()
        for p, ab in sorted(case["lora"].items()) for k, v in sorted(ab.items())}


def run_dry_run_train(dev, work):
    """C1: the trainer's `--dry-run` on the card. The entry point as a
    subprocess with no --device (exit 0, two finite losses in its scalars
    file); then `run_training` in this process on the dry run's own inputs
    made on the CPU, bf16 base on the card (K3, K4, K5 at the tiny head dims
    8 and 16, zero-padded to 64) against the same on the CPU (plain
    versions): losses within 1e-2, each adapter leaf's update within
    DRY_RUN_LIMIT. Returns the kernels' launches in the card run."""
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(work, "entry")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "flash_vstream_tpu_torch.train.finetune_flash",
         *DRY_RUN_ARGS, "--output-dir", out], cwd=root, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"finetune_flash --dry-run exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(os.path.join(out, "scalars.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    losses = [r["loss"] for r in recs if "loss" in r]
    print(f"dry_run_train: python -m flash_vstream_tpu_torch.train."
          f"finetune_flash {' '.join(DRY_RUN_ARGS)} on the card (no "
          f"--device): exit 0 in {time.perf_counter() - t0:.1f} s, losses "
          + " ".join(f"{x:.5f}" for x in losses), flush=True)
    if len(losses) != 2 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"dry_run_train: losses {losses}")

    case = dry_run_case(os.path.join(work, "case"))
    _reset_launches()
    l_card, d_card = dry_run_updates(case, dev, torch.bfloat16, "card")
    k = _launches()
    cpu = torch.device("cpu")
    l_cpu, d_cpu = dry_run_updates(case, cpu, torch.bfloat16, "cpu")
    _, d_f32 = dry_run_updates(case, cpu, torch.float32, "cpu_f32")
    errs = leaf_errors(d_card, d_cpu)
    moved = {n: e for n, e in errs.items() if d_cpu[n].norm() > 0}
    worst = max(moved, key=moved.get)
    f32 = leaf_errors(d_cpu, d_f32)
    print(f"dry_run_train: run_training --dry-run inputs, card bf16 vs CPU "
          f"bf16: losses {' '.join(f'{x:.5f}' for x in l_card)} vs "
          f"{' '.join(f'{x:.5f}' for x in l_cpu)}; adapter updates after "
          f"step 2, rel L2 per moved leaf: max {moved[worst]:.3e} ({worst}) "
          f"limit {DRY_RUN_LIMIT:.1e}; CPU bf16 vs f32 base max "
          f"{max(f32.values()):.3e}; launches K1={k['K1']} K3={k['K3']} "
          f"K4={k['K4']} K5={k['K5']} (head dims 8, 16 padded to 64)",
          flush=True)
    print("dry_run_train: per leaf " + " ".join(
        f"{n}={e:.3e}" for n, e in sorted(moved.items())), flush=True)
    if not (k["K3"] and k["K4"] and k["K5"]):
        raise AssertionError(f"dry_run_train: launches {k}")
    if (not all(map(math.isfinite, l_card))
            or max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu)) > 1e-2):
        raise AssertionError(f"dry_run_train: losses {l_card} vs {l_cpu}")
    if len(moved) == 0 or moved[worst] > DRY_RUN_LIMIT:
        raise AssertionError(f"dry_run_train: adapter update {worst} "
                             f"{moved.get(worst)} > {DRY_RUN_LIMIT}")
    return k


TPAR_B, TPAR_S = 2, 1024   # the pp and sp checks: 2 sequences of 1,024 ids
TPAR_RANK = 16             # their adapters' rank (b != 0: a has a gradient)
TPAR_H_TOL = 5e-2          # hidden states against one rank's, of max |h|
TPAR_FRAMES = 16           # the dp run's videos: 8 frame pairs of 224 px
TPAR_LEN = 1024            # its max_len (640 visual tokens)
TPAR_STEPS = 2             # its steps (the first at lr 0)
TPAR_DP_LAYERS = 2         # its decoder depth: ZeRO-3 gathers every layer
                           # through host memory on a shared card
TPAR_ARGS = ("--dry-run", "--max-steps", "2", "--max-frames", "8",
             "--max-len", "128", "--grad-accum", "1")
# the tp run: LLaVA stage 2 (the llava_train phase's feature branch at S
# 937) with Vicuna-7B cut to TPAR_TP_LAYERS decoder layers and CLIP
# ViT-L/14 to TPAR_TP_VIT_LAYERS, tp 2 against one rank at the global batch
TPAR_TP_LAYERS = 4
TPAR_TP_VIT_LAYERS = 2
TPAR_TP_BATCH = 2          # a dp row's micro-batch (the feature branch)
TPAR_TP_LR = 1e-3          # updates of ~16 bf16 ulps of a 7B weight
TPAR_CLIP_FRAMES = 8       # the raw-frame micro-batch through CLIP, 224 px
TPAR_SAMPLE = 61           # a leaf over 2**20 elements: every 61st compared
# printed, not held: the NTM's key bias shifts every score of a query alike,
# which the softmax ignores, so its exact gradient is 0 and both runs read
# rounding (1.4e-12 against 2.6 for embed in f32), which Adam then scales
# to a full-size update
TPAR_ZERO_GRAD = ("ntm/.bk",)


def _tpar_dp_args(out, data_path, batch, *extra):
    """The dp run's run_training arguments: the Qwen LoRA loss over
    TPAR_FRAMES-frame videos at TPAR_LEN, `batch` samples a rank."""
    from flash_vstream_tpu_torch.train.finetune_flash import make_parser
    return make_parser().parse_args([
        "--device", "cuda", "--output-dir", out, "--data-path", data_path,
        "--video-dir", os.path.dirname(data_path), "--max-steps",
        str(TPAR_STEPS), "--grad-accum", "1", "--batch-size", str(batch),
        "--max-frames", str(TPAR_FRAMES), "--frame-bucket", str(TPAR_FRAMES),
        "--max-len", str(TPAR_LEN), "--save-steps", "1000", *extra])


def _tpar_capture(store):
    """Wrap Trainer._reduce so the first step's reduced gradients land in
    `store` whole (a ZeRO shard all-gathered: every rank calls this in the
    trainer's path order); returns the undo."""
    from flash_vstream_tpu_torch.train import trainer as tr
    real = tr.Trainer._reduce

    def reduce(self, p, g):
        g = real(self, p, g)
        if p not in store and len(store) < len(self._leaf):
            w = g
            if p in self.sharded:
                w = self.mesh.dp.all_gather(g, self.zero_dim[p])
            store[p] = w.detach().float().cpu()
        return g

    tr.Trainer._reduce = reduce
    return lambda: setattr(tr.Trainer, "_reduce", real)


def _tpar_dp(cfg, params):
    """The dp run's model: the phase's weights with the decoder's first
    TPAR_DP_LAYERS layers (views)."""
    import dataclasses
    from flash_vstream_tpu_torch.models.layers import layer_slice
    return (cfg.replace(llm=dataclasses.replace(
        cfg.llm, num_layers=TPAR_DP_LAYERS)),
        dict(params, llm=dict(params["llm"], layers=layer_slice(
            params["llm"]["layers"], slice(0, TPAR_DP_LAYERS)))))


def _tpar_params(dev):
    """The phase's weights: VStreamQwenConfig() at QWEN_LAYERS decoder
    layers, bf16 from the seed (every rank and the reference alike)."""
    import torch
    from flash_vstream_tpu_torch.models.vstream_qwen import init_qwen_params
    cfg = _qwen_config()
    return cfg, init_qwen_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev, dtype=torch.bfloat16)


def _tpar_case(llm, cfg, dev):
    """The pp and sp checks' f32 adapters of rank TPAR_RANK over every
    decoder projection (b != 0, so a has a gradient), ids, labels (with
    ignored spans: the shards' valid counts differ) and positions, from the
    seed."""
    import torch
    from flash_vstream_tpu_torch.train.lora import init_lora_params
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    lora = init_lora_params(g, llm, rank=TPAR_RANK)
    for ab in lora.values():         # x a b small beside x W at 7B width
        ab["b"] = torch.randn(ab["b"].shape, generator=g, device=dev) * 1e-3
    V = cfg.llm.vocab_size
    ids = torch.randint(0, V, (TPAR_B, TPAR_S), generator=g, device=dev)
    labels = ids.clone()
    labels[0, :300] = -100
    labels[1, 700:800] = -100
    pos = torch.arange(TPAR_S, device=dev)[None, None].expand(
        3, TPAR_B, TPAR_S)
    return lora, ids, labels, pos


def _tpar_views(llm, lora, fnorm, lo=0, hi=None):
    """The decoder tree the checks differentiate: bf16 views of the f32
    adapters' layers [lo, hi) over `llm` (its layers already cut to them
    when hi is given), final_norm the leaf `fnorm`."""
    import torch
    from flash_vstream_tpu_torch.train.lora import lora_views
    lp = {p: {k: (v if hi is None else v[lo:hi]).to(torch.bfloat16)
              for k, v in ab.items()} for p, ab in lora.items()}
    eff = lora_views(llm, lp, alpha=TPAR_RANK, rank=TPAR_RANK)
    eff["final_norm"] = fnorm
    return eff


def _tpar_grads(lora, fnorm):
    """{leaf: its gradient, f32} of the adapters and final_norm (zeros
    where this rank's run reached none: final_norm off the last stage);
    resets them."""
    import torch
    leaves = {f"{p}.{k}": v for p, ab in sorted(lora.items())
              for k, v in sorted(ab.items())}
    leaves["final_norm"] = fnorm
    out = {}
    for n, v in leaves.items():
        out[n] = (v.grad if v.grad is not None
                  else torch.zeros_like(v)).float().clone()
        v.grad = None
    return out


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _tpar_llava(dev):
    """The tp run's model: VStreamLLaVAConfig() with the decoder and the
    tower cut, bf16 from the seed (every rank and the reference alike)."""
    import dataclasses
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamLLaVAConfig
    from flash_vstream_tpu_torch.models.vstream_llava import init_llava_params
    full = VStreamLLaVAConfig()
    cfg = full.replace(
        llm=dataclasses.replace(full.llm, num_layers=TPAR_TP_LAYERS),
        vit=dataclasses.replace(full.vit, num_layers=TPAR_TP_VIT_LAYERS))
    return cfg, init_llava_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 7), dev, dtype=torch.bfloat16)


def _tpar_tp_args(work, out, batch, *extra):
    """The tp run's train.run_training arguments: the finetune stage over
    the phase's feature items, `batch` samples a dp row."""
    data = os.path.join(work, "llava")
    return _lt_args("cuda", os.path.join(work, out), "--stage", "finetune",
                    "--batch-size", str(batch), "--max-steps",
                    str(TPAR_STEPS), "--save-steps", "0", "--learning-rate",
                    str(TPAR_TP_LR), "--data-path",
                    os.path.join(data, "train.json"), "--feature-dir",
                    os.path.join(data, "feats"), *extra)


def _tpar_sample(x):
    """What the tp check compares of a tensor: its elements, every
    TPAR_SAMPLE-th of them past 2**20 (an f32 copy on the host)."""
    import torch
    x = x.detach().flatten()
    x = x if x.numel() <= 1 << 20 else x[::TPAR_SAMPLE]
    return x.to("cpu", torch.float32, copy=True)


def _tpar_trained(tree):
    """{path: tensor} of the stage's trained leaves (all but the tower)."""
    import torch
    from flash_vstream_tpu_torch.train.lora import tree_leaves_with_path
    return {p: x for p, x in tree_leaves_with_path(tree)
            if isinstance(x, torch.Tensor) and not p.startswith("vit")}


def _tpar_tp_capture(store, parts=1):
    """Wrap Trainer._reduce so that the first step's reduced gradients
    land in `store` sampled: a tp rank's its part of each split leaf
    ({path: (rank, sample)}); with `parts` n, a run at tp 1 each leaf that
    tp n splits cut as the ranks hold it ({path: [sample a part]}). Every
    rank calls it in the trainer's path order; returns the undo."""
    import types
    from flash_vstream_tpu_torch.parallel.tensor import tp_spec
    from flash_vstream_tpu_torch.train import trainer as tr
    real = tr.Trainer._reduce
    mesh_n = types.SimpleNamespace(axis_names=("dp", "tp"))

    def reduce(self, p, g):
        g = real(self, p, g)
        if p not in store and len(store) < len(self._leaf):
            w = g
            if p in self.sharded:
                w = self.mesh.dp.all_gather(g, self.zero_dim[p])
            d = tp_spec(p, w.shape, mesh_n) if parts > 1 else None
            if self.mesh.tp.size > 1:
                store[p] = (self.mesh.tp.rank, _tpar_sample(w))
            elif d is None:
                store[p] = [_tpar_sample(w)]
            else:
                store[p] = [_tpar_sample(c) for c in w.chunk(parts, d)]
        return g

    tr.Trainer._reduce = reduce
    return lambda: setattr(tr.Trainer, "_reduce", real)


def _tpar_tp_rank(work, info, card):
    """The tp run on this rank (the world a dp x tp 2 grid): run_training
    of the LLaVA finetune stage over the phase's features at tp 2, then a
    raw-frame micro-batch through the split CLIP tower against the whole
    one, and the planted fault (rank 1's row products not summed). Returns
    its readings."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    from flash_vstream_tpu_torch.models import layers
    from flash_vstream_tpu_torch.models.clip_vit import clip_encode
    from flash_vstream_tpu_torch.preprocess.image import clip_device_preprocess
    from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
    from flash_vstream_tpu_torch.train import train as lt
    from flash_vstream_tpu_torch.train.lora import tree_leaves_with_path
    from flash_vstream_tpu_torch.train.trainer import Trainer, _micro, _tensor
    dev = info.device
    cfg, params = _tpar_llava(dev)
    whole = {p: _nbytes(x) for p, x in tree_leaves_with_path(params)
             if isinstance(x, torch.Tensor)}
    before = {p: _tpar_sample(x) for p, x in _tpar_trained(params).items()}
    grads, seen, heads = {}, {}, {}
    real_f, real_b = fa._launch_fwd, fa._launch_bwd
    real_compile, real_run = Trainer.compile_step, Trainer.run_step

    def launch_fwd(q, k, v, lse, *a, **kw):
        heads.setdefault("K1" if lse is None else "K3", set()).add(q.shape[1])
        return real_f(q, k, v, lse, *a, **kw)

    def launch_bwd(kernel, q, *a, **kw):
        heads.setdefault("K4" if kernel == "dq" else "K5", set()).add(
            q.shape[1])
        return real_b(kernel, q, *a, **kw)

    def compile_step(self, loss_fn):
        seen.setdefault("loss_fn", loss_fn)
        return real_compile(self, loss_fn)

    def run_step(self, batch, key, step_fn=None):
        seen.setdefault("batch", batch)
        return real_run(self, batch, key, step_fn)

    def on_step(step, trainer, rec):
        seen.setdefault("steps", []).append(rec["step_time_s"])
        seen["trainer"] = trainer

    undo = _tpar_tp_capture(grads)
    fa._launch_fwd, fa._launch_bwd = launch_fwd, launch_bwd
    Trainer.compile_step, Trainer.run_step = compile_step, run_step
    _release(dev)
    _reset_launches()
    t1 = time.perf_counter()
    try:
        res = lt.run_training(_tpar_tp_args(work, "tp", TPAR_TP_BATCH, "--tp",
                                            "2", *card),
                              cfg=cfg, params=params,
                              tokenizer=ByteTokenizer(), on_step=on_step)
        torch.cuda.synchronize(dev)
        out = dict(tp_s=time.perf_counter() - t1, tp_launches=_launches(),
                   tp_steps=seen["steps"], tp_losses=res["losses"],
                   tp_peak=torch.cuda.max_memory_allocated(dev),
                   tp_heads={k: sorted(v) for k, v in heads.items()})
        tr = seen["trainer"]
        held = {p: _nbytes(_tensor(x)) for p, x in
                tree_leaves_with_path(tr.params) if p in whole}
        split = [p for p in held if tr.tp_dim.get(p) is not None]
        out["tp_bytes"] = dict(
            held=sum(held.values()), whole=sum(whole.values()),
            split=sum(held[p] for p in split) / sum(whole[p] for p in split),
            embed=held["llm/embed"] / whole["llm/embed"],
            lm_head=held["llm/lm_head"] / whole["llm/lm_head"],
            n_split=len(split))
        # planted fault: rank 1's row products enter the all-reduce (the
        # ranks keep one sequence of collectives) but it keeps its own term
        micro = _micro(seen["batch"], 0)
        with torch.no_grad():
            good = float(seen["loss_fn"](tr.params, micro, (0, 0)))
            real_reduce = layers.reduce_from
            if tr.mesh.tp.rank == 1:
                layers.reduce_from = (
                    lambda x, g: (g.all_reduce(x.clone()), x)[1])
            try:
                bad = float(seen["loss_fn"](tr.params, micro, (0, 0)))
            finally:
                layers.reduce_from = real_reduce
        out["tp_fault"] = abs(bad - good) / abs(good)
        # a raw-frame micro-batch through the split tower and the whole one
        rng = np.random.default_rng(SEED + 8)
        u8 = torch.from_numpy(np.stack(_offline_frames(
            rng, TPAR_CLIP_FRAMES, cfg.vit.image_size))).to(dev)
        images = clip_device_preprocess(u8)
        _reset_launches()
        heads.clear()
        with torch.no_grad():
            f_tp = clip_encode(tr.params["vit"], cfg.vit, images)
            out["clip_launches"] = _launches()
            out["clip_heads"] = sorted(heads.get("K1", ()))
            f_whole = clip_encode(params["vit"], cfg.vit, images)
        out["clip_err"] = float((f_tp - f_whole).abs().max()
                                / f_whole.abs().max())
    finally:
        undo()
        fa._launch_fwd, fa._launch_bwd = real_f, real_b
        Trainer.compile_step, Trainer.run_step = real_compile, real_run
    out["tp_grads"] = grads
    if info.rank == 0:
        out["tp_updates"] = {
            p: _tpar_sample(x) - before[p]
            for p, x in _tpar_trained(res["params"]).items()}
    del res, tr, params, seen
    _release(dev)
    return out


TPAR_QL_LAYERS = 2         # the tp LoRA/QLoRA runs: the 7B decoder cut
TPAR_QL_S = 1024           # ids a dp row
TPAR_QL_RANK, TPAR_QL_ALPHA = 64, 32.0   # finetune_flash's adapters
TPAR_QL_BASES = ("bf16", "int8", "int4")
TPAR_CE_TOL = 1e-4         # the split chunked loss against the gathered


def _tpar_ql_case(dev, base):
    """The tp LoRA/QLoRA runs' model: the slice config's decoder at full
    width cut to TPAR_QL_LAYERS, bf16 from the seed, its projections and
    lm_head quantized for `base` int8/int4 (`--int8-base`'s targets); the
    adapters as finetune_flash builds them (b made nonzero, so a has a
    gradient at step 1); the global batch's ids and labels (an ignored
    span)."""
    import dataclasses
    import torch
    from flash_vstream_tpu_torch.models.llm import init_llm_params
    from flash_vstream_tpu_torch.train.lora import (QWEN_TARGETS,
                                                    init_lora_params)
    from flash_vstream_tpu_torch.weights.quantize import (quantize_params,
                                                          quantize_params4)
    cfg = dataclasses.replace(_qwen_config().llm, num_layers=TPAR_QL_LAYERS)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    llm = init_llm_params(cfg, g, dev, dtype=torch.bfloat16)
    lora = init_lora_params(g, llm, rank=TPAR_QL_RANK, targets=QWEN_TARGETS)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=g, device=dev) * 1e-3
    if base != "bf16":
        llm = (quantize_params if base == "int8" else quantize_params4)(llm)
    return cfg, llm, lora, g


def _tpar_ql_batch(cfg, g, dev, dp):
    """[accum 1, dp rows, S] ids and labels from the seed."""
    import torch
    ids = torch.randint(0, cfg.vocab_size, (1, dp, TPAR_QL_S), generator=g,
                        device=dev)
    labels = ids.clone()
    labels[..., :100] = -100
    return {"ids": ids, "labels": labels}


def _tpar_ql_loss(cfg):
    """The LoRA step's loss: bf16 views of the f32 adapters over the
    frozen base, the decoder with remat, the chunked cross entropy (over
    a split lm_head vocab-parallel; over a whole quantized one tiled)."""
    import torch
    from flash_vstream_tpu_torch.models.llm import (cross_entropy_loss_chunked,
                                                    decoder_forward,
                                                    embed_tokens)
    from flash_vstream_tpu_torch.train.lora import lora_views

    def loss(lp, batch, key, base):
        lp = {p: {k: v.to(torch.bfloat16) for k, v in ab.items()}
              for p, ab in lp.items()}
        eff = lora_views(base, lp, alpha=TPAR_QL_ALPHA, rank=TPAR_QL_RANK)
        ids = batch["ids"]
        pos = torch.arange(ids.shape[1], device=ids.device)[None].expand(
            ids.shape)
        h = decoder_forward(eff, cfg, embed_tokens(eff, ids), pos,
                            remat=True)
        return cross_entropy_loss_chunked(eff, cfg, h, batch["labels"],
                                          chunk=512)
    return loss


def _tpar_ql_run(cfg, llm, lora, batch, mesh):
    """Two Trainer steps of the LoRA loss (lr 1e-3, no warm-up) on `mesh`
    (None: this process alone): (losses, the first step's reduced
    gradient of every adapter leaf, whole and f32 on the host, the
    trainer)."""
    from flash_vstream_tpu_torch.train.trainer import TrainConfig, Trainer
    tr = Trainer(_tpar_ql_loss(cfg), lora, TrainConfig(
        learning_rate=1e-3, total_steps=TPAR_STEPS, warmup_ratio=0.0),
        frozen=llm, mesh=mesh)
    grads = {}
    real = tr._reduce

    def reduce(p, g):
        g = real(p, g)
        if p not in grads:           # a ZeRO shard gathered over dp
            w = (tr.mesh.dp.all_gather(g, tr.zero_dim[p])
                 if p in tr.sharded else g)
            grads[p] = w.detach().float().cpu().clone()
        return g
    tr._reduce = reduce
    losses = [tr.run_step(batch, s) for s in range(TPAR_STEPS)]
    return losses, grads, tr


def _tpar_qlora_rank(info):
    """The tp LoRA/QLoRA runs on this rank (dp = world / 2 x tp 2): for
    each of TPAR_QL_BASES, TPAR_STEPS Trainer steps of the rank-64
    adapters over the base laid out as JAX's rules leave it (bf16
    projections and lm_head split, quantized ones whole, the adapters
    whole), each dp row its rows; rank 0 also runs the same steps alone
    over the global batch. Then the chunked cross entropy over the
    bf16 base's vocab-split lm_head against the same loss over the lm_head
    gathered whole, on one hidden state. Returns the readings."""
    import torch
    from flash_vstream_tpu_torch.models.llm import cross_entropy_loss_chunked
    from flash_vstream_tpu_torch.parallel.sharding import create_rank_mesh
    from flash_vstream_tpu_torch.parallel.tensor import TPShard, tp_shard_tree
    from flash_vstream_tpu_torch.train.lora import tree_leaves_with_path
    dev = info.device
    mesh = create_rank_mesh(tp=2, info=info)
    dp, d = mesh.dp.size, mesh.dp.rank
    out = {"ql": {}}
    _reset_launches()
    t0 = time.perf_counter()
    for base in TPAR_QL_BASES:
        cfg, llm, lora, g = _tpar_ql_case(dev, base)
        batch = _tpar_ql_batch(cfg, g, dev, dp)
        whole = sum(_nbytes(*x) if isinstance(x, tuple) else _nbytes(x)
                    for _, x in tree_leaves_with_path(llm))
        t1 = time.perf_counter()
        losses, grads, tr = _tpar_ql_run(
            cfg, llm, {p: {k: v.clone() for k, v in ab.items()}
                       for p, ab in lora.items()},
            {k: v[:, d:d + 1] for k, v in batch.items()}, mesh)
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t1
        held = {"split": 0, "quantized": 0, "whole": 0}
        for _, x in tree_leaves_with_path(tr.frozen):
            if isinstance(x, TPShard):
                held["split"] += _nbytes(x.local())
            elif isinstance(x, tuple):
                held["quantized"] += _nbytes(*x)
            else:
                held["whole"] += _nbytes(x)
        rec = dict(losses=losses, grads=grads, s=run_s, bytes=held,
                   bytes_whole=whole,
                   n_split=sum(isinstance(x, TPShard) for _, x in
                               tree_leaves_with_path(tr.frozen)))
        del tr
        if info.rank == 0:               # one rank over the global batch
            rec["ref_losses"], rec["ref_grads"], tr = _tpar_ql_run(
                cfg, llm, lora, batch, None)
            del tr
        out["ql"][base] = rec
        if base == "bf16":
            tree = tp_shard_tree(llm, mesh)
            assert isinstance(tree["lm_head"], TPShard)
            h = (torch.randn((1, TPAR_QL_S, cfg.hidden_size), generator=g,
                             device=dev) * 2).to(torch.bfloat16)
            lab = batch["labels"][0, :1]
            got = []
            for t in (tree, llm):
                hh = h.clone().requires_grad_()
                loss = cross_entropy_loss_chunked(t, cfg, hh, lab, chunk=512)
                loss.backward()
                got.append((loss.item(), hh.grad.float()))
            out["ce"] = dict(split=got[0][0], whole=got[1][0],
                             dh=_rel(got[0][1], got[1][1]))
        del llm, lora
        _release(dev)
    out["ql_s"] = time.perf_counter() - t0
    out["qlora_launches"] = _launches()
    return out


def check_tpar_qlora(smi, ranks, n_ranks):
    """The tp LoRA/QLoRA runs of the ranks against rank 0's run alone at
    the global batch: per base the losses within 1e-2 relative and each
    adapter leaf's first-step gradient within TRAIN_REF_LIMIT relative L2,
    equal bit for bit on the two ranks of a tp group; the quantized base
    whole on both ranks (bytes), the bf16 one about half; the chunked loss
    over the vocab-split lm_head within TPAR_CE_TOL of the gathered
    head's, the hidden state's gradient within 1e-2 relative L2."""
    import torch
    r0, r1 = ranks[0], ranks[1]
    bad = []
    for base in TPAR_QL_BASES:
        a, b = r0["ql"][base], r1["ql"][base]
        l_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                        a["ref_losses"]))
        g_err = {p: _rel(g, a["ref_grads"][p]) for p, g in a["grads"].items()}
        worst = max(g_err, key=g_err.get)
        same = all(torch.equal(a["grads"][p], b["grads"][p])
                   for p in a["grads"])
        held = [x["ql"][base]["bytes"] for x in (r0, r1)]
        share = [(h["split"] + h["quantized"] + h["whole"]) / a["bytes_whole"]
                 for h in held]
        print(f"train_parallel qlora {base} tp 2 x dp {n_ranks // 2} "
              f"[{r0['backend']} on {smi}]: the slice decoder at full width "
              f"cut to {TPAR_QL_LAYERS} layers, rank-{TPAR_QL_RANK} adapters, "
              f"S {TPAR_QL_S} a dp row (the first 100 ignored), {TPAR_STEPS} steps in {a['s']:.2f} s; "
              f"losses " + " ".join(f"{x:.5f}/{y:.5f}" for x, y in
                                    zip(a["losses"], a["ref_losses"]))
              + f" (one rank; worst rel {l_err:.2e}); step 1 adapter "
              f"gradients worst rel L2 {g_err[worst]:.3e} ({worst}) over "
              f"{len(g_err)} leaves, limit {TRAIN_REF_LIMIT:.0e}; equal bit "
              f"for bit on both tp ranks {same}; resting bytes a rank "
              + " / ".join(f"{(h['split'] + h['quantized'] + h['whole']) / 1e9:.3f}"
                           for h in held)
              + f" GB of {a['bytes_whole'] / 1e9:.3f} GB whole ("
              + " / ".join(f"{x:.3f}" for x in share)
              + f"): split {held[0]['split'] / 1e9:.3f}, quantized (whole "
              f"on each rank) {held[0]['quantized'] / 1e9:.3f} / "
              f"{held[1]['quantized'] / 1e9:.3f}, other whole "
              f"{held[0]['whole'] / 1e9:.3f} GB; {a['n_split']} split leaves",
              flush=True)
        quant_whole = (held[0]["quantized"] == held[1]["quantized"] > 0
                       if base != "bf16" else held[0]["quantized"] == 0)
        if (l_err > 1e-2 or g_err[worst] > TRAIN_REF_LIMIT or not same
                or not quant_whole or len(g_err) != 14):
            bad.append(base)
    ce = r0["ce"]
    ce_err = abs(ce["split"] - ce["whole"]) / abs(ce["whole"])
    print(f"train_parallel qlora: the chunked cross entropy over the "
          f"vocab-split lm_head ({_qwen_config().llm.vocab_size} / 2 columns a "
          f"rank, chunks of 512) {ce['split']:.6f} against the gathered "
          f"head's {ce['whole']:.6f} (rel {ce_err:.2e}, limit "
          f"{TPAR_CE_TOL:.0e}), the hidden state's gradient rel L2 "
          f"{ce['dh']:.2e} (limit 1e-2); the runs "
          f"{r0['ql_s']:.1f} s a rank", flush=True)
    if bad or ce_err > TPAR_CE_TOL or ce["dh"] > 1e-2:
        raise AssertionError(f"train_parallel qlora: {bad or 'chunked loss'}")


def _tpar_rank(work, data_path, shared):
    """One rank of the phase: the pp and sp checks on the decoder (pp or sp
    2, dp the rest of the world, each dp rank its rows) against this rank's
    own plain run of the whole batch, then the dp run of run_training at
    ZeRO-3 with --offload-moments, then the entry point's main. `shared`
    "1": every rank on the one card over gloo; "0": a card a rank over
    NCCL. Writes its readings to <work>/rank<r>.pt."""
    import torch
    import flash_vstream_tpu_torch.parallel.sequence as seq
    from flash_vstream_tpu_torch.models.llm import (decoder_forward,
                                                    embed_tokens,
                                                    nll_sum_chunked)
    from flash_vstream_tpu_torch.parallel.collectives import (
        init_distributed, token_mean)
    from flash_vstream_tpu_torch.parallel.pipeline import (
        last_stage_loss, pipeline_decoder_forward, stage_params)
    from flash_vstream_tpu_torch.parallel.sharding import (ZeroShard,
                                                           create_rank_mesh)
    from flash_vstream_tpu_torch.preprocess.video import register_video_decoder
    from flash_vstream_tpu_torch.train.finetune_flash import run_training
    from flash_vstream_tpu_torch.train.lora import (QWEN_TARGETS,
                                                    init_lora_params,
                                                    tree_leaves_with_path)
    torch.backends.cuda.matmul.allow_tf32 = False
    register_video_decoder("synth", _decode_synth)
    shared = shared == "1"
    info = init_distributed("cuda", shared_card=shared)
    dev = info.device
    card = ["--shared-card"] if shared else []
    t0 = time.perf_counter()
    cfg, params = _tpar_params(dev)
    llm, L = params["llm"], cfg.llm
    lora, ids, labels, pos = _tpar_case(llm, cfg, dev)
    fnorm = llm["final_norm"].detach().clone()
    for v in [fnorm] + [v for ab in lora.values() for v in ab.values()]:
        v.requires_grad_(True)
    with torch.no_grad():
        embeds = embed_tokens(llm, ids)
    out = dict(rank=info.rank, backend=info.backend)

    def ce(eff, h, lab, group):
        return token_mean(*nll_sum_chunked(eff, L, h[:, :-1], lab[:, 1:],
                                           512), group)

    # one rank's plain decoder: the reference (not counted)
    from flash_vstream_tpu_torch.parallel.collectives import single_group
    eff = _tpar_views(llm, lora, fnorm)
    h_ref = decoder_forward(eff, L, embeds, pos, remat=True)
    ce(eff, h_ref, labels, single_group()).backward()
    g_ref = _tpar_grads(lora, fnorm)
    h_ref = h_ref.detach()
    scale = float(h_ref.abs().max())
    out["ref_s"], out["h_max"] = time.perf_counter() - t0, scale

    # sp 2: a ring of two ranks, each its 512 tokens of its dp rows
    mesh = create_rank_mesh(sp=2, info=info)
    r, Sl = mesh.inner.rank, TPAR_S // 2
    Bl = TPAR_B // mesh.dp.size
    rows = slice(mesh.dp.rank * Bl, (mesh.dp.rank + 1) * Bl)
    _reset_launches()
    t1 = time.perf_counter()
    eff = _tpar_views(llm, lora, fnorm)
    h = seq.sp_decoder_forward(eff, L, embeds[rows], pos[:, rows], mesh=mesh,
                               remat=True)
    token_mean(*seq.sp_nll(eff, L, h, labels[rows], mesh, 512),
               mesh.dp).backward()
    torch.cuda.synchronize(dev)
    out["sp_s"] = time.perf_counter() - t1
    out["sp_launches"] = _launches()
    g = {n: mesh.dp.all_reduce(mesh.inner.all_reduce(x), "mean")
         for n, x in _tpar_grads(lora, fnorm).items()}
    out["sp_h"] = float((h.detach() - h_ref[rows, r * Sl:(r + 1) * Sl])
                        .abs().max()) / scale
    out["sp_g"] = {n: _rel(g[n], g_ref[n]) for n in g_ref}
    real_shift = seq.ring_shift            # planted fault: a ring step
    seq.ring_shift = lambda group, *t, offset=1: t if len(t) > 1 else t[0]
    try:                                   # that moves nothing
        with torch.no_grad():
            h = seq.sp_decoder_forward(_tpar_views(llm, lora, fnorm), L,
                                       embeds[rows], pos[:, rows], mesh=mesh)
    finally:
        seq.ring_shift = real_shift
    out["sp_fault_h"] = float((h - h_ref[rows, r * Sl:(r + 1) * Sl]).abs()
                              .max()) / scale
    del h, eff

    # pp 2: stage r holds layers [6 r, 6 r + 6) of its own copy; a
    # micro-batch a row of its dp rows
    mesh = create_rank_mesh(pp=2, info=info)
    Bl = TPAR_B // mesh.dp.size
    rows = slice(mesh.dp.rank * Bl, (mesh.dp.rank + 1) * Bl)
    per = L.num_layers // 2
    lo, hi = mesh.inner.rank * per, (mesh.inner.rank + 1) * per
    stage = stage_params(llm, L, mesh)
    out["bytes_whole"] = _tree_nbytes(llm)
    out["bytes_stage"] = _tree_nbytes(stage["layers"]) + sum(
        _nbytes(v) for k, v in llm.items() if k != "layers")
    _reset_launches()
    t1 = time.perf_counter()
    eff = _tpar_views(stage, lora, fnorm, lo, hi)
    r = mesh.inner.rank
    h = pipeline_decoder_forward(eff, L, embeds[rows] if r == 0 else None,
                                 pos[:, rows], mesh=mesh, n_micro=Bl,
                                 remat=True)
    last_stage_loss(h, mesh, lambda x: ce(eff, x, labels[rows],
                                          mesh.dp)).backward()
    torch.cuda.synchronize(dev)
    out["pp_s"] = time.perf_counter() - t1
    out["pp_launches"] = _launches()
    g = {n: mesh.dp.all_reduce(mesh.inner.all_reduce(x), "mean")
         for n, x in _tpar_grads(lora, fnorm).items()}
    out["pp_h"] = (float((h.detach() - h_ref[rows]).abs().max()) / scale
                   if r == 1 else None)
    out["pp_g"] = {n: _rel(g[n], g_ref[n]) for n in g_ref}
    # planted fault: the replicated leaf summed over pp once too often
    out["pp_fault_g"] = _rel(mesh.inner.all_reduce(g["final_norm"].clone()),
                             g_ref["final_norm"])
    out["dp"] = mesh.dp.size
    del h, eff, stage, g, g_ref, h_ref, lora, embeds
    _release(dev)

    # dp over every rank: run_training at ZeRO-3, the moments offloaded
    cfg, params = _tpar_dp(cfg, params)
    base_bytes = _tree_nbytes(params)
    qlora = init_lora_params(torch.Generator(device=dev).manual_seed(
        SEED + 1), params, rank=64, targets=QWEN_TARGETS)
    grads, seen = {}, {}
    undo = _tpar_capture(grads)

    def on_step(step, trainer, rec):
        seen.setdefault("steps", []).append(rec["step_time_s"])
        if "base" not in seen:
            seen["base"] = sum(
                _nbytes(x.shard) if isinstance(x, ZeroShard) else
                _nbytes(x) for _, x in tree_leaves_with_path(trainer.frozen)
                if isinstance(x, (ZeroShard, torch.Tensor)))
            seen["pinned"] = all(m.is_pinned() for m in
                                 trainer.opt_state["mu"].values())
            seen["stage3"] = trainer.stage3

    _reset_launches()
    t1 = time.perf_counter()
    try:
        res = run_training(_tpar_dp_args(
            os.path.join(work, "dp"), data_path, 1, "--zero-stage", "3",
            "--offload-moments", *card), cfg=cfg, params=params,
            lora=qlora, on_step=on_step)
    finally:
        undo()
    torch.cuda.synchronize(dev)
    out["dp_s"] = time.perf_counter() - t1
    out["dp_launches"] = _launches()
    out.update(dp_losses=res["losses"], dp_base=seen["base"],
               dp_steps=seen["steps"],
               base_bytes=base_bytes, pinned=seen["pinned"],
               stage3=seen["stage3"],
               peak=torch.cuda.max_memory_allocated(dev))
    if info.rank == 0:
        out["dp_grads"] = grads
        out["dp_lora"] = {f"{p}.{k}": v.float().cpu()
                          for p, ab in res["lora"].items()
                          for k, v in ab.items()}
    del res, qlora, params, llm
    _release(dev)

    # the entry point's main on these ranks (torch.distributed.run started
    # them), as `-m ...finetune_flash` runs it
    from flash_vstream_tpu_torch.train import finetune_flash
    _reset_launches()
    for flag in ("--pp", "--sp"):
        t1 = time.perf_counter()
        finetune_flash.main([*TPAR_ARGS, "--output-dir",
                             os.path.join(work, f"entry{flag}"), flag, "2",
                             *card])
        out[f"entry{flag}_s"] = time.perf_counter() - t1
    out["entry_launches"] = _launches()
    out.update(_tpar_tp_rank(work, info, card))
    out.update(_tpar_qlora_rank(info))
    torch.save(out, os.path.join(work, f"rank{info.rank}.pt"))


def check_tpar_tp(dev, smi, work, ranks, n_ranks):
    """The tp run of the ranks (dp = n_ranks / 2 x tp 2) against one rank
    at the global batch in this process: the losses within 1e-2 relative on
    every rank, each trained leaf's first-step gradient (the ranks' parts
    together: gathered over tp) within TRAIN_REF_LIMIT relative L2, the
    updates after TPAR_STEPS steps within DRY_RUN_LIMIT, CLIP's split
    features within TPAR_H_TOL of max; each rank holds about half of each
    split leaf and all of embed and lm_head; rank 1's row products left
    unsummed (the planted fault) must move the loss past 1e-2."""
    import torch
    from flash_vstream_tpu_torch.models.vstream_llava import star_valid_counts
    from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
    from flash_vstream_tpu_torch.train import train as lt
    dp = n_ranks // 2
    cfg, params = _tpar_llava(dev)
    before = {p: _tpar_sample(x) for p, x in _tpar_trained(params).items()}
    grads = {}
    undo = _tpar_tp_capture(grads, parts=2)
    _release(dev)
    t1 = time.perf_counter()
    try:
        ref = lt.run_training(_tpar_tp_args(work, "tp_ref",
                                            TPAR_TP_BATCH * dp),
                              cfg=cfg, params=params,
                              tokenizer=ByteTokenizer())
    finally:
        undo()
    ref_s = time.perf_counter() - t1
    upd = {p: _tpar_sample(x) - before[p]
           for p, x in _tpar_trained(ref["params"]).items()}
    del params, ref["params"]
    _release(dev)
    r0 = ranks[0]
    l_err = max(abs(a - b) / abs(b) for x in ranks
                for a, b in zip(x["tp_losses"], ref["losses"]))
    g_err = {}
    for p, want in grads.items():
        if len(want) == 1:                      # whole: rank 0's
            g_err[p] = _rel(r0["tp_grads"][p][1], want[0])
            continue
        num = den = 0.0
        for x in ranks[:2]:                     # the first dp row's tp pair
            r, got = x["tp_grads"][p]
            num += float((got - want[r]).norm() ** 2)
            den += float(want[r].norm() ** 2)
        g_err[p] = (num / max(den, 1e-60)) ** 0.5
    u_err = {p: _rel(r0["tp_updates"][p], u) for p, u in upd.items()
             if u.norm() > 0}
    print("train_parallel tp per leaf (gradient, update): " + " ".join(
        f"{p}={g_err[p]:.2e},{u_err.get(p, 0):.2e}" for p in sorted(g_err)),
        flush=True)
    for p in TPAR_ZERO_GRAD:
        g_err.pop(p, None)
        u_err.pop(p, None)
    b = r0["tp_bytes"]
    heads = r0["tp_heads"]
    g_worst = max(g_err, key=g_err.get)
    u_worst = max(u_err, key=u_err.get)
    print(f"train_parallel tp 2 x dp {dp} [{r0['backend']} on {smi}]: "
          f"LLaVA stage 2, Vicuna-7B at full width cut to {TPAR_TP_LAYERS} "
          f"layers and CLIP ViT-L/14 to {TPAR_TP_VIT_LAYERS}, feature branch "
          f"at micro-batch {TPAR_TP_BATCH} a dp row, S "
          f"{LT_PRE + LT_POST + sum(star_valid_counts(cfg, LT_FRAMES))}, "
          f"{TPAR_STEPS} steps in "
          f"{r0['tp_s']:.2f} s (steps "
          + " ".join(f"{t:.2f}" for t in r0["tp_steps"])
          + f" s, no speed claim), peak "
          + " / ".join(f"{x['tp_peak'] / 2**30:.2f}" for x in ranks)
          + f" GiB; one rank at the global batch {ref_s:.2f} s; losses "
          + " ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(r0["tp_losses"],
                                                         ref["losses"]))
          + f" (worst rel {l_err:.2e} over the ranks); step 1 gradients, "
          f"gathered over tp, worst rel L2 {g_err[g_worst]:.3e} ({g_worst}) "
          f"limit {TRAIN_REF_LIMIT:.0e}; updates after step {TPAR_STEPS} "
          f"worst rel L2 {u_err[u_worst]:.3e} ({u_worst}) over {len(u_err)} "
          f"moved leaves, limit {DRY_RUN_LIMIT:.1e}; CLIP split features "
          f"err/max " + " / ".join(f"{x['clip_err']:.3e}" for x in ranks)
          + f" limit {TPAR_H_TOL:.0e}; rank 0 holds "
          f"{b['held'] / 1e9:.2f} of {b['whole'] / 1e9:.2f} GB whole: "
          f"{b['n_split']} split leaves {b['split']:.3f}, embed "
          f"{b['embed']:.3f}, lm_head {b['lm_head']:.3f}; heads a launch "
          + " ".join(f"{k}={v}" for k, v in sorted(heads.items()))
          + f", CLIP K1={r0['clip_heads']} (Vicuna 32, CLIP 16 whole); "
          f"launches rank 0 "
          + " ".join(f"{k}={v}" for k, v in r0["tp_launches"].items())
          + f", CLIP K1={r0['clip_launches']['K1']}; planted fault (rank 1 "
          f"keeps its own row product) moves the loss "
          + " / ".join(f"{x['tp_fault']:.3e}" for x in ranks)
          + ", limit 1e-02", flush=True)
    if (l_err > 1e-2 or g_err[g_worst] > TRAIN_REF_LIMIT
            or u_err[u_worst] > DRY_RUN_LIMIT or not u_err
            or max(x["clip_err"] for x in ranks) > TPAR_H_TOL
            or not 0.45 < b["split"] < 0.55 or b["embed"] != 1
            or b["lm_head"] != 1
            or any(heads.get(k) != [16] for k in ("K3", "K4", "K5"))
            or r0["clip_heads"] != [8]):
        raise AssertionError("train_parallel tp: outside its limits")
    if not max(x["tp_fault"] for x in ranks) > 1e-2:
        raise AssertionError("train_parallel tp: the planted fault passed")


def run_train_parallel(dev, smi, root, n_ranks=2):
    """Training across ranks (ROADMAP A16's training half) at the full width
    of Qwen2-VL-7B (QWEN_LAYERS decoder layers, random bf16 weights from the
    seed), two ranks on the one card over gloo (`--shared-card`; NCCL
    refuses two ranks on one GPU), or `n_ranks` cards of a rank each over
    NCCL where there are as many (`--ranks`), the kernels built here
    first:
    (a) one spawn: torch.distributed.run starts this script twice with
        --train-parallel-rank (`_tpar_rank`), two ranks on the one card:
        sp 2 and pp 2 (two micro-batches, each stage its own copy of its
        6 layers) over a batch of 2 x 1,024 ids held to the rank's own
        plain decoder_forward: each rank's hidden states within
        TPAR_H_TOL of max |h|, each adapter's and final_norm's gradient
        (summed over the group) within TRAIN_REF_LIMIT rel L2; a ring step
        that moves nothing must fail the hidden limit, final_norm summed
        over pp twice the gradient's; then run_training --zero-stage 3
        --offload-moments (the decoder cut to TPAR_DP_LAYERS: ZeRO-3 moves
        every layer through host memory on a shared card) over 2 ranks of
        1 video each, its first step's
        reduced gradients and its adapters after TPAR_STEPS steps held to
        run_training in this process at the global batch (ZeRO-2, moments
        resident): gradients within TRAIN_REF_LIMIT (the mean over dp
        taken twice must fail it), adapter updates within DRY_RUN_LIMIT,
        losses within 1e-2; each rank's base against the whole (1/2 where
        ZeRO splits it);
    (b) the entry point on those ranks: finetune_flash's main with
        --dry-run --pp 2 and --sp 2 --shared-card (finite losses); at
        world 1, --zero-stage 3 --offload-moments bit-equal to
        --zero-stage 2;
    (c) on those ranks, tp 2 (dp the rest): the LLaVA finetune stage at
        full width, Vicuna-7B cut to TPAR_TP_LAYERS and CLIP to
        TPAR_TP_VIT_LAYERS, train.run_training --tp 2 over the feature
        branch at micro-batch TPAR_TP_BATCH (S 937), then a raw-frame
        micro-batch through the split CLIP tower, held to one rank in this
        process (`check_tpar_tp`).
    Returns the path's K1/K3/K4/K5 launches (every rank's pp, dp and entry
    runs)."""
    import torch
    from flash_vstream_tpu_torch.train.finetune_flash import run_training
    from flash_vstream_tpu_torch.train.lora import (QWEN_TARGETS,
                                                    init_lora_params)
    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "chip_smoke_train_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data = _synthetic_videos(os.path.join(work, "data"), 2, 224)
    import numpy as np
    from flash_vstream_tpu_torch.core.config import VStreamLLaVAConfig
    _lt_feature_set(os.path.join(work, "llava"), np.random.default_rng(SEED),
                    VStreamLLaVAConfig(),
                    n_items=TPAR_TP_BATCH * TPAR_STEPS * (n_ranks // 2))
    # one spawn: torch.distributed.run starts this script twice as ranks
    # (the kernels are built: the ranks load the library)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n_ranks), os.path.abspath(__file__),
         "--train-parallel-rank", work, data,
         "1" if torch.cuda.device_count() < n_ranks else "0"],
        cwd=root,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"train_parallel ranks exited "
                             f"{proc.returncode}: {proc.stderr[-4000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(n_ranks)]
    t_ranks = time.perf_counter() - t_phase
    for x in ranks:
        print(f"train_parallel rank {x['rank']} [{x['backend']} on "
              f"{smi}]: max |h| {x['h_max']:.3e}; dp {x['dp']} x sp 2 "
              f"{x['sp_s']:.3f} s, "
              f"hidden err/max "
              f"{x['sp_h']:.3e} (fault {x['sp_fault_h']:.3e}), worst grad "
              f"rel L2 {max(x['sp_g'].values()):.3e}; pp 2 {x['pp_s']:.3f} s"
              + (f", hidden err/max {x['pp_h']:.3e}" if x["pp_h"] is not None
                 else "")
              + f", worst grad rel L2 {max(x['pp_g'].values()):.3e} (dp "
              f"{x['dp']} x pp 2), "
              f"final_norm summed twice {x['pp_fault_g']:.3e}; bytes whole "
              f"{x['bytes_whole'] / 1e9:.2f} GB, pp stage "
              f"{x['bytes_stage'] / 1e9:.2f} GB; limits h {TPAR_H_TOL:.0e} "
              f"g {TRAIN_REF_LIMIT:.0e}", flush=True)
        bad = [n for n, e in {**{f"sp {k}": v for k, v in x["sp_g"].items()},
                              **{f"pp {k}": v for k, v in x["pp_g"].items()}
                              }.items() if not e <= TRAIN_REF_LIMIT]
        if bad or x["sp_h"] > TPAR_H_TOL or (x["pp_h"] or 0) > TPAR_H_TOL:
            raise AssertionError(f"train_parallel rank {x['rank']}: "
                                 f"{bad} {x['sp_h']} {x['pp_h']}")
    # the faults fail over the whole run (rank 0's causal queries see no
    # key of rank 1's chunk, so only rank 1 reads the skipped ring step)
    if not (max(x["sp_fault_h"] for x in ranks) > TPAR_H_TOL
            and max(x["pp_fault_g"] for x in ranks) > TRAIN_REF_LIMIT):
        raise AssertionError("train_parallel: a planted fault passed")

    # the dp run against one rank at the global batch
    cfg, params = _tpar_dp(*_tpar_params(dev))
    qlora = init_lora_params(torch.Generator(device=dev).manual_seed(
        SEED + 1), params, rank=64, targets=QWEN_TARGETS)
    lora0 = {f"{p}.{k}": v.detach().float().cpu().clone()
             for p, ab in qlora.items() for k, v in ab.items()}
    grads = {}
    undo = _tpar_capture(grads)
    _release(dev)
    t1 = time.perf_counter()
    try:
        ref = run_training(_tpar_dp_args(os.path.join(work, "ref"), data,
                                         n_ranks),
                           cfg=cfg, params=params, lora=qlora)
    finally:
        undo()
    ref_s = time.perf_counter() - t1
    ref_peak = torch.cuda.max_memory_allocated(dev)
    del params
    r0 = ranks[0]
    g_err = {p: _rel(r0["dp_grads"][p], g) for p, g in grads.items()}
    g_fault = max(_rel(r0["dp_grads"][p] / 2, g) for p, g in grads.items())
    ref_lora = {f"{p}.{k}": v.float().cpu() for p, ab in ref["lora"].items()
                for k, v in ab.items()}
    u_err = {n: _rel(r0["dp_lora"][n] - lora0[n], ref_lora[n] - lora0[n])
             for n in ref_lora if (ref_lora[n] - lora0[n]).norm() > 0}
    l_err = max(abs(a - b) / abs(b) for a, b in zip(r0["dp_losses"],
                                                    ref["losses"]))
    print(f"train_parallel dp {n_ranks} [{smi}]: run_training --zero-stage "
          f"3 --offload-moments ({r0['backend']}), decoder depth "
          f"{TPAR_DP_LAYERS}, {n_ranks} ranks x 1 video of "
          f"{TPAR_FRAMES} frames, max_len {TPAR_LEN}, {TPAR_STEPS} steps in "
          f"{r0['dp_s']:.2f} s (steps "
          + " ".join(f"{t:.2f}" for t in r0["dp_steps"])
          + f" s; rank 1 {ranks[1]['dp_s']:.2f} s; peak "
          f"{r0['peak'] / 2**30:.2f} / {ranks[1]['peak'] / 2**30:.2f} GiB); "
          f"one rank at the global batch (ZeRO-2, resident) {ref_s:.2f} s, "
          f"peak {ref_peak / 2**30:.2f} GiB; losses "
          + " ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(r0["dp_losses"],
                                                         ref["losses"]))
          + f" (worst rel {l_err:.2e}); step 1 gradients worst rel L2 "
          f"{max(g_err.values()):.3e} ({max(g_err, key=g_err.get)}), the dp "
          f"mean taken twice {g_fault:.3e}, limit {TRAIN_REF_LIMIT:.0e}; "
          f"adapter updates after step {TPAR_STEPS} worst rel L2 "
          f"{max(u_err.values()):.3e} over {len(u_err)} moved leaves, limit "
          f"{DRY_RUN_LIMIT:.1e} (Adam's first steps amplify rounding); base "
          f"bytes "
          + " / ".join(f"{x['dp_base'] / 1e9:.2f}" for x in ranks)
          + f" GB a rank against {r0['base_bytes'] / 1e9:.2f} GB whole "
          f"({ranks[0]['dp_base'] / r0['base_bytes']:.3f} against 1/"
          f"{n_ranks}); moments pinned "
          f"on the host {all(x['pinned'] for x in ranks)}", flush=True)
    if (max(g_err.values()) > TRAIN_REF_LIMIT or g_fault <= TRAIN_REF_LIMIT
            or not u_err or max(u_err.values()) > DRY_RUN_LIMIT
            or l_err > 1e-2 or not all(x["pinned"] and x["stage3"]
                                       for x in ranks)
            or not all(x["dp_base"] < 1.2 / n_ranks * x["base_bytes"]
                       for x in ranks)):
        raise AssertionError("train_parallel dp: outside its limits")

    # (b) the entry point's main on the two ranks, then world 1
    for flag in ("--pp", "--sp"):
        with open(os.path.join(work, f"entry{flag}", "scalars.jsonl")) as f:
            losses = [json.loads(ln)["loss"] for ln in f if ln.strip()]
        print(f"train_parallel entry: finetune_flash.main on the {n_ranks} "
              f"ranks torch.distributed.run started: {' '.join(TPAR_ARGS)} "
              f"{flag} 2 in {r0[f'entry{flag}_s']:.1f} s, losses "
              + " ".join(f"{x:.5f}" for x in losses), flush=True)
        if len(losses) != 2 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_parallel entry {flag}: {losses}")
    from flash_vstream_tpu_torch.train.finetune_flash import make_parser
    res = {}
    for tag, extra in (("zero2", ()), ("zero3_offload", (
            "--zero-stage", "3", "--offload-moments"))):
        res[tag] = run_training(make_parser().parse_args(
            [*TPAR_ARGS, "--output-dir", os.path.join(work, tag),
             "--device", "cuda", *extra]))
    same = all(torch.equal(res["zero2"]["lora"][p][k],
                           res["zero3_offload"]["lora"][p][k])
               for p in res["zero2"]["lora"] for k in ("a", "b"))
    print(f"train_parallel world 1: --dry-run --zero-stage 3 "
          f"--offload-moments against --zero-stage 2: losses "
          f"{res['zero3_offload']['losses']} vs {res['zero2']['losses']}, "
          f"adapters bit-equal {same}", flush=True)
    if not same or res["zero2"]["losses"] != res["zero3_offload"]["losses"]:
        raise AssertionError("train_parallel world 1: ZeRO-3 + offload "
                             "differs from ZeRO-2")
    check_tpar_tp(dev, smi, work, ranks, n_ranks)
    check_tpar_qlora(smi, ranks, n_ranks)
    k = {n: sum(x[f"{run}_launches"][n] for x in ranks
                for run in ("pp", "dp", "entry", "tp", "clip", "qlora"))
         for n in ("K1", "K3", "K4", "K5")}
    print(f"train_parallel: launches of the path (every rank's pp, dp, "
          f"entry, tp, tp CLIP and tp LoRA/QLoRA runs) K1={k['K1']} K3={k['K3']} K4={k['K4']} "
          f"K5={k['K5']} "
          f"(sp: the plain ring, K3={sum(x['sp_launches']['K3'] for x in ranks)}"
          f"); ranks {t_ranks:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not (k["K1"] and k["K3"] and k["K4"] and k["K5"]):
        raise AssertionError(f"train_parallel: launches {k}")
    shutil.rmtree(work, ignore_errors=True)
    return k


def _decode_synth(path, fps):
    from flash_vstream_tpu_torch.preprocess.video import SyntheticSource
    i, px = os.path.splitext(os.path.basename(path))[0][1:].split("-")
    return list(SyntheticSource(240, int(px), int(px), seed=int(i)))


def _synthetic_videos(root, n_items, side):
    """train.json naming n_items 240-frame videos `v<i>-<side>.synth`,
    decoded by a registered decoder into `SyntheticSource` frames seeded
    per item (no files, no image library needed; a rank process registers
    `_decode_synth` itself)."""
    from flash_vstream_tpu_torch.preprocess.video import register_video_decoder
    register_video_decoder("synth", _decode_synth)
    os.makedirs(root, exist_ok=True)
    items = [{"id": i, "video": f"v{i}-{side}.synth", "conversations": [
        {"from": "human", "value": f"<video>\nDescribe video {i}."},
        {"from": "gpt", "value": f"It shows a moving texture, number {i}."}]}
        for i in range(n_items)]
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path


# P1's odd cases, (bank shape, indices): repeated indices, K = 1, and rows
# that are not a multiple of the 16 KB stage (18,480 and 1,008 bytes in bf16)
P1_ODD = (((64, 7, 1320), [5, 63, 5, 0, 5]), ((64, 7, 1320), [17]),
          ((50, 7, 72), [49, 0, 49]))


def check_bank_gather(dev):
    """P1 against its plain version, bit-exact, at the probe's shape (bank
    [1024, 256, 1280], 30 indices) in bf16 and f32 and at the odd cases,
    the grid each call launched (as its C entry reports it) that of the
    wrapper's plan and one wave: no more blocks than the driver says the
    card holds at once; its plan at the probe's shape; device times of the
    probe's four routes at that shape in bf16, 32 index sets rotating so
    the reads come from device memory, not the 50 MB L2, and P1 at K 1 (one
    1,008-byte row: its fixed cost); then the probe's entry point at its
    defaults, P1 and K2 launched exactly as reckoned. Returns (P1's row,
    the probe run's launches)."""
    import torch
    from flash_vstream_tpu_torch.kernels.bank_gather import (
        bank_gather_cuda, bank_gather_reference, card_plan, card_ring)
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.scripts import probe_bank_gather as probe

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    T, K, P, D = 1024, 30, 256, 1280
    idxs = [torch.randint(0, T, (K,), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32) for _ in range(32)]
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(probe.make_bank(T, P, D, dtype, dev, SEED), i)
                 for i in idxs[:4]]
        cases += [(probe.make_bank(*shape, dtype, dev, SEED),
                   torch.tensor(i, dtype=torch.int32, device=dev))
                  for shape, i in P1_ODD]
        for bank, idx in cases:
            got = bank_gather_cuda(bank, idx)
            torch.cuda.synchronize(dev)
            if not torch.equal(got, bank_gather_reference(bank, idx)):
                raise AssertionError(f"P1 {dtype} bank{tuple(bank.shape)} "
                                     f"idx {idx.tolist()}: not bit-exact")
            plan = card_plan(idx.shape[0], _nbytes(bank[0]), dev.index)
            resident = card_ring(dev.index)[0]
            grid = bank_gather_cuda.grid
            if grid != (plan.splits, plan.rows) or math.prod(grid) > resident:
                raise AssertionError(f"P1 bank{tuple(bank.shape)} K "
                                     f"{idx.shape[0]}: launched grid {grid}, "
                                     f"planned {plan}, resident {resident}")
        print(f"P1 {str(dtype)[6:]}: bit-exact against index_select at bank"
              f"[{T}, {P}, {D}] x 4 index sets of {K} and bank[64, 7, 1320] "
              f"idx [5, 63, 5, 0, 5] / [17], bank[50, 7, 72] idx [49, 0, 49]",
              flush=True)
        del cases
    bank = probe.make_bank(T, P, D, torch.bfloat16, dev, SEED)
    resident, stage_bytes, stages = card_ring(dev.index)
    plan = card_plan(K, _nbytes(bank[0]), dev.index)
    print(f"P1 plan: bank[{T}, {P}, {D}] bf16 idx[{K}]: grid {plan.splits} "
          f"shares x {plan.rows} rows = {plan.blocks} blocks (resident "
          f"{resident}: the driver's occupancy x SMs; one wave), shares of "
          f"{plan.share} B ({plan.extra} a row of {plan.share + plan.unit} "
          f"B), ring {stages} x {stage_bytes} B", flush=True)
    lidx = [i.long() for i in idxs]
    ms = _ms(lambda i: bank_gather_cuda(bank, idxs[i % 32]), 64)
    eager = _eager_ms(lambda i: bank_gather_cuda(bank, idxs[i % 32]), 200)
    k2 = _ms(lambda i: gather_rows_cuda(bank, idxs[i % 32]), 64)
    plain = _ms(lambda i: bank_gather_reference(bank, idxs[i % 32]), 64)
    lib = _ms(lambda i: bank.index_select(0, lidx[i % 32]), 64)
    onehot = _ms(lambda i: probe.gather_onehot(bank, idxs[i % 32]), 8)
    bound = _bound(0, 2 * _nbytes(bank[:K]) + _nbytes(idxs[0]))
    small, one = probe.fixed_case(dev)
    fixed = _ms(lambda i: bank_gather_cuda(small, one), 64)
    print(f"P1 bank_gather: bank[{T}, {P}, {D}] bf16 idx[{K}] (19.7 MB "
          f"out) kernel_ms={ms:.4f} eager_ms={eager:.4f} k2_ms={k2:.4f} "
          f"plain_ms={plain:.4f} (index_select, int32 idx) bound_ms="
          f"{bound[0]:.4f} ({bound[1]}) library_ms={lib:.4f} (index_select)"
          f" onehot_ms={onehot:.4f}; K 1 ({_nbytes(small[0])} B row) "
          f"kernel_ms={fixed:.4f}", flush=True)
    del bank

    # the probe through its entry point, at its defaults
    iters = 50
    _reset_launches()
    res = probe.main(["--iters", str(iters)])
    got = {"bank_gather": bank_gather_cuda.launches,
           "gather_rows": gather_rows_cuda.launches}
    # the chain runs eagerly once, then once under capture; the replays
    # launch without passing through the wrappers
    want = {"bank_gather": 2 * iters, "gather_rows": 2 * iters}
    print(f"bank_gather: python -m flash_vstream_tpu_torch.scripts."
          f"probe_bank_gather (defaults, {iters} chained gathers, graph "
          f"replay best of {probe.TRIALS}) ms per gather: " + " ".join(
              f"{m}={s * 1e3:.4f}" for m, s in res.items())
          + f"; launches P1={got['bank_gather']} K2={got['gather_rows']} "
          f"(2 x {iters} each, reckoned)", flush=True)
    if got != want or set(res) != set(probe.MODES):
        raise AssertionError(f"bank_gather probe: launches {got}, reckoned "
                             f"{want}; routes {list(res)}")
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound[0],
               bound_by=bound[1], library_ms=lib)
    return {"bank_gather": row}, got


# P2 against its plain version: max |err| over the plain output's max |value|.
# The kernel lands at most one bf16 step from it, at most 2^-7 of the max (an
# H100 80GB HBM3 at 700 W read max |err| 9.8e-4 at 448 px and 2.0e-3 at 224
# px: one step; PERF.md, PR 7), so a row sum 5% off shows
P2_TOL = 1e-2
P2_INSTANCES = 11          # template instances of P2 in the build
# w8a8 `dense` against weight-only int8 at prefill shapes (rows, din, dout):
# per-token int8 activations move the output by about 1e-2 of its max
# (tests/test_torch_w8a8.py reads 0.8e-2 to 1.2e-2 on the CPU)
W8A8_LIMIT = 3e-2
W8A8_SHAPES = (("vit wq/wk/wv/wo", 1024, 1280, 1280),
               ("vit fc1", 1024, 1280, 5120), ("vit fc2", 1024, 5120, 1280),
               ("decoder wq/wo", 2989, 3584, 3584),
               ("decoder wk/wv", 2989, 3584, 512),
               ("decoder gate/up", 2989, 3584, 18944),
               ("decoder down", 2989, 18944, 3584))
LONG_QUESTION = "What is happening, and which objects appear? " * 4 + "Say."
# the ViT probe's modes against base: max |err| over max |base| after 32
# layers. The modes that compute base's function read 2.35e-2 in bf16 (its
# attention rounds p to bf16 at other points, and 32 layers carry that),
# 3.81e-2 under w8a8; onecall reads 0.81 and noattn 1.40 (H100 80GB HBM3,
# 700 W)
VIT_MODE_LIMIT = 1e-1


def check_frame_attention(dev):
    """P2 against its plain version at the ViT's 224 and 448 px frame
    shapes (the ViT's strided [T, P, H, Dh] -> [T, H, P, Dh] views) with
    head blocks 1 and 8, which must agree bit for bit (the grid is one
    block per (q tile, head, frame) at every head block). P2 (both blocks),
    K1, SDPA and the plain version timed on the same inputs, with the
    function's bound and the bound with the second Q K^T that two passes
    compute. First the P2 instances' ptxas registers and spills and their
    SASS counts of ldmatrix (LDSM), cp.async (LDGSTS) and mma (HMMA).
    Returns P2's row, at the 224 px full stream (head block 8, the probe's
    default)."""
    import torch
    import torch.nn.functional as F
    from flash_vstream_tpu_torch.kernels import _build
    from flash_vstream_tpu_torch.kernels import frame_attention as fra
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.frame_attention import (
        P2_CASES, frame_attention_cuda, frame_attention_reference)

    lib = _build.library_path()
    ptxas = _ptxas_counts(lib.with_suffix(".log"), _p2_instance)
    sass = _sass_counts(lib, _p2_instance)
    for inst in sorted(ptxas):
        regs, st, ld = ptxas[inst]
        ops = sass.get(inst, {}) if isinstance(sass, dict) else {}
        print(f"P2 ptxas {inst}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B; sass LDSM={ops.get('LDSM', 0)} "
              f"LDGSTS={ops.get('LDGSTS', 0)} HMMA={ops.get('HMMA', 0)} "
              f"MUFU={ops.get('MUFU', 0)}", flush=True)
    if not isinstance(sass, dict) or len(ptxas) < P2_INSTANCES or not all(
            sass.get(i, {}).get("LDSM") and sass[i].get("LDGSTS")
            for i in ptxas):
        raise AssertionError(f"P2: ptxas {ptxas}, sass {sass}: expected "
                             f"{P2_INSTANCES} instances, each with LDSM and "
                             f"LDGSTS")

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    worst, row = 0.0, None
    for name, T, S in P2_CASES:
        q, k, v = (torch.randn(T, S, 16, 80, generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        ref = frame_attention_reference(q, k, v).float()
        top = ref.abs().max().item()
        errs, outs = [], []
        for hb in (1, 8):
            outs.append(frame_attention_cuda(q, k, v, head_block=hb))
            torch.cuda.synchronize(dev)
            errs.append((outs[-1].float() - ref).abs().max().item())
            if not torch.isfinite(outs[-1]).all() or errs[-1] > P2_TOL * top:
                raise AssertionError(f"P2 {name} head_block {hb}: max_abs_err"
                                     f" {errs[-1]} > {P2_TOL} x max {top} or "
                                     f"non-finite")
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"P2 {name}: head blocks 1 and 8 differ")
        plan = fra._launch_plan(T, 16, S, 80)
        worst = max(worst, *errs)
        ms = _ms(lambda i: frame_attention_cuda(q, k, v, head_block=8), 50)
        ms1 = _ms(lambda i: frame_attention_cuda(q, k, v, head_block=1), 50)
        k1 = _ms(lambda i: flash_attention_cuda(q, k, v), 50)
        lib_ms = _ms(lambda i: F.scaled_dot_product_attention(q, k, v), 50)
        plain = _ms(lambda i: frame_attention_reference(q, k, v), 5)
        flops = 4 * T * 16 * S * S * 80
        bound = _bound(flops, _nbytes(q, k, v, q))
        bound2 = _bound(flops * 3 // 2, _nbytes(q, k, v, q))
        gx, gy, gz = plan.grid
        print(f"P2 {name}: q[{T}, 16, {S}, 80] bf16 {plan.variant} "
              f"{gx * gy * gz} blocks of {plan.rows_per_block} rows, "
              f"{plan.smem_bytes} shared bytes; max_abs_err hb1="
              f"{errs[0]:.3e} hb8={errs[1]:.3e} of max {top:.3e} (limit "
              f"{P2_TOL:.0e} x max, hb1 = hb8 bit for bit) kernel_ms hb8="
              f"{ms:.4f} hb1={ms1:.4f} k1_ms={k1:.4f} plain_ms={plain:.4f} "
              f"bound_ms={bound[0]:.4f} ({bound[1]}) with the second Q K^T "
              f"{bound2[0]:.4f} ({bound2[1]}) library_ms={lib_ms:.4f} "
              f"(scaled_dot_product_attention)", flush=True)
        if row is None:
            row = dict(ms=ms, plain_ms=plain, bound_ms=bound[0],
                       bound_by=bound[1], library_ms=lib_ms)
    return {"frame_attention": dict(max_abs_err=worst, **row)}


def check_w8a8(dev, work):
    """w8a8 `dense` against weight-only int8 `dense` on the same inputs at
    the ViT's and the decoder's prefill shapes (err over max |weight-only|,
    held to W8A8_LIMIT; both timed), then the dry-run server with
    --load-8bit --int8-vit --w8a8-prefill on the card in its own process
    (a 184-byte question makes its prefill >= 128 rows, which w8a8 takes)."""
    import torch
    from flash_vstream_tpu_torch.models import layers
    from flash_vstream_tpu_torch.weights.quantize import (enable_w8a8_prefill,
                                                          quantize_weight)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    for name, rows, din, dout in W8A8_SHAPES:
        x = torch.randn(rows, din, generator=g, device=dev).to(torch.bfloat16)
        w = quantize_weight(torch.randn(din, dout, generator=g, device=dev)
                            / din ** 0.5)
        timed = {}
        for on in (False, True):
            enable_w8a8_prefill(on)       # read when `dense` is called
            try:
                timed[on] = (layers.dense(x, w).float(),
                             _ms(lambda i: layers.dense(x, w), 10))
            finally:
                enable_w8a8_prefill(False)
        wo, w8 = timed[False][0], timed[True][0]
        err = ((w8 - wo).abs().max() / wo.abs().max()).item()
        print(f"w8a8 {name}: x[{rows}, {din}] @ int8[{din}, {dout}] err/max "
              f"against weight-only {err:.3e} (limit {W8A8_LIMIT:.0e}) "
              f"w8a8_ms={timed[True][1]:.4f} weight_only_ms="
              f"{timed[False][1]:.4f}", flush=True)
        if not torch.isfinite(w8).all() or err > W8A8_LIMIT:
            raise AssertionError(f"w8a8 {name}: err/max {err} > {W8A8_LIMIT}")
        del x, w, timed

    out = os.path.join(work, "dry_run_w8a8.json")
    os.makedirs(work, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "flash_vstream_tpu_torch.serve.cli_server",
         "--dry-run", "--load-8bit", "--int8-vit", "--w8a8-prefill",
         "--synthetic-frames", "8", "--play_speed", "0", "--question",
         LONG_QUESTION, "--question_interval", "1000", "--max-new-tokens",
         "4", "--output-file", out],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cli_server --dry-run --w8a8-prefill exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        dry = json.load(f)
    if dry["frames_ingested"] != 8 or len(dry["answers"]) != 1:
        raise AssertionError(f"cli_server --dry-run --w8a8-prefill: {dry}")
    print(f"w8a8: python -m flash_vstream_tpu_torch.serve.cli_server "
          f"--dry-run --load-8bit --int8-vit --w8a8-prefill on the card: "
          f"exit 0, {dry['frames_ingested']} frames, answer "
          f"{dry['answers'][0]['answer'][:30]!r}", flush=True)


def run_vit_probe(dev, iters=2, trials=2):
    """The ViT probe through its entry point at full width (32 layers, 1280
    hidden, 224 px, clip 8), every mode, in bf16, then --int8-weight-only,
    then --int8, then at 448 px (S 1,024 and 256 per frame) in bf16 with
    base, framekernel and xlaattn (--iters 1 --trials 1): ms/clip by graph
    replay and eagerly, TF/s, max |err| against base, and K1 and P2
    launched exactly as reckoned per mode and over the four runs; the modes
    that compute base's function within VIT_MODE_LIMIT of base, onecall and
    noattn beyond it. Returns the launches of the four runs."""
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.frame_attention import (
        frame_attention_cuda)
    from flash_vstream_tpu_torch.models import layers
    from flash_vstream_tpu_torch.scripts import probe_vit_variants as probe

    L = 32
    want = {"K1": 0, "P2": 0}
    _reset_launches()
    runs = [("", "224", probe.MODES, iters, trials),
            ("--int8-weight-only", "224", probe.MODES, iters, trials),
            ("--int8", "224", probe.MODES, iters, trials),
            ("", "448", ("base", "framekernel", "xlaattn"), 1, 1)]
    for flag, side, modes, n_it, n_tr in runs:
        # encodes through the wrappers per mode: the chain eagerly once and
        # under capture once (graph time), `n_tr` eager chains, one for err
        blocks = L * (n_it * (2 + n_tr) + 1)
        res = probe.main(["--side", side, "--modes", ",".join(modes),
                          "--iters", str(n_it), "--trials", str(n_tr)]
                         + ([flag] if flag else []))
        want["K1"] += 2 * L                    # main's own base encode
        for mode, r in res.items():
            per = {"K1": probe.K1_PER_BLOCK.get(mode, 0) * blocks,
                   "P2": probe.P2_PER_BLOCK.get(mode, 0) * blocks}
            want = {k: want[k] + per[k] for k in want}
            print(f"vit_probe {side}px {flag or 'bf16'} {mode}: ms/clip graph"
                  f" {r['s'] * 1e3:.2f} eager {r['eager_s'] * 1e3:.2f} TF/s "
                  f"{r['tflops']:.1f} max|err| vs base {r['err']:.3e} "
                  f"({r['err_rel']:.2e} of max, limit {VIT_MODE_LIMIT:.0e} "
                  f"{'within' if mode in probe.SAME_AS_BASE else 'beyond'}) "
                  f"launches K1={r['launches']['K1']} P2={r['launches']['P2']}"
                  f" (reckoned {per['K1']}, {per['P2']})", flush=True)
            same = mode in probe.SAME_AS_BASE
            if (r["blocks"] != blocks or r["launches"] != per
                    or not math.isfinite(r["err_rel"])
                    or (r["err_rel"] <= VIT_MODE_LIMIT) != same):
                raise AssertionError(f"vit_probe {side}px {flag} {mode}: {r}")
        if layers.W8A8_PREFILL:
            raise AssertionError("vit_probe: w8a8 left on after the run")
    got = {"K1": flash_attention_cuda.launches,
           "P2": frame_attention_cuda.launches}
    print(f"vit_probe: launches over the four runs K1={got['K1']} "
          f"P2={got['P2']} (reckoned {want['K1']}, {want['P2']})", flush=True)
    if got != want:
        raise AssertionError(f"vit_probe: launches {got}, reckoned {want}")
    return {"flash_attention_fwd": got["K1"], "frame_attention": got["P2"]}


# P3/P4 at the int4 probe's default shape and two small odd ones (din, dout,
# blk): nb 28, 4 and 2
P3_SHAPES = ((3584, 18944, 512), (512, 384, 128), (256, 384, 128))
# each variant against its plain version: max |err| over max |plain|. bf16
# outputs of f32 sums taken in another order, K6's limit; v4's int32 dots
# are exact, so only its f32 block sums' order differs: the same limit; v7
# sums integers (exact in f32) and rounds as its plain version: exact
P3_TOL = {"v7-unpackonly": 0.0}
# the variants that run K6's B = 1 kernel (csrc/int4_b1.cuh): one launch a
# call, the same bits run to run
P3_FOLD = ("v1-current", "v2-biasfold", "v3-floor", "v5-u8mask",
           "v7-unpackonly")
# the variants of one launch a call and the same bits run to run, by the
# device kernel each runs: the fold variants and P4 (csrc/bf16_b1.cuh)
P3_ONE_KERNEL = {**{v: "int4_fold_kernel" for v in P3_FOLD},
                 "v6-bf16dot": "bf16_b1_kernel"}
# the B = 1 kernel's conversion of each of them
P3_CONVERSIONS = {"Packed": "v5", "PerElement": "v2", "Unbiased": "v1",
                  "Floor": "v3", "Ones": "v7"}
P3_LINES = {"v1-current": 35, "v2-biasfold": 58, "v3-floor": 83,
            "v4-int8dot": 97, "v5-u8mask": 124, "v6-bf16dot": 266,
            "v7-unpackonly": 273}
P3_UNSCALED = ("v3-floor", "v7-unpackonly")


def _p3_library(name, x, xq, xs, q, s):
    """The variant's function as one `_weight_int4pack_mm` call on
    prepared inputs, ((x, QuantWeight4, zero), what it computes): v3 and v7
    with scale 1 and zero 8 (the weight is then the biased nibble u), v7 on
    x[0, 0] in every row (x00 * sum u), v4 on xq in bf16 (exact) with the
    scales s * xs."""
    import torch
    from flash_vstream_tpu_torch.weights.quantize import QuantWeight4
    if name == "v3-floor":
        return (x, QuantWeight4(q, torch.ones_like(s)), 8.0), "scale 1, zero 8"
    if name == "v7-unpackonly":
        return ((x[:, :1].expand_as(x).contiguous(),
                 QuantWeight4(q, torch.ones_like(s)), 8.0),
                "x00 in every row, scale 1, zero 8")
    if name == "v4-int8dot":
        return ((xq.to(torch.bfloat16), QuantWeight4(q, s * xs.float()), 0.0),
                "bf16 xq, scale s * xs")
    return (x, QuantWeight4(q, s), 0.0), ""


def _int4_instance(name):
    """The P3/P4 kernel instance a SASS or ptxas function name matches, or
    None: v1, v2, v3, v5 and v7 are the B = 1 kernel with the Unbiased,
    PerElement, Floor, Packed and Ones conversions at 1, 2 or 4 steps of
    loads in flight (groups 4, 8, 16); K6's own instance is v5 G4's; v6 is
    the bf16 B = 1 kernel at the same steps."""
    fold = _fold_instance(name)
    if fold:
        return P3_CONVERSIONS[fold[0]] + f" G{4 * fold[1]}"
    m = re.search(r"(int4_variant_kernelILi(\d+)ELi(\d+)E"
                  r"|bf16_b1_kernelILi(\d+)E)", name)
    if not m:
        return None
    return (f"v{m.group(2)} G{m.group(3)}" if m.group(2)
            else f"v6 G{4 * int(m.group(4))}")


def check_fold_build(lib_path):
    """P3 v5, v2, v1, v3 and v7 and P4 (v6) as built, at each group:
    ptxas registers and spills and SASS counts. Each fails without HMMA
    (the products on the tensor cores); v5, v1, v3 and v7 fail with any I2F
    or I2FP (their nibbles convert in the packed domain), v2 without I2FP
    (each nibble converted on its own); v6 with any I2F, I2FP or F2FP (its
    fragments are the loaded bf16 words, its output rounds by integer
    operations); v1 fails without its bf16x2 subtract (nvcc 12.8 emits
    HADD2.BF16_V2 for `__hsub2`, 64 a step), v3 and v7 with any LDGSTS
    (they fetch no scales); a spill fails at group 4 and is only shown at
    8 and 16."""
    regs = _ptxas_counts(lib_path.with_suffix(".log"), _int4_instance)
    sass = _sass_counts(lib_path, _int4_instance, full=True)
    for v in (*P3_CONVERSIONS.values(), "v6"):
        kernel = "bf16_b1_kernel" if v == "v6" else "int4_fold_kernel"
        for group in (4, 8, 16):
            inst = f"{v} G{group}"
            if inst not in regs:
                raise AssertionError(f"int4_probe ptxas: no {inst} in the "
                                     f"build log")
            r, st, ld = regs[inst]
            line = (f"int4_probe ptxas {inst} ({kernel}): registers="
                    f"{r} spill stores={st} B spill loads={ld} B")
            if isinstance(sass, str):
                print(line + f"; SASS {sass}", flush=True)
            else:
                c = sass.get(inst, {})
                n = {op: sum(val for k, val in c.items()
                             if k.split(".")[0] == op)
                     for op in ("HMMA", "I2FP", "I2F", "F2FP", "PRMT", "LOP3",
                                "LDGSTS")}
                n["HADD2.BF16_V2"] = c.get("HADD2.BF16_V2", 0)
                print(line + "; SASS " + " ".join(
                    f"{k}={val}" for k, val in n.items())
                    + f" of {sum(c.values())} instructions", flush=True)
                if (not n["HMMA"] or (v != "v2" and (n["I2F"] or n["I2FP"]))
                        or (v == "v2" and not n["I2FP"])
                        or (v == "v6" and n["F2FP"])
                        or (v == "v1" and not n["HADD2.BF16_V2"])
                        or (v in ("v3", "v7") and n["LDGSTS"])):
                    raise AssertionError(f"int4_probe SASS {inst}: {n}")
            if group == 4 and (st or ld):
                raise AssertionError(f"int4_probe ptxas {inst} spills")


def _device_kernels(fn):
    """{device kernel: launches} in one call of fn, by torch.profiler (not
    the wrappers' counts). A session after earlier ones in the process
    can record no device event at all (PERF.md section 7): then fn runs
    again in a new session, up to three in all; a session that recorded
    any device event is the answer."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ran = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        if ran:
            return ran
    return ran


def _p2_instance(name):
    """The P2 kernel instance a SASS or ptxas function name matches
    (whole<D,tiles> or tiled<D>), or None."""
    m = re.search(r"frame_attention_(whole|tiled)ILi(\d+)E(?:Li(\d+)E)?",
                  name)
    if not m:
        return None
    return f"{m.group(1)}<{m.group(2)}" + (f",{m.group(3)}>" if m.group(3)
                                           else ">")


def _sass_counts(lib_path, instance, full=False):
    """{kernel instance: {opcode: count}} from `cuobjdump -sass` of the
    built library (NOPs left out) for the functions `instance` names, or a
    string saying why not. `full` keys the counts by the opcode with its
    modifiers (LDS.U16, not LDS)."""
    import collections
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return f"not measured (no {tool})"
    dump = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            cur = instance(line)
            if cur:
                counts[cur] = collections.Counter()
        elif cur:
            op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)"
                          + (r"((?:\.\w+)*)" if full else ""), line)
            if op and op.group(1) != "NOP":
                counts[cur][op.group(1) + (op.group(2) if full else "")] += 1
    return counts


def _ptxas_counts(log_path, instance):
    """{kernel instance: (registers, spill store bytes, spill load bytes)}
    from the build's `-Xptxas -v` log for the functions `instance` names."""
    out, cur = {}, None
    text = log_path.read_text() if log_path.exists() else ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = instance(entry.group(1))
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        used = re.search(r"Used (\d+) registers", line)
        if cur and spill:
            out[cur] = (None, int(spill.group(1)), int(spill.group(2)))
        elif cur and used:
            out[cur] = (int(used.group(1)),) + out.get(cur, (0, 0, 0))[1:]
            cur = None
    return out


def check_int4_probe(dev, iters=50):
    """P3 (v1-v5, v7) and P4 (v6) against their plain versions at the int4
    probe's default shape (the 7B gate/up matvec, [1, 3584] @ int4 [3584,
    18944], blk 512) and at small odd shapes, with random scales; at the
    default shape each kernel timed by CUDA-graph replay rotating weight
    copies past the 50 MB L2 (also at 8 and 16 packed rows per thread per
    step: more loads in flight), eagerly, its plain version, the bound,
    the library call and K6 on the same inputs, and its SASS instruction
    counts; v1, v2, v3, v5 and v7 (K6's B = 1 kernel) and v6 (its bf16
    B = 1 kernel, with its plan) first as built (`check_fold_build`), then
    the same bits run to run at every shape and group and one device
    kernel a call (torch.profiler); then the probe
    through `main([])` and `main2(['--which', 'v6,v7'])` at its defaults,
    each variant launched exactly 2 x iters x 16 times (the chain's eager
    warm-up and its graph capture). Returns (the seven rows, the probe
    run's launches)."""
    import torch
    from flash_vstream_tpu_torch.kernels import _build
    from flash_vstream_tpu_torch.kernels import int4_variants as iv
    from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_cuda
    from flash_vstream_tpu_torch.scripts import probe_int4_variants as probe

    check_fold_build(_build.library_path())
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows, worst = {}, {}
    for din, dout, blk in P3_SHAPES:
        full = (din, dout, blk) == P3_SHAPES[0]

        def draw():
            q = torch.randint(0, 256, (din // 2, dout), generator=g,
                              device=dev, dtype=torch.uint8)
            s = torch.rand(din // 128, dout, generator=g, device=dev) * 2e-3
            return q, s + 5e-4
        x = torch.randn(1, din, generator=g, device=dev).to(torch.bfloat16)
        xq, xs = probe.quantize_x(x)
        # copies of q4 + scale (din * dout / 2 + din * dout / 32 bytes) to
        # pass 100 MB, twice the L2
        n4 = max(2, -(-100_000_000 // (din * dout // 2 + din * dout // 32)))
        weights = [draw() for _ in range(n4 if full else 1)]
        n16 = 2 if full else 1
        w16 = [torch.randn(din, dout, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(n16)]
        k6 = None
        for name, (fn, int8_x) in probe.VARIANTS.items():
            kern = getattr(iv, fn.__name__ + "_cuda")
            ref = getattr(iv, fn.__name__ + "_reference")
            if name == "v6-bf16dot":
                argsets = [(x, w) for w in w16]
            elif int8_x:
                argsets = [(xq, xs, *w) for w in weights]
            else:
                argsets = [(x, *w) for w in weights]
            want = ref(*argsets[0]).float()
            want_max = want.abs().max().item()
            tol = P3_TOL.get(name, K6_TOL)
            shape_err = 0.0
            for group in iv.GROUPS:          # rows per thread per step
                got = kern(*argsets[0], blk=blk, group=group)
                torch.cuda.synchronize(dev)
                err = (got.float() - want).abs().max().item()
                rel = err / want_max
                if not torch.isfinite(got).all() or rel > tol:
                    raise AssertionError(
                        f"{name} x[1, {din}] dout {dout} blk {blk} group "
                        f"{group}: max err {err} is {rel:.3e} of max |plain| "
                        f"> {tol}")
                if name in P3_ONE_KERNEL and not torch.equal(
                        got, kern(*argsets[0], blk=blk, group=group)):
                    raise AssertionError(f"{name} x[1, {din}] dout {dout} "
                                         f"group {group}: two runs differ")
                shape_err = max(shape_err, err)
            worst[name] = max(worst.get(name, 0.0), shape_err)
            if not full:
                print(f"P3/P4 {name}: x[1, {din}] dout {dout} blk {blk} nb "
                      f"{din // 128} max_abs_err={shape_err:.3e} over "
                      f"groups {iv.GROUPS} (limit {tol:.0e} of max)",
                      flush=True)
                continue
            n = len(argsets)
            ms = _ms(lambda i: kern(*argsets[i % n], blk=blk), max(20, 2 * n))
            group_ms = {grp: _ms(lambda i: kern(*argsets[i % n], blk=blk,
                                                group=grp), max(20, 2 * n))
                        for grp in iv.GROUPS if grp != 4}
            eager = _eager_ms(lambda i: kern(*argsets[i % n], blk=blk), 200)
            plain = _ms(lambda i: ref(*argsets[i % n]), 4)
            # v3 and v7 do not read the scales
            read = argsets[0][:2] if name in P3_UNSCALED else argsets[0]
            bound = _bound(2 * din * dout, _nbytes(*read, got))
            if name == "v6-bf16dot":
                lib = lambda i: torch.matmul(*argsets[i % n])  # noqa: E731
                why = "torch.matmul"
            else:
                libs = []
                for q, s in weights:
                    args, why = _p3_library(name, x, xq, xs, q, s)
                    libs.append(_int4pack_mm(*args))
                lib = (lambda i: libs[i % n][0]()) if libs[0][0] else None
                why = "_weight_int4pack_mm" + (f", {why}" if why else "") + (
                    "" if lib else f": {libs[0][1]}")
            lib_ms = _ms(lib, 20) if lib else None
            lib_rel = ((lib(0).float() - want).abs().max().item()
                       / want_max) if lib else None
            lib = libs = None
            if k6 is None:
                k6 = _ms(lambda i: int4_matmul_cuda(x, *weights[i % n]),
                         max(20, 2 * n))
            one = ""
            if name in P3_ONE_KERNEL:
                ran = _device_kernels(lambda: kern(*argsets[0], blk=blk))
                if (sum(ran.values()) != 1
                        or not any(P3_ONE_KERNEL[name] in k for k in ran)):
                    raise AssertionError(f"{name}: device kernels of one "
                                         f"call {ran}, not one launch")
                one = ("; 1 device kernel a call (torch.profiler), "
                       "bit-identical run to run")
            if name == "v6-bf16dot":
                one += "; plan (split, warps, rows) " + " ".join(
                    f"G{grp} " + str(tuple(iv._p4_plan(
                        din, dout, dev.index, iv.load_depth(grp))))
                    for grp in iv.GROUPS)
            print(f"P3/P4 {name}: x[1, {din}] @ [{din}, {dout}] blk {blk} nb "
                  f"{din // 128} max_abs_err={shape_err:.3e} "
                  f"({shape_err / want_max:.2e} of max over groups "
                  f"{iv.GROUPS}, limit {tol:.0e}) kernel_ms={ms:.4f} "
                  f"eager_ms={eager:.4f} "
                  f"plain_ms={plain:.4f} bound_ms={bound[0]:.4f} ({bound[1]})"
                  f" library_ms=" + (f"{lib_ms:.4f} ({why})" if lib_ms
                                     is not None else f"none ({why})")
                  + (f" library_err={lib_rel:.2e} of max" if lib_ms
                     is not None else "")
                  + f" k6_ms={k6:.4f} group8_ms={group_ms[8]:.4f} "
                  f"group16_ms={group_ms[16]:.4f} ({n} weight copies rotated)"
                  + one, flush=True)
            rows[fn.__name__] = dict(
                ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
                library_ms=lib_ms, group_ms=group_ms)
        del weights, w16, argsets
        torch.cuda.empty_cache()
    for name, (fn, _) in probe.VARIANTS.items():
        rows[fn.__name__] = dict(max_abs_err=worst[name], **rows[fn.__name__])
    sass = _sass_counts(_build.library_path(), _int4_instance)
    for kernel, ops in (sass.items() if isinstance(sass, dict) else ()):
        print(f"int4_probe sass {kernel}: {sum(ops.values())} instructions, "
              + " ".join(f"{op}={ops[op]}" for op in (
                  "LDG", "LDGSTS", "HMMA", "I2FP", "I2F", "F2FP", "FFMA",
                  "FADD", "HADD2", "HFMA2", "IDP", "PRMT", "LOP3", "SHF",
                  "IMAD")), flush=True)
    if not isinstance(sass, dict):
        print(f"int4_probe sass: {sass}", flush=True)

    # the probe through its entry points, at its defaults
    _reset_launches()
    res = probe.main(["--iters", str(iters)])
    res.update(probe.main2(["--iters", str(iters), "--which", "v6,v7"]))
    got = {k.__name__[:-5]: k.launches for k in iv.KERNELS}
    want = {k: 2 * iters * probe.LAYERS for k in got}
    print("int4_probe: python -m flash_vstream_tpu_torch.scripts."
          f"probe_int4_variants (defaults: 16 layers, {iters} iters, graph "
          "replay best of 4) and --which v6,v7, ms per matvec: " + " ".join(
              f"{m}={s * 1e3:.4f}" for m, s in res.items())
          + "; launches " + " ".join(f"{k}={c}" for k, c in got.items())
          + f" (2 x {iters} x {probe.LAYERS} each, reckoned)", flush=True)
    if got != want or set(res) != set(probe.VARIANTS):
        raise AssertionError(f"int4 probe: launches {got}, reckoned {want}; "
                             f"variants {list(res)}")
    return rows, got


def _launches():
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    return {"K1": fa.flash_attention_cuda.launches,
            "K3": fa.flash_attention_fwd_lse_cuda.launches,
            "K4": fa.flash_attention_bwd_dq_cuda.launches,
            "K5": fa.flash_attention_bwd_dkv_cuda.launches}


def _reset_launches():
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    from flash_vstream_tpu_torch.kernels.bank_gather import bank_gather_cuda
    from flash_vstream_tpu_torch.kernels.frame_attention import (
        frame_attention_cuda)
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_cuda
    from flash_vstream_tpu_torch.kernels.int4_variants import KERNELS
    for fn in (fa.flash_attention_cuda, fa.flash_attention_fwd_lse_cuda,
               fa.flash_attention_bwd_dq_cuda, fa.flash_attention_bwd_dkv_cuda,
               gather_rows_cuda, int4_matmul_cuda, bank_gather_cuda,
               frame_attention_cuda, *KERNELS):
        fn.launches = 0


def _release(dev):
    """Free what an earlier phase left (a finished trainer sits in a
    reference cycle until the collector runs) and restart the peak."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def run_train_slice(dev, params, work, cfg=None):
    """`run_training` on the full-width model: 224 px, 240 frames, max_len
    4096, grad_accum 2, 3 optimizer steps; per step its loss, seconds,
    tokens/s and kernel launches. Requires finite losses, adapters unchanged
    by step 1 (lr 0) and changed by step 3, the base bit-identical, K3, K4
    and K5 launched with K3 = 2 x K4 (each layer's forward runs again under
    checkpointing)."""
    import torch
    from flash_vstream_tpu_torch.train.finetune_flash import run_training
    from flash_vstream_tpu_torch.train.lora import (QWEN_TARGETS,
                                                    init_lora_params)

    cfg = cfg or _qwen_config()
    data = _synthetic_videos(os.path.join(work, "data224"), 6, 224)
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(SEED + 1),
                            params, rank=64, targets=QWEN_TARGETS)
    n_lora = sum(x.numel() for ab in lora.values() for x in ab.values())
    lora0 = {p: {k: x.clone() for k, x in ab.items()}
             for p, ab in lora.items()}
    base0 = _leaf_sums(params)
    steps, prev = [], {}

    def moved(tree):
        return sum(int(not torch.equal(tree[p][k], lora0[p][k]))
                   for p in tree for k in ("a", "b"))

    def on_step(step, trainer, rec):
        now = _launches()
        counts = {k: now[k] - prev.get(k, 0) for k in now}
        prev.update(now)
        steps.append((rec, counts, moved(trainer.params)))
        print(f"train step {step + 1}: loss={rec['loss']:.5f} "
              f"seconds={rec['step_time_s']:.3f} "
              f"tokens_per_s={rec['tokens_per_s']:.1f} lr={rec['lr']:.3e} "
              f"launches K1={counts['K1']} K3={counts['K3']} "
              f"K4={counts['K4']} K5={counts['K5']} "
              f"adapters moved={steps[-1][2]}/{2 * len(lora0)}", flush=True)

    _release(dev)
    _reset_launches()
    t0 = time.perf_counter()
    res = run_training(_train_args(dev, os.path.join(work, "run224"), data,
                                   4096, 3, 2), cfg=cfg, params=params,
                       lora=lora,
                       on_step=on_step)
    total = _launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"train slice: Qwen2-VL-7B LoRA r64 ({n_lora / 1e6:.1f} M adapter "
          f"params), 240 frames 224 px, max_len 4096, grad_accum 2, "
          f"3 steps in {time.perf_counter() - t0:.2f} s; peak memory "
          f"{peak:.2f} GiB; launches K1={total['K1']} K3={total['K3']} "
          f"K4={total['K4']} K5={total['K5']}", flush=True)
    losses = res["losses"]
    if len(losses) != 3 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train slice: losses {losses}")
    if steps[0][2] != 0 or steps[-1][2] == 0:
        raise AssertionError("train slice: adapters moved at step 1 (lr 0) "
                             "or never moved")
    if _leaf_sums(params) != base0:
        raise AssertionError("train slice: the base parameters changed")
    if not (total["K1"] and total["K3"] and total["K4"] and total["K5"]
            and total["K3"] == 2 * total["K4"] == 2 * total["K5"]):
        raise AssertionError(f"train slice: launches {total}")
    return total, data, steps[-1][0]["step_time_s"]


# the production step's peak memory (GiB) with only its own base resident
# and its K3/K4/K5 launches, by base: written by run_production_step
# ("bf16") and finetune_ckpt ("int4")
PRODUCTION_PEAK = {}
PRODUCTION_LAUNCHES = {}


def _step_peak(dev, resident, base):
    """A training run's peak memory in GiB as if only its base were
    resident: the allocator's peak since the last reset, less what was
    resident when the run started (the base and anything an earlier phase
    keeps), plus the base's own bytes."""
    import torch
    return (torch.cuda.max_memory_allocated(dev) - resident
            + _tree_nbytes(base)) / 2**30


def run_production_step(dev, params, work, cfg=None):
    """One optimizer step at the reference's production shape: 448 px,
    240 frames (11,520 visual tokens), max_len 14,000, remat group 4. The
    backward's attention shapes and segment ids are read from the step
    (its first K4 + K5 call) and K4, K5 and SDPA's backward timed there."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    from flash_vstream_tpu_torch.train.finetune_flash import run_training

    data = _synthetic_videos(os.path.join(work, "data448"), 1, 448)
    _release(dev)
    _reset_launches()
    recs, seen = [], {}
    bwd = fa.flash_attention_bwd_cuda

    def observed(q, k, v, o, do, lse, **kw):
        if not seen:
            seen.update(q=q.shape, k=k.shape, kw={
                n: x.clone() if torch.is_tensor(x) else x
                for n, x in kw.items()})
        return bwd(q, k, v, o, do, lse, **kw)

    fa.flash_attention_bwd_cuda = observed
    resident = torch.cuda.memory_allocated(dev)
    try:
        res = run_training(_train_args(dev, os.path.join(work, "run448"),
                                       data, 14000, 1, 1),
                           cfg=cfg or _qwen_config(), params=params,
                           on_step=lambda s, t, r: recs.append(r))
    finally:
        fa.flash_attention_bwd_cuda = bwd
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    PRODUCTION_PEAK["bf16"] = _step_peak(dev, resident, params)
    PRODUCTION_LAUNCHES["bf16"] = k = _launches()
    loss = res["losses"][0]
    print(f"production step: 448 px, 240 frames, max_len 14000, 1 step: "
          f"loss={loss:.5f} seconds={recs[0]['step_time_s']:.3f} "
          f"tokens_per_s={recs[0]['tokens_per_s']:.1f}; peak memory "
          f"{peak:.2f} GiB ({PRODUCTION_PEAK['bf16']:.2f} GiB with the bf16 "
          f"base alone resident); launches K3={k['K3']} K4={k['K4']} "
          f"K5={k['K5']} (remat groups of 4: each layer's forward runs "
          f"again in its group's recompute, and three of a group's four "
          f"once more in their own)", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"production step: loss {loss}")
    del res
    _release(dev)
    time_backward_at(dev, seen["q"], seen["k"], seen["kw"])


def time_backward_at(dev, q_shape, k_shape, kw):
    """K4, K5 and SDPA's backward (dq + dk + dv, causal, no segment mask)
    at the given shapes and keywords, on seeded random bf16 inputs with K3's
    out and lse; the bounds count this run's visible pairs. No plain
    version: its [B, Hq, Sq, Skv] f32 scores do not fit at this length."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, do = (torch.randn(q_shape, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(k_shape, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, out, do, lse, delta,
                                             **kw)
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in (dq, dk, dv)):
        raise AssertionError("backward at the production length: non-finite "
                             "gradients")
    ms, by_rows = _bwd_ms((q, k, v, out, do, lse, delta), kw, iters=3)
    lib = _sdpa_bwd_ms(q, k, v, do)
    pairs = _visible_pairs(q, k, kw.get("causal", False),
                           kw.get("q_segment_ids"), kw.get("kv_segment_ids"))
    D, seg_b = q.shape[-1], 2 * _nbytes(kw.get("q_segment_ids"))
    bounds = (_bound(pairs * 6 * D, _nbytes(q, k, v, out, do, lse, dq, delta)
                     + seg_b),
              _bound(pairs * 8 * D, _nbytes(q, k, v, do, lse, delta, k, v)
                     + seg_b))
    live = int((kw["q_segment_ids"] >= 0).sum()) if kw.get(
        "q_segment_ids") is not None else q.shape[2]
    scratch = _bwd_plan("dkv", q, k).scratch
    for kid, t, (bound, by) in zip(("K4", "K5"), ms, bounds):
        print(f"{kid} at the production length: q{tuple(q.shape)} "
              f"k{tuple(k.shape)} ({live} tokens with a segment id >= 0) "
              f"kernel_ms={t:.4f} bound_ms={bound:.4f} ({by}) "
              f"library_ms={lib:.4f} (SDPA backward, dq+dk+dv, causal only); "
              + by_rows[kid]
              + (f"; scratch {scratch} f32 "
                 f"{math.prod(scratch) * 4 / 2**20:.0f} MiB"
                 if kid == "K5" and scratch else ""), flush=True)


def run_serve4(dev, params, work):
    """The 4-bit base served through the CLI server's entry points at full
    width: `_apply_quantization` with --load-4bit on the slice's bf16 7B
    weights; the int4 and the bf16 decoders' prefill and decode timed in
    turn (bf16, int4, int4, bf16) on one card; the bf16 decoder freed;
    `run_server(args, session=...)`
    over 168 synthetic 224 px frames paced at 8 fps (21 clips of 8, memory
    saturated by the end), questions every 7 s and one after the stream, 32
    new tokens each; K6 must launch 7 times a decoder layer and once (the
    head) per decode step and once per
    answer's prefill, K1 twice per ViT layer per clip and once per decoder
    layer per answer, K2 once per clip, and the server must log no error
    (it logs a failed clip and streams on, as the reference does). Then, on
    the final snapshot, the first question's
    prefill logits and 4 teacher-forced decode steps through K6, K6's plain
    version and the dequantize path (and the plain version with a planted
    scale fault), held to INT4_REF_LIMIT; and the dry-run server once as a
    subprocess on the card."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
    from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_cuda
    from flash_vstream_tpu_torch.models.llm import Qwen2Decoder
    from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    from flash_vstream_tpu_torch.serve.cli_server import (
        _apply_quantization, make_parser, run_server)
    from flash_vstream_tpu_torch.weights.quantize import QuantWeight4

    cfg = VStreamQwenConfig()
    os.makedirs(work, exist_ok=True)
    qfile = os.path.join(work, "questions.txt")
    with open(qfile, "w") as f:
        f.write("\n".join(QUESTIONS) + "\n")
    args = make_parser().parse_args([
        "--device", str(dev), "--load-4bit", "--synthetic-frames", "168",
        "--clip-size", "8", "--frame-size", "224", "--fps", "8",
        "--play_speed", "1", "--questions-file", qfile,
        "--question_interval", "7", "--max-new-tokens", "32",
        "--sync-every-clip", "--output-file",
        os.path.join(work, "serve4.json")])
    bf16_llm = params.pop("llm")
    t0 = time.perf_counter()
    bf16_bytes = _tree_nbytes(bf16_llm)
    embed_bytes = _tree_nbytes(bf16_llm["embed"])
    qparams = _apply_quantization({"vit": params["vit"], "llm": bf16_llm},
                                  args)
    layers = qparams["llm"]["layers"]
    n4 = sum(isinstance(p["w"], QuantWeight4) for grp in ("attn", "mlp")
             for p in layers[grp].values())
    if n4 != 7 or not isinstance(qparams["llm"]["lm_head"], QuantWeight4):
        raise AssertionError(f"serve4: {n4}/7 projections int4")
    int4_bytes = _tree_nbytes(qparams["llm"])
    torch.cuda.synchronize(dev)
    quant_s = time.perf_counter() - t0
    sess = QwenStreamSession(VStreamQwen(cfg, qparams),
                             make_byte_qwen_tokenizer(), frame_hw=(224, 224),
                             clip_size=8, bank_size=1024, max_len=4096)

    # decode is host-bound and its time drifts within a run: time the two
    # decoders in turn on the same synthetic prompt, then free the bf16 one
    decoders = {"bf16": Qwen2Decoder(cfg.llm, bf16_llm), "int4": sess.model.llm}
    timed = {"bf16": [], "int4": []}
    for i, name in enumerate(("bf16", "int4", "int4", "bf16")):
        # one profiled window a decoder (its second pass): a profiler
        # session costs seconds of the script
        timed[name].append(_time_decoder(decoders[name], dev,
                                         profile=i >= 2))
    del decoders, bf16_llm
    _release(dev)
    for name, (a, b) in timed.items():
        print(f"serve4: {name} decoder at S=2989 (bf16, int4, int4, bf16 in "
              f"turn, this card): prefill {a[0]:.1f} {b[0]:.1f} ms, decode "
              f"{a[1]:.2f} {b[1]:.2f} ms/token (32 steps, synchronized); "
              f"profiled decode step (the second pass): device busy "
              f"{b[2]:.2f} ms/token, idle share {1 - b[2] / b[1]:.3f}, "
              f"{b[3]} device events (kernels, copies) per token, K6 "
              f"{b[4]:.2f} ms/token", flush=True)
    print(f"serve4: int4 decode, device busy per token {timed['int4'][1][2]:.2f}"
          f" ms, K6 {timed['int4'][1][4]:.2f} ms of it (K6's previous form "
          f"read 9.8-9.9 busy, K6 4.6 of it; PERF.md)", flush=True)
    print(f"serve4: --load-4bit on the 7B decoder in {quant_s:.2f} s: the "
          f"7 projections of each layer and lm_head int4; decoder tree "
          f"{int4_bytes / 2**30:.3f} GiB against {bf16_bytes / 2**30:.3f} "
          f"GiB bf16, of which the bf16 embed {embed_bytes / 2**30:.3f} GiB "
          f"in both; resident {torch.cuda.memory_allocated(dev) / 2**30:.2f}"
          f" GiB", flush=True)

    errors = []
    catch = logging.Handler(logging.ERROR)
    catch.emit = errors.append
    server_log = logging.getLogger("cli_server")
    server_log.addHandler(catch)
    _reset_launches()
    t0 = time.perf_counter()
    try:
        summary = run_server(args, session=sess)
    finally:
        server_log.removeHandler(catch)
    wall = time.perf_counter() - t0
    k = _launches()
    k6 = int4_matmul_cuda.launches
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    k2 = gather_rows_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    m = summary["metrics"]
    answers = summary["answers"]
    n_tok = round(m["answer_tokens"]["avg"] * m["answer_tokens"]["count"])
    steps = n_tok - len(answers)
    fm = cfg.flash_memory
    n_csm = int(sess.state.tem_valid.sum())
    print(f"serve4: {summary['frames_ingested']} frames in {wall:.2f} s: "
          f"ingest ms/clip mean={m['memory_latency']['avg'] * 1e3:.2f} "
          f"max={m['memory_latency']['max'] * 1e3:.2f} (synchronized); "
          f"CSM={n_csm}/{fm.csm_grid_len} DAM={sess._published[0][2].shape[0]}"
          f"/{fm.dam_grid_len}; {len(answers)} answers at frames "
          f"{[a['frames'] for a in answers]}, answer seconds mean="
          f"{m['conv_latency']['avg']:.3f} max={m['conv_latency']['max']:.3f}"
          f", {n_tok} tokens; peak {peak:.2f} GiB", flush=True)
    clips = 168 // 8
    per = 7 * cfg.llm.num_layers + 1       # 7 projections a layer, lm_head
    want = {"K6": per * steps + len(answers),
            "K1": 2 * cfg.vit.num_layers * clips
            + cfg.llm.num_layers * len(answers),
            "K2": clips}
    got = {"K6": k6, "K1": k["K1"], "K2": k2}
    print(f"serve4: launches K6={k6} ({per} x {steps} decode steps + "
          f"{len(answers)} prefills = {want['K6']}), K1={k['K1']} (2 x "
          f"{cfg.vit.num_layers} ViT layers x {clips} clips + "
          f"{cfg.llm.num_layers} x {len(answers)} prefills = {want['K1']}), "
          f"K2={k2} (one per clip); {m['memory_latency']['count']} clips "
          f"ingested, {len(errors)} errors logged", flush=True)
    if errors:
        raise AssertionError("serve4: the server logged errors: "
                             + "; ".join(r.getMessage() for r in errors))
    if (summary["frames_ingested"] != 168 or not answers
            or m["memory_latency"]["count"] != clips
            or n_csm != fm.csm_grid_len
            or answers[-1]["frames"] != 168):
        raise AssertionError(f"serve4: stream or memory not as expected: "
                             f"{summary['frames_ingested']} frames, "
                             f"{m['memory_latency']['count']} clips, "
                             f"{len(answers)} answers, CSM {n_csm}")
    if got != want:
        raise AssertionError(f"serve4: launches {got}, reckoned {want}")

    # full-width logits: K6 against the dequantize path on the same weights
    snap, n = sess._published
    h = sess._prompt_host(QUESTIONS[0], n)
    embeds, pos, start, seg = sess._prompt_inputs(snap, h)
    toks = [int(t) for t in np.random.default_rng(SEED).integers(
        0, cfg.llm.vocab_size, 4)]
    logits = {}
    for mode in ("kernel", "dequant", "plain", "fault"):
        with _int4_route(mode):
            logits[mode] = int4_logits(sess.generator, embeds, pos, toks, seg,
                                       h["last_real"], start)
    errs = {mode: logit_errors(logits[mode], logits["dequant"])
            for mode in ("kernel", "plain", "fault")}
    kp = max(logit_errors(logits["kernel"], logits["plain"]))
    print(f"serve4: full-width logits (prefill S={h['S']} + 4 teacher-forced "
          f"steps), err/max against the dequantize path: K6 max "
          f"{max(errs['kernel']):.3e} (" + " ".join(
              f"{e:.2e}" for e in errs["kernel"]) + f"), K6's plain version "
          f"{max(errs['plain']):.3e}, planted scale fault "
          f"{max(errs['fault']):.3e}; K6 vs plain {kp:.3e}; limit "
          f"{INT4_REF_LIMIT:.0e}", flush=True)
    if (not torch.isfinite(logits["kernel"]).all()
            or max(errs["kernel"]) > INT4_REF_LIMIT):
        raise AssertionError("serve4: K6 logits off the dequantize path")

    # the entry point itself, on the card, in its own process
    out = os.path.join(work, "dry_run.json")
    proc = subprocess.run(
        [sys.executable, "-m", "flash_vstream_tpu_torch.serve.cli_server",
         "--dry-run", "--load-4bit", "--prewarm", "--synthetic-frames", "8",
         "--play_speed", "0", "--question", "What is happening?",
         "--question_interval", "1000", "--max-new-tokens", "4",
         "--output-file", out],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cli_server --dry-run --load-4bit exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        dry = json.load(f)
    if dry["frames_ingested"] != 8 or len(dry["answers"]) != 1:
        raise AssertionError(f"cli_server --dry-run: {dry}")
    print(f"serve4: python -m flash_vstream_tpu_torch.serve.cli_server "
          f"--dry-run --load-4bit --prewarm on the card: exit 0, "
          f"{dry['frames_ingested']} frames, answer "
          f"{dry['answers'][0]['answer'][:30]!r}", flush=True)
    return k6, k["K1"], k2


def _time_decoder(llm, dev, S=2989, steps=32, cache_dtype=None,
                  profile=True):
    """(prefill ms, decode ms/token, profiled device-busy ms/token, kernel
    launches/token, K6 device ms/token, KV cache bytes) of a decoder on a
    synthetic prompt of S random embeddings (1-D positions, no padding),
    over a bf16 cache or `cache_dtype`'s: host clock around
    synchronized work, after one warm-up prefill and 4 decode steps; then
    torch.profiler over 8 more steps for the device's busy time (kernels
    and copies; one stream, so they do not overlap), the device's activity
    alone (the CPU's adds no device row, and most of a session's seconds in
    key_averages). profile=False leaves the profiler out (a session still
    costs seconds of the script): busy, launches and K6 are then None."""
    import torch
    from torch.autograd import DeviceType
    from flash_vstream_tpu_torch.runtime.generation import Generator
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    embeds = (torch.randn(1, S, llm.cfg.hidden_size, generator=g, device=dev)
              * 0.02).to(torch.bfloat16)
    pos = torch.arange(S, device=dev)[None].expand(3, 1, S)
    gen = Generator(llm, max_len=S + steps + 16,
                    cache_dtype=cache_dtype or torch.bfloat16)
    tok = torch.tensor([1], device=dev)
    for warm in (True, False):
        cache = gen.new_cache(1, S + steps + 16)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gen.prefill(embeds, pos, cache)
        torch.cuda.synchronize(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for i in range(4):
            gen.step(tok, S + i, cache)
        torch.cuda.synchronize(dev)
        if warm:
            continue
        t0 = time.perf_counter()
        for i in range(steps):
            gen.step(tok, S + 4 + i, cache)
        torch.cuda.synchronize(dev)
        decode_ms = (time.perf_counter() - t0) / steps * 1e3
    cache_bytes = _nbytes(cache.k, cache.v, cache.k_scale, cache.v_scale)
    if not profile:
        return prefill_ms, decode_ms, None, None, None, cache_bytes
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            gen.step(tok, S + 4 + steps + i, cache)
        torch.cuda.synchronize(dev)
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e3 / 8
    launches = sum(e.count for e in dev_rows) // 8
    k6 = sum(e.self_device_time_total for e in dev_rows
             if "int4" in e.key) / 1e3 / 8
    return prefill_ms, decode_ms, busy, launches, k6, cache_bytes


def profile_train_step(dev, params, data, work, out_dir, step_s, cfg=None):
    """torch.profiler over the second of two training-slice steps: device
    busy time (the kernels' own time; one stream, so they do not overlap),
    the training spans (forward, its encode / decoder / loss parts,
    backward, optimizer) and the kernels by time, written to out_dir. The
    idle share is taken against the unprofiled step time `step_s` (the
    profiler slows the host several-fold, not the kernels)."""
    from torch.autograd import DeviceType
    from flash_vstream_tpu_torch.train.finetune_flash import run_training

    res = run_training(_train_args(dev, os.path.join(work, "run_prof"), data,
                                   4096, 2, 2,
                                   profile_dir=os.path.join(work, "trace")),
                       cfg=cfg or _qwen_config(), params=params)
    avg = res["profile"].key_averages()
    # device rows are kernels and copies, plus the spans' own device-side
    # annotations (named like the spans), which are left out
    kernels = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("train/")),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    wall = step_s * 1e3
    with open(os.path.join(out_dir, "train_step_profile.txt"), "w") as f:
        f.write(avg.table(sort_by="self_cuda_time_total", row_limit=80))
    print(f"profile: train slice step (grad_accum 2), device busy {busy:.1f} "
          f"ms against {wall:.1f} ms unprofiled: idle share "
          f"{max(0.0, 1 - busy / wall):.3f}; {sum(e.count for e in kernels)} "
          f"kernel launches; table in {out_dir}/train_step_profile.txt",
          flush=True)
    # a span's device time sums the kernels launched inside it from this
    # thread; the backward's kernels launch from autograd's device thread,
    # so they count in the busy time but in no span
    for e in sorted((e for e in avg if e.key.startswith("train/")
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: e.key):
        print(f"profile:   span {e.key:24s} {e.count:3d}x device "
              f"{e.device_time_total / 1e3:9.1f} ms  host "
              f"{e.cpu_time_total / 1e3:9.1f} ms (profiled)", flush=True)
    for e in kernels[:12]:
        print(f"profile:   kernel {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x {e.key[:80]}", flush=True)


def _leaf_sums(tree):
    """Per-tensor (byte sum, version counter) of a tree whose leaves are
    tensors or quantized tuples of tensors. The bytes are summed in
    pieces of 2**27 (a sum into int64 widens its input: 1 GiB at a time,
    not 8 x a 7B leaf)."""
    import torch
    from flash_vstream_tpu_torch.train.checkpoint import flatten_tree
    out = {}
    for p, x in flatten_tree(tree).items():
        b = x.contiguous().view(-1).view(torch.uint8)
        out[p] = (sum(int(c.sum(dtype=torch.int64))
                      for c in b.split(1 << 27)), x._version)
    return out


def _check_export(path, base, lora, alpha, rank):
    """The `--export-merged` file read back through the port's reader and
    held bit for bit to `merge_lora` of `base` and `lora` on the card, one
    adapted leaf merged at a time; the names are the base's, an adapted
    quantized leaf's fields replaced by its one merged tensor. Returns
    (tensors, adapted leaves)."""
    import torch
    from flash_vstream_tpu_torch.train.checkpoint import flatten_tree
    from flash_vstream_tpu_torch.train.lora import merge_lora
    from flash_vstream_tpu_torch.weights.safetensors_io import load_file
    got = load_file(path)
    flat = flatten_tree(base)
    adapted = {p.replace("/", "."): p for p in lora}
    want_names = {n for n in flat
                  if not any(n.startswith(a + ".") for a in adapted)}
    want_names |= set(adapted)
    if set(got) != want_names:
        raise AssertionError(f"finetune_ckpt: the export's names differ "
                             f"from merge_lora's: "
                             f"{sorted(set(got) ^ want_names)[:6]}")
    for name in want_names - set(adapted):
        if got[name].dtype != flat[name].dtype or not torch.equal(
                got[name].to(flat[name].device), flat[name]):
            raise AssertionError(f"finetune_ckpt: exported {name} is not "
                                 f"the base's")
    for name, p in adapted.items():
        with torch.no_grad():
            merged = merge_lora(base, {p: lora[p]}, alpha=alpha, rank=rank)
        for k in p.split("/"):
            merged = merged[k]
        if got[name].dtype != merged.dtype or not torch.equal(
                got[name].to(merged.device), merged):
            raise AssertionError(f"finetune_ckpt: exported {name} is not "
                                 f"merge_lora's")
        del merged
    return len(got), len(adapted)




# finetune_ckpt's bases: name, run_training flags (--int8-base alone is
# int4: --base-bits defaults to 4, as in JAX)
FT_BASES = (("bf16", ()), ("int8", ("--int8-base", "--base-bits", "8")),
            ("int4", ("--int8-base", "--base-bits", "4")))


def run_finetune_ckpt(dev, params, work, root, ckpt):
    """Fine-tuning from a checkpoint directory at full width, through
    `run_training` with `make_parser` flags. 1. Three runs with
    --model-path (the slice's weights as the offline phase's checkpoint,
    `ckpt`, written here when it is not there) of 2 optimizer steps at the
    train slice's shape (224 px, 240 frames, max_len 4,096, grad_accum 1),
    over the bf16 (with --export-merged), the --int8-base --base-bits 8
    and the --int8-base (int4) base. Each run needs finite losses, its
    adapters unchanged by step 1 (lr 0) and moved by step 2 (b moves; a,
    whose gradient is 0 while b is 0, not yet), its base bit-identical to
    the slice's weights quantized as the flags say, K3 = 2 x K4 = 2 x K5
    and K6 never launched (a quantized `dense` under autograd
    dequantizes). The bf16 run's export (16.6 GB) is read back through the
    port's reader and held to `merge_lora` of the run's base and adapters
    on the card, bit for bit. (A QLoRA export is f32 where merged, about
    28 GB at 7B: with the checkpoint it would pass the 45 GiB a card run
    may write; the CPU tests hold it to JAX's.) 2. One int4 step at the
    production shape (448 px, 240 frames, max_len 14,000) with its peak
    memory with only its base resident, beside the bf16 step's (the
    production phase's, or run here). The tokenizer is the byte tokenizer
    handed in: the card's machine has no `transformers` for the
    checkpoint's. Returns the launches of the three runs summed."""
    import torch
    from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_cuda
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.train.finetune_flash import (make_parser,
                                                              run_training)
    from flash_vstream_tpu_torch.train.lora import (QWEN_TARGETS,
                                                    init_lora_params)
    from flash_vstream_tpu_torch.weights.quantize import (quantize_params,
                                                          quantize_params4)

    cfg = _qwen_config()
    tok = make_byte_qwen_tokenizer()
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        _, total, write_s = _write_checkpoint(params, cfg, ckpt, dev)
        print(f"finetune_ckpt: checkpoint of {total / 1e9:.2f} GB written in "
              f"{write_s:.1f} s", flush=True)
    data = _synthetic_videos(os.path.join(work, "data224"), 2, 224)
    quant = {"bf16": lambda t: t, "int8": quantize_params,
             "int4": quantize_params4}
    totals = dict.fromkeys(("K1", "K3", "K4", "K5", "K6"), 0)
    for name, flags in FT_BASES:
        with torch.no_grad():
            want_sums = _leaf_sums(quant[name](params))
        _release(dev)
        _reset_launches()
        out = os.path.join(work, f"ft_{name}")
        argv = ["--model-path", ckpt, "--device", str(dev), "--output-dir",
                out, "--data-path", data, "--video-dir",
                os.path.dirname(data), "--max-steps", "2", "--grad-accum",
                "1", "--max-frames", "240", "--max-len", "4096",
                "--save-steps", "1000", *flags]
        if name == "bf16":
            argv.append("--export-merged")
        args = make_parser().parse_args(argv)
        # run_training's own init (a torch generator seeded 1 on the card,
        # the leaves' logical shapes): the adapters before step 1
        lora0 = init_lora_params(torch.Generator(device=dev).manual_seed(1),
                                 params, rank=args.lora_rank,
                                 targets=QWEN_TARGETS)
        seen = {}

        def on_step(step, trainer, rec):
            seen[step] = (rec, _leaf_sums(trainer.frozen),
                          sum(int(not torch.equal(x, lora0[p][k]))
                              for p, ab in trainer.params.items()
                              for k, x in ab.items()))
            seen["trainer"] = trainer

        t0 = time.perf_counter()
        res = run_training(args, tokenizer=tok, on_step=on_step)
        wall = time.perf_counter() - t0
        k = _launches()
        k["K6"] = int4_matmul_cuda.launches
        for key in totals:
            totals[key] += k[key]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = res["losses"]
        n_leaves = 2 * len(res["lora"])
        base = seen["trainer"].frozen
        base_gib = _tree_nbytes(base) / 2**30
        print(f"finetune_ckpt: --model-path {name} base ({base_gib:.2f} GiB)"
              f": 2 steps of 224 px, 240 frames, max_len 4096 in "
              f"{wall:.1f} s with the load; losses "
              + " ".join(f"{x:.5f}" for x in losses)
              + f"; step seconds " + " ".join(
                  f"{seen[i][0]['step_time_s']:.3f}" for i in (0, 1))
              + f"; adapters moved {seen[0][2]}/{n_leaves} after step 1, "
              f"{seen[1][2]}/{n_leaves} after step 2; peak {peak:.2f} GiB; "
              f"launches K1={k['K1']} K3={k['K3']} K4={k['K4']} "
              f"K5={k['K5']} K6={k['K6']}", flush=True)
        if len(losses) != 2 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"finetune_ckpt {name}: losses {losses}")
        if seen[0][2] != 0 or seen[1][2] == 0:
            raise AssertionError(f"finetune_ckpt {name}: adapters moved "
                                 f"{seen[0][2]} at step 1 (lr 0), "
                                 f"{seen[1][2]} of {n_leaves} at step 2")
        if not (seen[0][1] == seen[1][1] and {
                p: v[0] for p, v in seen[1][1].items()} == {
                p: v[0] for p, v in want_sums.items()}):
            raise AssertionError(f"finetune_ckpt {name}: the base is not "
                                 f"the slice's weights quantized as asked, "
                                 f"or it changed")
        if not (k["K1"] and k["K3"] and k["K3"] == 2 * k["K4"] == 2 * k["K5"]
                and k["K6"] == 0):
            raise AssertionError(f"finetune_ckpt {name}: launches {k}")
        if name == "bf16":
            path = res["merged_path"]
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            n_tensors, n_merged = _check_export(
                path, base, seen["trainer"].params, args.lora_alpha,
                args.lora_rank)
            print(f"finetune_ckpt: --export-merged (bf16 base): "
                  f"{size / 1e9:.2f} GB written in {res['export_s']:.1f} s "
                  f"({size / 1e9 / res['export_s']:.2f} GB/s), {n_tensors} "
                  f"tensors under the base's names ({n_merged} adapted "
                  f"leaves merged), read back by the port's reader and "
                  f"equal bit for bit to merge_lora on the card "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            os.remove(path)
        del res, seen, base
        shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)

    # 2. the int4 step at the production shape, beside the bf16 step's
    if "bf16" not in PRODUCTION_PEAK:
        run_production_step(dev, params, work)
    data448 = _synthetic_videos(os.path.join(work, "data448"), 1, 448)
    with torch.no_grad():
        q4 = quantize_params4(params)
    _release(dev)
    _reset_launches()
    resident = torch.cuda.memory_allocated(dev)
    recs = []
    args = _train_args(dev, os.path.join(work, "run448q"), data448, 14000,
                       1, 1)
    args.int8_base = True                  # --int8-base (int4): q4 as is
    res = run_training(args, cfg=cfg, params=q4,
                       on_step=lambda s, t, r: recs.append(r))
    PRODUCTION_PEAK["int4"] = _step_peak(dev, resident, q4)
    PRODUCTION_LAUNCHES["int4"] = k = _launches()
    k6 = int4_matmul_cuda.launches
    loss = res["losses"][0]
    print(f"finetune_ckpt: production step 448 px, 240 frames, max_len "
          f"14000, int4 base ({_tree_nbytes(q4) / 2**30:.2f} GiB): loss="
          f"{loss:.5f} seconds={recs[0]['step_time_s']:.3f} tokens_per_s="
          f"{recs[0]['tokens_per_s']:.1f}; peak with its base alone resident "
          f"{PRODUCTION_PEAK['int4']:.2f} GiB against the bf16 LoRA step's "
          f"{PRODUCTION_PEAK['bf16']:.2f} GiB (this run); launches K3="
          f"{k['K3']} K4={k['K4']} K5={k['K5']} K6={k6} (the bf16 step's "
          f"K3/K4/K5: {PRODUCTION_LAUNCHES['bf16']['K3']}/"
          f"{PRODUCTION_LAUNCHES['bf16']['K4']}/"
          f"{PRODUCTION_LAUNCHES['bf16']['K5']})", flush=True)
    same = all(k[x] == PRODUCTION_LAUNCHES["bf16"][x]
               for x in ("K3", "K4", "K5"))
    if (not math.isfinite(loss) or k6 or not same
            or not k["K4"] == k["K5"] == cfg.llm.num_layers):
        raise AssertionError(f"finetune_ckpt production: loss {loss}, "
                             f"launches {k} K6={k6}, the bf16 step's "
                             f"{PRODUCTION_LAUNCHES['bf16']}")
    if PRODUCTION_PEAK["int4"] >= PRODUCTION_PEAK["bf16"]:
        raise AssertionError("finetune_ckpt: the int4 production step's "
                             "peak is not below the bf16 step's")
    del res, q4
    _release(dev)
    return totals


# serve_kv8: of the 32 steps of a bf16-cache answer, the int8 cache picks the
# same token in at least this many given the same prefix (the JAX test's
# n - 1 of n, tests/test_generation.py:75-86)
KV8_AGREE = 31


def run_serve_kv8(dev, params, work):
    """The int8 KV cache at full width on the slice's weights. A streaming
    session (224 px, clip 8, bank 1,024) with kv_cache_dtype=torch.int8
    ingests 21 clips (memory saturated) and answers two questions of 32
    greedy tokens; each is held to the same snapshot's answer over a bf16
    cache: given that answer's prefix, the int8 cache picks its token in at
    least 31 of 32 steps (teacher-forced: on random weights, whose logits
    are near-uniform, one flip of a free-running answer changes every
    later step, so the free-running count is printed beside it); its
    preemptible (decode chunks of 8) and speculative (k 4) answers equal
    its greedy ids. In prefill chunks of 512 the prompt attends to its own
    int8 keys (the one-shot prefill to its fresh ones, as in JAX): that
    answer's agreement is printed. The decoder alone is timed over both caches in turn
    (bf16, int8, int8, bf16) with their bytes. Then the CLI server's own
    quantization flags, --load-4bit --kv-int8 (`_apply_quantization`, the
    session as `build_session` makes it), answer on the same snapshot: K6
    launched 7 times a decoder layer and once (the head) a decode step and
    once a prefill. K1 (the ViT, the
    one-shot prefills) and K2 (one a clip) are checked as reckoned; a
    chunked prefill over an int8 cache launches no K1 (its first chunk
    takes the int8 plain path, as in JAX). Returns (K1, K2, K6)."""
    import dataclasses
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
    from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_cuda
    from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    from flash_vstream_tpu_torch.serve.cli_server import (
        _apply_quantization, make_parser)

    cfg = VStreamQwenConfig()
    tok = make_byte_qwen_tokenizer()
    model = VStreamQwen(cfg, params)
    kw = dict(frame_hw=(224, 224), clip_size=8, bank_size=1024, max_len=4096)
    sess = QwenStreamSession(model, tok, kv_cache_dtype=torch.int8, **kw)
    ref = QwenStreamSession(model, tok, **kw)          # bf16 cache
    _release(dev)
    _reset_launches()
    rng = np.random.default_rng(SEED + 8)
    t0 = time.perf_counter()
    for _ in range(N_CLIPS + 1):
        sess.ingest_frames(_frames(rng, 8, (224, 224)))
    sess.block_until_ingested()
    ingest_s = time.perf_counter() - t0
    snap, n = sess._published
    fm = cfg.flash_memory
    if int(sess.state.tem_valid.sum()) != fm.csm_grid_len:
        raise AssertionError("serve_kv8: memory not saturated")
    gen = GenerationConfig(max_new_tokens=32, eos_token_ids=())
    prefills = 0

    def timed(s, q, g):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        ids = s.answer_tokens(snap, n, q, g)
        torch.cuda.synchronize(dev)
        return ids, time.perf_counter() - t

    def forced(q, ids):
        """The int8 cache's greedy pick at each step given the bf16
        answer's prefix (teacher-forced), counted where it is that
        answer's token."""
        h = sess._prompt_host(q, n)
        embeds, pos, start, seg = sess._prompt_inputs(snap, h)
        g = sess.generator
        cache = g.new_cache(1, g._active_len(h["S"], 32))
        picks = [int(g.prefill(embeds, pos, cache, seg,
                               h["last_real"]).argmax())]
        for i, t in enumerate(ids[:-1]):
            picks.append(int(g.step(torch.tensor([t], device=dev),
                                    int(start) + i, cache).argmax()))
        return sum(a == b for a, b in zip(picks, ids))

    for q in QUESTIONS[:2]:
        S = sess._prompt_host(q, n)["S"]
        ids8, s8 = timed(sess, q, gen)
        ids16, s16 = timed(ref, q, gen)
        pre, spre = timed(sess, q, dataclasses.replace(gen,
                                                       preemptible_chunk=8))
        spec, sspec = timed(sess, q, dataclasses.replace(gen,
                                                         speculative_k=4))
        acc = sess.generator.last_spec
        chunked, schunk = timed(sess, q, dataclasses.replace(
            gen, preemptible_chunk=8, prefill_chunk=512))
        tf = forced(q, ids16)
        prefills += 5                      # the chunked prefill: no K1
        agree = sum(a == b for a, b in zip(ids8, ids16))
        print(f"serve_kv8: S={S} 32 greedy tokens over the int8 cache "
              f"{s8:.3f} s, over bf16 {s16:.3f} s; equal {agree}/32 free-"
              f"running, {tf}/32 teacher-forced on the bf16 answer; int8 "
              f"preemptible (decode chunks of 8) {spre:.3f} s, speculative "
              f"(k 4) {sspec:.3f} s ({acc['accepted']}/{acc['drafted']} "
              f"drafts accepted), both equal to greedy: {pre == ids8} "
              f"{spec == ids8}; in prefill chunks of 512 (the prompt's own "
              f"keys int8) {schunk:.3f} s, "
              f"{sum(a == b for a, b in zip(chunked, ids8))}/32 equal to "
              f"greedy", flush=True)
        if len(ids8) != 32 or tf < KV8_AGREE or pre != ids8 or spec != ids8:
            raise AssertionError(f"serve_kv8: int8 {ids8}, bf16 {ids16} "
                                 f"({tf}/32 teacher-forced), preemptible "
                                 f"{pre}, speculative {spec}")
    k = _launches()
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    k2 = gather_rows_cuda.launches
    clips = N_CLIPS + 1
    want = {"K1": 2 * cfg.vit.num_layers * clips
            + cfg.llm.num_layers * prefills, "K2": clips}
    print(f"serve_kv8: {clips} clips ingested in {ingest_s:.2f} s (CSM "
          f"{fm.csm_grid_len}/{fm.csm_grid_len}); launches K1={k['K1']} "
          f"(2 x {cfg.vit.num_layers} x {clips} clips + "
          f"{cfg.llm.num_layers} x {prefills} one-shot prefills = "
          f"{want['K1']}), K2={k2}", flush=True)
    if {"K1": k["K1"], "K2": k2} != want:
        raise AssertionError(f"serve_kv8: launches K1={k['K1']} K2={k2}, "
                             f"reckoned {want}")

    # the decoder alone over both caches, in turn (a chunked prefill and
    # the teacher-forced prefill run K1 on no chunk / every layer: counted
    # above with the one-shot ones)
    times = {"bf16": [], "int8": []}
    for i, name in enumerate(("bf16", "int8", "int8", "bf16")):
        # one profiled window a cache (its second pass): a profiler
        # session costs seconds of the script
        times[name].append(_time_decoder(
            model.llm, dev, cache_dtype=torch.int8 if name == "int8"
            else None, profile=i >= 2))
    for name, (a, b) in times.items():
        print(f"serve_kv8: {name} cache at S=2989 (bf16, int8, int8, bf16 "
              f"in turn): cache {a[5] / 2**20:.1f} MiB, prefill {a[0]:.1f} "
              f"{b[0]:.1f} ms, decode {a[1]:.2f} {b[1]:.2f} ms/token, device"
              f" busy (the second pass profiled) {b[2]:.2f} ms/token, idle "
              f"share {1 - b[2] / b[1]:.3f}, {b[3]} device events per token",
              flush=True)
    ratio = times["int8"][0][5] / times["bf16"][0][5]
    D = cfg.llm.head_dim                   # int8 k, v and two f32 scales
    print(f"serve_kv8: int8 cache bytes / bf16 = {ratio:.4f} "
          f"((2 + 8 / {D}) / 4 = {(2 + 8 / D) / 4:.4f})", flush=True)
    if abs(ratio - (2 + 8 / D) / 4) > 1e-3:
        raise AssertionError(f"serve_kv8: cache bytes ratio {ratio}")

    # --load-4bit --kv-int8: the CLI server's flags on the same weights
    args = make_parser().parse_args(["--device", str(dev), "--load-4bit",
                                     "--kv-int8", "--frame-size", "224",
                                     "--clip-size", "8"])
    qparams = _apply_quantization({"vit": params["vit"],
                                   "llm": params["llm"]}, args)
    qsess = QwenStreamSession(VStreamQwen(cfg, qparams), tok,
                              kv_cache_dtype=(torch.int8 if args.kv_int8
                                              else None), **kw)
    _reset_launches()
    n_tok = 0
    t0 = time.perf_counter()
    for q in QUESTIONS[:2]:
        n_tok += len(qsess.answer_tokens(snap, n, q, gen))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    k6 = int4_matmul_cuda.launches
    steps = n_tok - 2
    per = 7 * cfg.llm.num_layers + 1       # 7 projections a layer, lm_head
    q_time = _time_decoder(qsess.model.llm, dev, cache_dtype=torch.int8)
    print(f"serve_kv8: --load-4bit --kv-int8: 2 answers, {n_tok} tokens in "
          f"{wall:.3f} s; K6={k6} ({per} x {steps} decode steps + 2 "
          f"prefills = {per * steps + 2}); decoder alone at S=2989 over the "
          f"int8 cache: prefill {q_time[0]:.1f} ms, decode {q_time[1]:.2f} "
          f"ms/token, device busy {q_time[2]:.2f}, K6 {q_time[4]:.2f} "
          f"ms/token", flush=True)
    if k6 != per * steps + 2 or n_tok != 64:
        raise AssertionError(f"serve_kv8: K6 launched {k6}, {n_tok} tokens")
    del qsess, qparams, sess, ref, model
    _release(dev)
    return k["K1"], k2, k6


# llava: the LLaVA family at full width (CLIP ViT-L/14, STAR memory, the
# mlp2x_gelu projector, Vicuna-7B) with random bf16 weights
LLAVA_CLIP = 8              # frames a clip
LLAVA_CLIPS = 10            # 80 frames: the 64-frame bank wraps
LLAVA_Q1_AT = 3             # the first question after 24 frames
LLAVA_OFFLINE_FRAMES = 50   # video_max_frames
LLAVA_TOKENS = 32
# card vs CPU, reduced depth: the memory tokens within this share of their
# max (bf16 rounding through two CLIP layers on two devices)
LLAVA_REF_TOL = 5e-2
LLAVA_CKPT_LAYERS = 4       # the checkpoint round trip's decoder depth
LLAVA_PREFILL_CHUNK = 256  # the chunked answer's sequence chunk
LLAVA_SPEC_K = 4            # the speculative answer's drafted tokens
# A prefill in chunks (K1 on the first chunk, the plain cache path's f32
# scores past it) and a speculative verify (k + 1 rows through one
# decode_multi forward) round bf16 in other places than the one-shot
# prefill and single-token steps. Their logits are held to the one-shot
# path's within OFFLINE_LOGIT_TOL of max |logit|, as run_offline holds
# its chunked prefill: the chunked first-token logits against the
# one-shot's, and the verify's at every step of greedy's answer against
# single steps on the same prefix. Where their ids part from greedy's, the
# step they part at must be an exact tie of greedy's own logits (gap 0;
# the lm_head writes bf16), the only deviation accepted.


def _llava_answer_timed(sess, snap, n, q, steps=LLAVA_TOKENS):
    """(greedy ids, prefill ms, decode ms/token, device-busy ms/token) of
    one greedy answer on a snapshot, through the session's prompt and its
    Generator: host clock around the synchronized prefill and decode, then
    torch.profiler over 8 more decode steps for the device's busy time
    (kernels and copies; one stream, so they do not overlap). One one-shot
    prefill and steps + 8 decode steps."""
    import torch
    from torch.autograd import DeviceType
    dev = sess.device
    embeds, pos, start, seg, last = sess._prompt_parts(q, snap, n)
    g = sess.generator
    cache = g.new_cache(1, g._active_len(embeds.shape[1], steps + 8))
    seg = torch.as_tensor(seg, device=dev)[None]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tok = g.prefill(embeds, pos, cache, seg, last).argmax(dim=-1)
    torch.cuda.synchronize(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    ids = [int(tok[0])]
    t0 = time.perf_counter()
    for i in range(steps - 1):
        tok = g.step(tok, start + i, cache).argmax(dim=-1)
        ids.append(int(tok[0]))
    torch.cuda.synchronize(dev)
    decode_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            tok = g.step(tok, start + steps - 1 + i, cache).argmax(dim=-1)
        torch.cuda.synchronize(dev)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / 8
    return ids, prefill_ms, decode_ms, busy


def _llava_forced(sess, snap, n, q, ids):
    """How many of the steps of answer `ids` the session's cache picks
    given that answer's prefix (teacher-forced): one prefill and
    len(ids) - 1 decode steps."""
    import torch
    dev = sess.device
    embeds, pos, start, seg, last = sess._prompt_parts(q, snap, n)
    g = sess.generator
    cache = g.new_cache(1, g._active_len(embeds.shape[1], len(ids)))
    picks = [int(g.prefill(embeds, pos, cache,
                           torch.as_tensor(seg, device=dev)[None],
                           last).argmax())]
    for i, t in enumerate(ids[:-1]):
        picks.append(int(g.step(torch.tensor([t], device=dev), start + i,
                                cache).argmax()))
    return sum(a == b for a, b in zip(picks, ids))


def _llava_logit_checks(sess, snap, n, q, greedy, others):
    """The logits behind the chunked and speculative answers against the
    one-shot path's on greedy's prefix: (chunked first-token error, verify
    error, {kind: (step, gap) or None}). Errors are max |diff| over max
    |logit|; (step, gap) is where `others[kind]` first parts from greedy,
    and greedy's logit there less the other token's, over max |logit|.
    Three prefills: one-shot then single steps on greedy's tokens (their
    argmax must be greedy), one-shot then verifies of LLAVA_SPEC_K + 1 of
    greedy's tokens, and chunked."""
    import torch
    dev = sess.device
    embeds, pos, start, seg, last = sess._prompt_parts(q, snap, n)
    seg = torch.as_tensor(seg, device=dev)[None]
    g, S, T, k = sess.generator, embeds.shape[1], len(greedy), LLAVA_SPEC_K
    cache = g.new_cache(1, g._active_len(S, T))
    steps = [g.prefill(embeds, pos, cache, seg, last)[0]]
    for j in range(T - 1):
        steps.append(g.step(torch.tensor([greedy[j]], device=dev), start + j,
                            cache)[0])
    steps = torch.stack(steps).float()               # [T, V]: token j's
    if steps.argmax(dim=-1).tolist() != greedy:
        raise AssertionError("llava: single steps on greedy's prefix do "
                             "not give greedy's ids")
    cache = g.new_cache(1, g._active_len(S, T + k))
    ver = [g.prefill(embeds, pos, cache, seg, last)[0]]
    for j in range(0, T - 1, k + 1):
        ver.extend(g.verify(torch.tensor(greedy[j:j + k + 1], device=dev)
                            [None], start + j, cache)[0])
    ver = torch.stack(ver[:T]).float()
    cache = g.new_cache(1, g._active_len(S, 1))
    chunked = g._prefill_chunked(embeds, pos, cache, seg, last,
                                 LLAVA_PREFILL_CHUNK)[0].float()
    chunk_err = ((chunked - steps[0]).abs().max()
                 / steps[0].abs().max()).item()
    ver_err = ((ver - steps).abs().max() / steps.abs().max()).item()
    ties = {}
    for kind, other in others.items():
        i = next((j for j, (a, b) in enumerate(zip(greedy, other))
                  if a != b), None)
        ties[kind] = None if i is None else (i, (
            (steps[i, greedy[i]] - steps[i, other[i]])
            / steps[i].abs().max()).item())
    return chunk_err, ver_err, ties


def run_llava(dev, smi, root):
    """The LLaVA family's serving path at full width on random bf16
    weights (VStreamLLaVAConfig(): CLIP ViT-L/14 at 224 px, 23 of its 24
    layers run, STAR memory of 25 Turing, 25 long and 3 key frames over a
    64-frame ring bank, mlp2x_gelu, Vicuna-7B):
    1. LLaVAStreamSession, clips of 8, 80 frames of 8 scenes (the bank
       wraps): ingest ms a clip; a question of 32 greedy tokens after 24
       frames (before saturation: padded memory slots) and one after the
       wrap, each timed (prefill, ms/token, device busy); answer_stream's
       deltas joined = the answer; preemptible (decode chunks of 8),
       prefill-chunked (chunks of 256) and speculative (k 4) ids = greedy,
       their logits within OFFLINE_LOGIT_TOL of the one-shot path's
       (chunked first token; the verify at every step on greedy's
       prefix), ids parting from greedy only at an exact tie of greedy's
       logits; an int8 KV cache picks the bf16 answer's token in at least
       KV8_AGREE of 32 teacher-forced steps;
    2. LLaVAPipeline: a 50-frame video (encode, consolidate, prefill and
       decode timed; the pipeline's own answer = the timed steps' ids) and
       one 336 x 448 image;
    3. the config cut to 2 CLIP and 2 decoder layers (full widths): one
       clip and an answer on the card and on the CPU (plain versions) from
       the same bf16 weights and draws; the memory tokens within
       LLAVA_REF_TOL of their max, the greedy ids equal (the CPU answering
       on the card's snapshot);
    4. `run_server --model-family llava --load-4bit` over a session on
       the weights quantized by `_apply_quantization`: K6 at 225 calls a
       decode step and 1 a prefill, the decoder's ms/token and busy time;
       K6 at Vicuna's shapes beside `_weight_int4pack_mm`;
    5. a checkpoint at decoder depth LLAVA_CKPT_LAYERS (every other width
       full): export_llava_checkpoint -> save_hf_checkpoint ->
       load_llava_checkpoint, every leaf bit-equal, write and load GB/s;
       deleted after;
    6. K1's launches (23 a CLIP call, 32 a one-shot prefill or a chunked
       prefill's first chunk; the reduced model's 2 and 2) and K6's,
       reckoned as the steps run, against the counters. Returns (K1, K6)."""
    import dataclasses
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamLLaVAConfig
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_cuda
    from flash_vstream_tpu_torch.models.clip_vit import clip_layers_run
    from flash_vstream_tpu_torch.models.vstream_llava import (
        build_multimodal_embeds, consolidate, init_llava_params,
        star_valid_counts)
    from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    from flash_vstream_tpu_torch.models.layers import layer_slice
    from flash_vstream_tpu_torch.runtime.pipeline import (LLaVAPipeline,
                                                          _bucket,
                                                          llava_prompt,
                                                          seeded_draws)
    from flash_vstream_tpu_torch.runtime.streaming import LLaVAStreamSession
    from flash_vstream_tpu_torch.serve.cli_server import (
        _apply_quantization, make_parser, run_server)
    from flash_vstream_tpu_torch.weights.convert import load_llava_checkpoint
    from flash_vstream_tpu_torch.weights.export import (
        export_llava_checkpoint, save_hf_checkpoint)

    t_phase = time.perf_counter()
    cfg = VStreamLLaVAConfig()
    tok = ByteTokenizer()
    n_clip = clip_layers_run(cfg.vit)                 # 23
    L = cfg.llm.num_layers                            # 32
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 11), dev, dtype=torch.bfloat16)
    torch.cuda.synchronize(dev)
    print(f"llava: {smi}: VStreamLLaVAConfig() with random bf16 weights, "
          f"{_tree_nbytes(params) / 1e9:.2f} GB (CLIP "
          f"{_tree_nbytes(params['vit']) / 1e9:.2f} GB)", flush=True)
    _reset_launches()
    want = {"K1": 0, "K6": 0}
    gen = GenerationConfig(max_new_tokens=LLAVA_TOKENS, eos_token_ids=())

    # --- 1. streaming ---
    sess = LLaVAStreamSession(params, cfg, tok, clip_size=LLAVA_CLIP,
                              max_len=4096)
    rng = np.random.default_rng(SEED + 11)
    frames = _offline_frames(rng, LLAVA_CLIP * LLAVA_CLIPS, 224)
    order = rng.permutation(len(frames))       # scenes recur over the stream
    frames = [frames[i] for i in order]
    clip_ms, snaps = [], {}
    for c in range(LLAVA_CLIPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sess.ingest_frames(frames[c * LLAVA_CLIP:(c + 1) * LLAVA_CLIP])
        sess.block_until_ingested()
        clip_ms.append((time.perf_counter() - t0) * 1e3)
        want["K1"] += n_clip
        if c + 1 in (LLAVA_Q1_AT, LLAVA_CLIPS):
            snaps[c + 1] = sess._published
    st = sess.state
    print(f"llava stream: {LLAVA_CLIPS} clips of {LLAVA_CLIP} frames at 224 "
          f"px, ingest ms a clip (host clock around a synchronized ingest) "
          f"first {clip_ms[0]:.1f}, then mean {np.mean(clip_ms[1:]):.1f} "
          f"min {min(clip_ms[1:]):.1f} max {max(clip_ms[1:]):.1f}; frames "
          f"{sess.n_frames}, bank positions {int(st.bank_pos.min())}.."
          f"{int(st.bank_pos.max())} of {cfg.star.max_frames_static} slots, "
          f"long {int(st.long_valid.sum())}/{cfg.star.long_length}, Turing "
          f"{int(st.turing_valid.sum())}/{cfg.star.turing_length}",
          flush=True)
    if (int(st.bank_pos.min()) != sess.n_frames - cfg.star.max_frames_static
            or not bool(st.long_valid.all())):
        raise AssertionError("llava: the bank did not wrap or the memory "
                             "is not saturated")
    for at, (snap, n) in snaps.items():
        q = QUESTIONS[0] if at == LLAVA_Q1_AT else QUESTIONS[1]
        real = sum(star_valid_counts(cfg, n, streaming=True))
        n_mem = sess._bucket_n_mem(real)
        ids, pre_ms, dec_ms, busy = _llava_answer_timed(sess, snap, n, q)
        want["K1"] += L
        greedy = sess.answer_tokens(snap, n, q, gen)
        want["K1"] += L
        sess._published = (snap, n)
        text = sess.answer(q, gen)
        want["K1"] += L
        deltas = list(sess.answer_stream(q, gen))
        want["K1"] += L
        kinds = {}
        for name, kw in (("preemptible", dict(preemptible_chunk=8)),
                         ("prefill_chunks", dict(
                             preemptible_chunk=8,
                             prefill_chunk=LLAVA_PREFILL_CHUNK)),
                         ("speculative", dict(speculative_k=LLAVA_SPEC_K))):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            kinds[name] = sess.answer_tokens(snap, n, q, dataclasses.replace(
                gen, **kw))
            torch.cuda.synchronize(dev)
            kinds[name] = (kinds[name], time.perf_counter() - t0)
            want["K1"] += L                   # one-shot, or the first chunk
        chunk_err, ver_err, ties = _llava_logit_checks(
            sess, snap, n, q, greedy, {k: v[0] for k, v in kinds.items()})
        want["K1"] += 3 * L          # two one-shot prefills, a first chunk
        S = sess._prompt_parts(q, snap, n)[0].shape[1]
        print(f"llava answer after {n} frames: memory {real} real tokens in "
              f"a bucket of {n_mem} ({n_mem - real} padded slots at segment "
              f"-1), S={S}; prefill {pre_ms:.1f} ms, decode {dec_ms:.2f} "
              f"ms/token, device busy {busy:.2f} ms/token (idle share "
              f"{1 - busy / dec_ms:.3f}); {LLAVA_TOKENS} greedy ids equal to "
              f"the timed ones: {greedy == ids}; answer_stream deltas joined "
              f"= answer: {''.join(deltas) == text}; "
              + "; ".join(f"{k} {v[1]:.3f} s = greedy: {v[0] == greedy}"
                          + ("" if ties[k] is None else
                             f" (parts at step {ties[k][0]}, greedy's "
                             f"logits {ties[k][1]:.2e} of max apart there, "
                             f"an exact tie: {ties[k][1] == 0.0})")
                          for k, v in kinds.items())
              + f"; logits against the one-shot path's: chunked first "
              f"token {chunk_err:.3e}, verify over {LLAVA_TOKENS} steps "
              f"{ver_err:.3e} of max |logit| (limit "
              f"{OFFLINE_LOGIT_TOL:.0e})", flush=True)
        if (greedy != ids or len(greedy) != LLAVA_TOKENS
                or "".join(deltas) != text
                or kinds["preemptible"][0] != greedy
                or any(t is not None and t[1] != 0.0
                       for t in ties.values())
                or chunk_err > OFFLINE_LOGIT_TOL
                or ver_err > OFFLINE_LOGIT_TOL):
            raise AssertionError(f"llava: answers after {n} frames differ: "
                                 f"greedy {greedy}, timed {ids}, "
                                 f"{ {k: v[0] for k, v in kinds.items()} },"
                                 f" ties {ties}, logits chunked "
                                 f"{chunk_err}, verify {ver_err}")
        if at == LLAVA_Q1_AT and n_mem == real:
            raise AssertionError("llava: the first answer has no padding")
    # the int8 KV cache on the last snapshot
    sess8 = LLaVAStreamSession(params, cfg, tok, clip_size=LLAVA_CLIP,
                               max_len=4096, kv_cache_dtype=torch.int8)
    snap, n = snaps[LLAVA_CLIPS]
    ids16 = sess.answer_tokens(snap, n, QUESTIONS[1], gen)
    ids8 = sess8.answer_tokens(snap, n, QUESTIONS[1], gen)
    tf = _llava_forced(sess8, snap, n, QUESTIONS[1], ids16)
    want["K1"] += 3 * L                        # int8: its prefill is one-shot
    print(f"llava int8 KV cache: {sum(a == b for a, b in zip(ids8, ids16))}"
          f"/{LLAVA_TOKENS} free-running, {tf}/{LLAVA_TOKENS} teacher-forced "
          f"on the bf16 answer (limit {KV8_AGREE})", flush=True)
    if tf < KV8_AGREE:
        raise AssertionError(f"llava: int8 cache {tf}/32 teacher-forced")
    del sess8

    # --- 2. offline ---
    pipe = LLaVAPipeline(params, cfg, tok, max_len=4096)
    vid = _offline_frames(rng, LLAVA_OFFLINE_FRAMES, 224)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        times[name] = time.perf_counter() - t0
        return out
    feats = timed("encode", lambda: pipe.encode_video(vid))
    want["K1"] += n_clip
    T = feats.shape[0]
    padded = torch.cat([feats, feats.new_zeros(_bucket(T) - T,
                                               *feats.shape[1:])])
    mem = timed("consolidate", lambda: consolidate(
        params, cfg, padded, T, seeded_draws(SEED, dev)))
    ids_in = llava_prompt(QUESTIONS[2], tok)[1]
    embeds, pos = build_multimodal_embeds(params, cfg, ids_in, mem, T)
    g = pipe.generator
    cache = g.new_cache(1, g._active_len(embeds.shape[1], LLAVA_TOKENS))
    first = timed("prefill", lambda: g.prefill(embeds, pos, cache)
                  .argmax(dim=-1))
    want["K1"] += L

    def decode():
        t, out = first, [int(first[0])]
        for i in range(LLAVA_TOKENS - 1):
            t = g.step(t, embeds.shape[1] + i, cache).argmax(dim=-1)
            out.append(int(t[0]))
        return out
    manual = timed("decode", decode)
    whole = timed("answer", lambda: pipe.answer_tokens(
        vid, QUESTIONS[2], gen, seed=SEED))
    want["K1"] += n_clip + L
    image = _offline_frames(rng, 1, 448)[0][:336]          # 336 x 448
    img_ids = timed("image", lambda: pipe.answer_image_tokens(
        image, QUESTIONS[2], gen))
    want["K1"] += n_clip + L
    print(f"llava offline: {T} frames of 224 px, memory "
          f"{sum(star_valid_counts(cfg, T))} tokens, S={embeds.shape[1]}: "
          f"encode {times['encode']:.3f} s, consolidate "
          f"{times['consolidate']:.3f} s, prefill {times['prefill']:.3f} s, "
          f"decode {times['decode']:.3f} s ({LLAVA_TOKENS} tokens), the "
          f"pipeline's answer {times['answer']:.3f} s, its ids = the timed "
          f"steps': {whole == manual}; image 336 x 448 (padded to a square, "
          f"224 px, 256 patch tokens): {times['image']:.3f} s, "
          f"{len(img_ids)} ids", flush=True)
    if whole != manual or len(img_ids) != LLAVA_TOKENS:
        raise AssertionError(f"llava offline: {whole} / {manual}, image "
                             f"{len(img_ids)} ids")
    del pipe, cache, mem, feats, padded

    # --- 3. card vs CPU at reduced depth ---
    rcfg = cfg.replace(vit=dataclasses.replace(cfg.vit, num_layers=3),
                       llm=dataclasses.replace(cfg.llm, num_layers=2))
    rparams = init_llava_params(rcfg, torch.Generator(device=dev).manual_seed(
        SEED + 12), dev, dtype=torch.bfloat16)
    cparams = _tree_to(rparams, "cpu")
    card = LLaVAStreamSession(rparams, rcfg, tok, clip_size=LLAVA_CLIP,
                              max_len=2048)
    cpu = LLaVAStreamSession(cparams, rcfg, tok, clip_size=LLAVA_CLIP,
                             max_len=2048)
    cpu._uniforms = lambda step, n: card._uniforms(step, n).cpu()
    clip = frames[:LLAVA_CLIP]
    t0 = time.perf_counter()
    card.ingest_frames(clip)
    cpu.ingest_frames(clip)
    want["K1"] += clip_layers_run(rcfg.vit)
    gsnap, n = card._published
    csnap = cpu._published[0]
    if not torch.equal(gsnap.valid.cpu(), csnap.valid):
        raise AssertionError("llava reference: validity differs")
    scale = csnap.tokens.abs().max().item()
    err = (gsnap.tokens.cpu() - csnap.tokens).abs().max().item()
    rgen = dataclasses.replace(gen, max_new_tokens=8)
    gids = card.answer_tokens(gsnap, n, QUESTIONS[0], rgen)
    want["K1"] += rcfg.llm.num_layers
    from flash_vstream_tpu_torch.models.star_memory import STARMemory
    cids = cpu.answer_tokens(STARMemory(*(x.cpu() for x in gsnap)), n,
                             QUESTIONS[0], rgen)
    print(f"llava reference: 2 CLIP + 2 decoder layers at full width, one "
          f"clip, card vs CPU plain ({time.perf_counter() - t0:.1f} s): "
          f"memory tokens max diff {err:.3e} of max {scale:.3e} (limit "
          f"{LLAVA_REF_TOL:.0e} of max), 8 greedy ids equal: {gids == cids}",
          flush=True)
    if err > LLAVA_REF_TOL * scale or gids != cids:
        raise AssertionError(f"llava reference: err {err} of {scale}, ids "
                             f"{gids} / {cids}")
    del card, cpu, rparams, cparams

    # --- 4. --load-4bit through the CLI server ---
    args = make_parser().parse_args([
        "--model-family", "llava", "--device", str(dev), "--load-4bit",
        "--synthetic-frames", "16", "--clip-size", str(LLAVA_CLIP),
        "--frame-size", "224", "--play_speed", "0", "--question",
        QUESTIONS[0], "--question_interval", "1000", "--max-new-tokens",
        str(LLAVA_TOKENS)])
    qparams = _apply_quantization(dict(params), args)
    qsess = LLaVAStreamSession(qparams, cfg, tok, clip_size=LLAVA_CLIP,
                               max_len=4096)
    k6_0 = int4_matmul_cuda.launches
    summary = run_server(args, session=qsess)
    n_tok = int(qsess.metrics.get("answer_tokens").sum)
    per = 7 * L + 1
    want["K1"] += 2 * n_clip + L
    want["K6"] += per * (n_tok - 1) + 1
    k6_serve = int4_matmul_cuda.launches - k6_0
    ids4, pre4, dec4, busy4 = _llava_answer_timed(
        qsess, *qsess._published, QUESTIONS[0])
    want["K1"] += L
    want["K6"] += 1 + per * (LLAVA_TOKENS - 1 + 8)
    print(f"llava --load-4bit: run_server answered {len(summary['answers'])}"
          f" question(s) after {summary['frames_ingested']} frames, "
          f"{n_tok} tokens; K6={k6_serve} ({per} x {n_tok - 1} decode steps "
          f"+ 1 prefill = {per * (n_tok - 1) + 1}); the int4 decoder: "
          f"prefill {pre4:.1f} ms, decode {dec4:.2f} ms/token, device busy "
          f"{busy4:.2f} ms/token", flush=True)
    if k6_serve != per * (n_tok - 1) + 1 or n_tok != LLAVA_TOKENS:
        raise AssertionError(f"llava --load-4bit: K6 {k6_serve}, {n_tok} "
                             f"tokens")
    del qsess, qparams
    _release(dev)

    # --- 6. launch counts (the kernel checks below launch outside it) ---
    k1 = flash_attention_cuda.launches
    k6 = int4_matmul_cuda.launches
    print(f"llava launches: K1={k1} K6={k6}, reckoned K1={want['K1']} "
          f"({n_clip} a CLIP call, {L} a one-shot prefill or a chunked "
          f"prefill's first chunk, 2 and 2 at reduced depth), "
          f"K6={want['K6']} ({per} a decode step, 1 a prefill)", flush=True)
    if {"K1": k1, "K6": k6} != want:
        raise AssertionError(f"llava: launches K1={k1} K6={k6}, reckoned "
                             f"{want}")
    check_int4_kernel(dev, shapes=K6_VICUNA_SHAPES, multi_b=(),
                      model="vicuna", check_build=False)

    # --- 5. checkpoint round trip at reduced decoder depth ---
    ccfg = cfg.replace(llm=dataclasses.replace(cfg.llm,
                                               num_layers=LLAVA_CKPT_LAYERS))
    cut = dict(params, llm=dict(params["llm"], layers=layer_slice(
        params["llm"]["layers"], slice(0, LLAVA_CKPT_LAYERS))))
    ckpt = os.path.join(root, "build", "llava_ckpt")
    try:
        sd = export_llava_checkpoint(cut, ccfg)
        nbytes = _nbytes(*sd.values())
        t0 = time.perf_counter()
        names = save_hf_checkpoint(ckpt, sd, max_shard_bytes=OFFLINE_SHARD)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_llava_checkpoint(ckpt, ccfg, dtype=torch.bfloat16,
                                     device=dev)
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        pairs = list(_leaf_pairs(cut, back))
        equal = all(x.dtype == y.dtype and torch.equal(x, y)
                    for _, x, y in pairs)
        print(f"llava checkpoint: decoder depth {LLAVA_CKPT_LAYERS} of {L}, "
              f"every width full: {nbytes / 1e9:.2f} GB in {len(names)} "
              f"shard(s), write {write_s:.2f} s ({nbytes / 1e9 / write_s:.2f}"
              f" GB/s), load {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} "
              f"GB/s), {len(pairs)} leaves bit-equal: {equal}", flush=True)
        if not equal:
            raise AssertionError("llava checkpoint: leaves differ")
        del back, sd
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del cut, sess
    _release(dev)
    print(f"llava: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1, k6, params


# The multistream phase: QwenMultiStreamEngine (8 streams, the 7B config),
# MultiStreamEngine (4 LLaVA streams), --threaded-ingest and the Flash
# memory registry, card against CPU
MS_STREAMS = 8               # BASELINE config #5: 8 concurrent streams
MS_CLIP = 8
MS_BANK = 256                # the JAX engine's default bank
MS_TICKS = 16                # after one warm-up tick: 64 frame pairs a stream
MS_TOKENS = 32
MS_SOLO = (0, 7)             # streams held to a solo session
MS_LLAVA_STREAMS = 4
MS_LLAVA_TICKS = 10          # 80 frames a stream: the 64-frame bank wraps
THREADED_FRAMES = 120        # --threaded-ingest: 30 fps in clips of 8
REGISTRY_METHODS = ("kmeans_ordered", "pca_kmeans_ordered", "merge", "drop",
                    "attention", "sample", "dbscan", "gmm")
REGISTRY_TOL = 1e-4          # card vs CPU, of the features' max


def _ms_questions(n):
    return [f"{QUESTIONS[i % len(QUESTIONS)]} (stream {i})" for i in range(n)]


def _teacher_forced(gen, embeds, pos, seg, last, start, ids, profile=False):
    """Logits [B, T, V] f32 of a prefill and T - 1 decode steps fed `ids`
    [B][T] (each row its own decode start `start[b]`), with the host ms a
    decode step and, with `profile`, the device-busy ms a step (profiled
    over the last 8; else 0)."""
    import torch
    from torch.autograd import DeviceType
    dev = embeds.device
    B, T = len(ids), len(ids[0])
    torch.set_grad_enabled(False)
    cache = gen.new_cache(B, gen._active_len(embeds.shape[1], T))
    out = [gen.prefill(embeds, pos, cache, seg, last).float()]
    pos0 = torch.as_tensor(start, device=dev).reshape(B)
    tok = torch.tensor(ids, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for j in range(T - 9):
        out.append(gen.step(tok[:, j], pos0 + j, cache).float())
    torch.cuda.synchronize(dev)
    host = (time.perf_counter() - t0) / (T - 9)
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA]) if profile
        else contextlib.nullcontext())
    with prof:
        for j in range(T - 9, T - 1):
            out.append(gen.step(tok[:, j], pos0 + j, cache).float())
        torch.cuda.synchronize(dev)
    busy = (sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e3 / 8
            if profile else 0.0)
    torch.set_grad_enabled(True)
    return torch.stack(out, dim=1), host * 1e3, busy


def _bf16_step(x):
    """One bf16 step (ulp) at the magnitude of x: the lm_head writes bf16
    logits, so two that differ by this are neighbours."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _batched_rule(name, single_ids, single_logits, batch_ids, batch_logits):
    """The batched answers against the per-stream ones. The batched logits
    (teacher-forced on the per-stream ids) lie within OFFLINE_LOGIT_TOL of
    max |logit| at every step. A batched id may part from the per-stream
    one at an exact tie of the per-stream logits (gap 0), or at a gap of
    one bf16 step of max |logit| with a witness: the batched path's own
    teacher-forced logits at that step (the same prefix) rank the batched
    id at or above the per-stream one, so the parting follows from the
    batch's logits, which the tolerance bounds, and not from the decode
    loop. Returns (worst error over max, [(stream, step, gap in bf16
    steps, shift in bf16 steps)] of the partings, (median, max) of the
    shift elsewhere). A shift is how far the per-stream top-two gap moves
    on the batched path: the rounding that separates the two paths."""
    import numpy as np
    worst, parts, shifts = 0.0, [], []
    for s, (ids, lg, blg) in enumerate(zip(single_ids, single_logits,
                                           batch_logits)):
        if lg.argmax(dim=-1).tolist() != list(ids):
            raise AssertionError(f"{name}: stream {s}'s teacher-forced "
                                 f"steps do not give its own answer")
        worst = max(worst, ((blg - lg).abs().max()
                            / lg.abs().max()).item())
    if worst > OFFLINE_LOGIT_TOL:
        raise AssertionError(f"{name}: batched logits {worst:.3e} of max "
                             f"from the per-stream ones (limit "
                             f"{OFFLINE_LOGIT_TOL})")
    for s, (ids, lg, blg, bids) in enumerate(zip(
            single_ids, single_logits, batch_logits, batch_ids)):
        i = next((j for j, (a, b) in enumerate(zip(ids, bids)) if a != b),
                 None)
        for j in range(lg.shape[0]):
            step = _bf16_step(lg[j].abs().max().item())
            if j == i:
                a, b = ids[i], bids[i]
            else:
                a, b = lg[j].topk(2).indices.tolist()
            shift = ((lg[j, a] - lg[j, b]) - (blg[j, a] - blg[j, b])).item()
            if j != i:
                shifts.append(abs(shift) / step)
                continue
            gap = (lg[i, a] - lg[i, b]).item()
            if gap > step:
                raise AssertionError(f"{name}: stream {s} parts from its own "
                                     f"answer at step {i}, its logits {gap} "
                                     f"apart there (more than one bf16 step, "
                                     f"{step})")
            if gap > 0 and blg[i, b] < blg[i, a]:
                raise AssertionError(f"{name}: stream {s} parts at step {i} "
                                     f"one bf16 step from a tie, but the "
                                     f"batched logits there rank its "
                                     f"per-stream token first")
            parts.append((s, i, gap / step, round(shift / step, 3)))
    return worst, parts, (float(np.median(shifts)), max(shifts))


def _check_solo(name, got, want, state):
    """A stream's snapshot against a solo session's: CSM positions equal,
    DAM positions equal but at an exact tie (`_dam_tie`, the solo state),
    features within 5e-2. Returns (worst feature diff, ties)."""
    import torch
    spa_pos, tem_pos, spa_x, tem_x = (x.float() for x in got)
    wpos, wtem, wx, wtx = (x.float() for x in want)
    if not torch.equal(tem_pos, wtem):
        raise AssertionError(f"{name}: CSM positions differ")
    worst = (tem_x - wtx).abs().max().item()
    ties = 0
    for j in range(spa_pos.shape[0]):
        if spa_pos[j] == wpos[j]:
            worst = max(worst, (spa_x[j] - wx[j]).abs().max().item())
        elif _dam_tie(state, spa_pos.shape[0], j, int(spa_pos[j]),
                      int(wpos[j])):
            ties += 1
        else:
            raise AssertionError(f"{name}: DAM slot {j} frame "
                                 f"{int(spa_pos[j])} against "
                                 f"{int(wpos[j])}, not a tie")
    if worst > 5e-2:
        raise AssertionError(f"{name}: features differ by {worst}")
    return worst, ties


def run_multistream_qwen(dev, smi, params):
    """QwenMultiStreamEngine at BASELINE config #5: 8 streams of 224 px
    over the 7B config (VStreamQwenConfig(), random bf16 weights), clip 8,
    bank 256; one warm-up tick and 16 timed ticks (64 frame pairs a
    stream: the 60 CSM slots saturate), then a ragged tick of 0-7 frames.
    Streams 0 and 7 are held to solo QwenStreamSessions fed the same
    frames and draws; K1 = 64 and K2 = 1 a tick, checked; `answer_all` of 8
    questions (32 tokens) against the per-stream answers by the logit rule
    (`_batched_rule`), 28 K1 a batched prefill; a control, two streams'
    prompts swapped in the batch, must fail that rule. Returns (K1, K2) of
    the engine's own run (its ticks and `answer_all`), without the solo
    sessions, the per-stream reference answers and the logit checks."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.models.vstream_qwen import (VStreamQwen,
                                                             init_qwen_params)
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    from flash_vstream_tpu_torch.runtime.streaming import (
        QwenMultiStreamEngine, QwenStreamSession, _stream_view)

    cfg = VStreamQwenConfig()
    if params is None:
        params = init_qwen_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), device=dev, dtype=torch.bfloat16)
    model = VStreamQwen(cfg, params)
    tok = make_byte_qwen_tokenizer()
    N = MS_STREAMS
    eng = QwenMultiStreamEngine(model, tok, N, frame_hw=(224, 224),
                                clip_size=MS_CLIP, bank_size=MS_BANK,
                                max_len=4096)
    solo = {}
    for s in MS_SOLO:
        sess = QwenStreamSession(model, tok, frame_hw=(224, 224),
                                 clip_size=MS_CLIP, bank_size=MS_BANK,
                                 max_len=4096)
        sess._init_scores = lambda step, n, s=s: eng.draws(step, s, n)
        solo[s] = sess
    banks = _nbytes(eng.states.bank, eng.states.bank_small)
    n_frames = MS_CLIP * (1 + MS_TICKS)
    frames = [_offline_frames(np.random.default_rng(SEED + 100 + s),
                              n_frames + MS_CLIP, 224) for s in range(N)]
    ticks = [[f[k * MS_CLIP:(k + 1) * MS_CLIP] for f in frames]
             for k in range(1 + MS_TICKS)]
    ticks.append([f[n_frames:n_frames + s] for s, f in enumerate(frames)])
    k1 = k2 = 0
    tick_ms, solo_ms = [], []
    worst, ties = 0.0, 0
    for k, clips in enumerate(ticks):
        before = eng._published[0]
        a1, a2 = flash_attention_cuda.launches, gather_rows_cuda.launches
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eng.ingest(clips)
        eng.block()
        dt = (time.perf_counter() - t0) * 1e3
        d1 = flash_attention_cuda.launches - a1
        d2 = gather_rows_cuda.launches - a2
        if (d1, d2) != (2 * cfg.vit.num_layers, 1):
            raise AssertionError(f"multistream: tick {k} launched K1 {d1}, "
                                 f"K2 {d2}; reckoned 64, 1")
        k1, k2 = k1 + d1, k2 + d2
        if 0 < k <= MS_TICKS:
            tick_ms.append(dt)
        for s, sess in solo.items():
            if not clips[s]:          # an empty clip: the stream keeps its
                w, t = _check_solo(   # frames and its snapshot's positions
                    f"multistream: tick {k} stream {s} (empty clip)",
                    eng._published[0][s], before[s], sess.state)
            else:
                t0 = time.perf_counter()
                sess.ingest_frames(clips[s])
                sess.block_until_ingested()
                if 0 < k <= MS_TICKS and s == MS_SOLO[0]:
                    solo_ms.append((time.perf_counter() - t0) * 1e3)
                w, t = _check_solo(f"multistream: tick {k} stream {s}",
                                   eng._published[0][s], sess._published[0],
                                   sess.state)
            worst, ties = max(worst, w), ties + t
    counts = eng.n_frames
    want = [4 * (1 + MS_TICKS) + -(-s // 2) for s in range(N)]
    if list(counts) != want or counts[MS_SOLO[1]] != solo[MS_SOLO[1]].n_frames:
        raise AssertionError(f"multistream: frame pairs {counts}, want {want}")
    n_csm = [int(eng.states.tem_valid[s].sum()) for s in range(N)]
    print(f"multistream: {smi}: QwenMultiStreamEngine, {N} streams x 224 px "
          f"clips of {MS_CLIP}, banks of {MS_BANK} ({banks / 1e9:.2f} GB); "
          f"ms/tick mean={np.mean(tick_ms):.2f} best={min(tick_ms):.2f} "
          f"median={np.median(tick_ms):.2f} over {MS_TICKS} ticks after 1 "
          f"warm-up ({np.mean(tick_ms) / N:.2f} ms a stream-clip) against a "
          f"solo session's {np.mean(solo_ms):.2f} ms/clip (median "
          f"{np.median(solo_ms):.2f}); frame pairs {list(counts)} after a "
          f"ragged tick of 0-7 frames, CSM {min(n_csm)}-{max(n_csm)}/"
          f"{cfg.flash_memory.csm_grid_len}; streams {MS_SOLO} against solo "
          f"sessions: positions equal but {ties} exact DAM ties, features "
          f"within {worst:.3e}; launches K1 {k1} = 64 x {len(ticks)} ticks, "
          f"K2 {k2} = 1 a tick ({N * cfg.flash_memory.dam_grid_len} rows "
          f"each)", flush=True)

    qs = _ms_questions(N)
    gen = GenerationConfig(max_new_tokens=MS_TOKENS, eos_token_ids=())
    g = eng.sess.generator
    batch = []
    gb = g.generate_batch

    def recorded(*a, **kw):
        batch.append(gb(*a, **kw))
        return batch[-1]
    g.generate_batch = recorded
    try:
        a1 = flash_attention_cuda.launches
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        texts = eng.answer_all(qs, gen)
        torch.cuda.synchronize(dev)
        all_s = time.perf_counter() - t0
        d1 = flash_attention_cuda.launches - a1
    finally:
        del g.generate_batch
    if len(batch) != 1 or len(texts) != N or d1 != cfg.llm.num_layers:
        raise AssertionError(f"multistream: answer_all took {len(batch)} "
                             f"batched decodes and {d1} K1 launches "
                             f"(reckoned 1, {cfg.llm.num_layers})")
    k1 += d1
    # the checks below launch K1 too; the path's counts stop here
    snaps, counts = eng._published
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    single = [eng.sess.answer_tokens(snaps[s], counts[s], q, gen)
              for s, q in enumerate(qs)]
    torch.cuda.synchronize(dev)
    seq_s = time.perf_counter() - t0
    # teacher-forced logits: each stream alone, then the batch
    single_lg, one_ms, one_busy = [], 0.0, 0.0
    for s, q in enumerate(qs):
        h = eng.sess._prompt_host(q, counts[s])
        e, p, start, seg = eng.sess._prompt_inputs(snaps[s], h)
        lg, ms, busy = _teacher_forced(g, e, p, seg, h["last_real"],
                                       [int(start)], [single[s]],
                                       profile=s == 0)
        single_lg.append(lg[0])
        if s == 0:
            one_ms, one_busy = ms, busy
    e, p, seg, starts, lasts = eng.batch_inputs(qs)
    blg, b_ms, b_busy = _teacher_forced(g, e, p, seg, lasts, starts, single,
                                        profile=True)
    worst_lg, parts, shift = _batched_rule("multistream answer_all", single,
                                           single_lg, batch[0], blg)
    # the control: streams 0 and 1 trade prompts in the batch (a planted
    # row fault), and the rule must refuse the result
    sw = [1, 0, *range(2, N)]
    bad, _, _ = _teacher_forced(g, e[sw], p[:, sw], seg[sw],
                                [lasts[i] for i in sw],
                                [starts[i] for i in sw], single)
    try:
        _batched_rule("control", single, single_lg, batch[0], bad)
        raise RuntimeError("multistream: the batched-answer rule passed a "
                           "batch with two streams' prompts swapped")
    except AssertionError as err:
        control = str(err)
    del bad
    print(f"multistream: answer_all of {N} questions ({MS_TOKENS} tokens, "
          f"batched prefill S={e.shape[1]}) {all_s:.3f} s against {N} "
          f"sequential answers {seq_s:.3f} s; batched logits within "
          f"{worst_lg:.3e} of max (limit {OFFLINE_LOGIT_TOL}), ids equal to "
          f"the per-stream ones but {len(parts)} partings where those logits "
          f"are tied or bf16 neighbours (stream, step, gap and shift in bf16 "
          f"steps) {parts}; the top-two gap's shift between the paths "
          f"elsewhere median {shift[0]:.3f} max {shift[1]:.3f} bf16 steps; "
          f"control (streams 0 and 1 swapped in the batch) refused: "
          f"{control}; decode ms/token B={N} {b_ms:.2f} (busy {b_busy:.2f}) "
          f"against B=1 {one_ms:.2f} (busy {one_busy:.2f}); K1 "
          f"{cfg.llm.num_layers} a batched prefill", flush=True)
    return k1, k2


def run_multistream_llava(dev, smi, params):
    """MultiStreamEngine over VStreamLLaVAConfig() (random bf16 weights):
    4 streams, clips of 8, 10 ticks (the 64-frame bank wraps); stream 0
    held to a solo LLaVAStreamSession's memory on the same draws; K1 = 23
    a tick; `answer_all` against `answer` by the logit rule. Returns K1 of
    the engine's own run (its ticks and `answer_all`)."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamLLaVAConfig
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.models.clip_vit import clip_layers_run
    from flash_vstream_tpu_torch.models.vstream_llava import init_llava_params
    from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    from flash_vstream_tpu_torch.runtime.streaming import (
        LLaVAStreamSession, MultiStreamEngine)

    cfg = VStreamLLaVAConfig()
    if params is None:
        params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED + 11), dev, dtype=torch.bfloat16)
    tok = ByteTokenizer()
    N = MS_LLAVA_STREAMS
    n_clip = clip_layers_run(cfg.vit)
    eng = MultiStreamEngine(params, cfg, tok, N, clip_size=LLAVA_CLIP,
                            max_len=4096)
    solo = LLaVAStreamSession(params, cfg, tok, clip_size=LLAVA_CLIP,
                              max_len=4096)
    solo._uniforms = lambda step, n: eng.draws(step, 0, n)
    frames = [_offline_frames(np.random.default_rng(SEED + 200 + s),
                              LLAVA_CLIP * MS_LLAVA_TICKS, 224)
              for s in range(N)]
    k1, tick_ms, worst = 0, [], 0.0
    for k in range(MS_LLAVA_TICKS):
        clips = [f[k * LLAVA_CLIP:(k + 1) * LLAVA_CLIP] for f in frames]
        a1 = flash_attention_cuda.launches
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eng.ingest(clips)
        eng.block()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        d1 = flash_attention_cuda.launches - a1
        if d1 != n_clip:
            raise AssertionError(f"multistream llava: tick {k} launched K1 "
                                 f"{d1}, reckoned {n_clip}")
        k1 += d1
        solo.ingest_frames(clips[0])
        got, want = eng._published[0][0], solo._published[0]
        if not torch.equal(got.valid, want.valid):
            raise AssertionError(f"multistream llava: tick {k} validity")
        scale = want.tokens.float().abs().max().item()
        worst = max(worst, (got.tokens.float() - want.tokens.float()).abs()
                    .max().item() / scale)
    if worst > LLAVA_REF_TOL:
        raise AssertionError(f"multistream llava: stream 0 memory {worst:.3e}"
                             f" of max from the solo session's (limit "
                             f"{LLAVA_REF_TOL})")
    qs = _ms_questions(N)
    gen = GenerationConfig(max_new_tokens=MS_TOKENS, eos_token_ids=())
    single = []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for s, q in enumerate(qs):
        e, p = eng.prompt_embeds(s, q)
        single.append(eng.generator.generate(e, p, gen))
    torch.cuda.synchronize(dev)
    seq_s = time.perf_counter() - t0
    e, p, seg, starts = eng.batch_inputs(qs)
    batch = []
    gb = eng.generator.generate_batch

    def recorded(*a, **kw):
        batch.append(gb(*a, **kw))
        return batch[-1]
    eng.generator.generate_batch = recorded
    try:
        a1 = flash_attention_cuda.launches
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eng.answer_all(qs, gen)
        torch.cuda.synchronize(dev)
        all_s = time.perf_counter() - t0
        d1 = flash_attention_cuda.launches - a1
    finally:
        del eng.generator.generate_batch
    if len(batch) != 1 or d1 != cfg.llm.num_layers:
        raise AssertionError(f"multistream llava: answer_all took "
                             f"{len(batch)} batched decodes and {d1} K1 "
                             f"launches (reckoned 1, {cfg.llm.num_layers})")
    k1 += d1
    single_lg = []
    for s, q in enumerate(qs):
        es, ps = eng.prompt_embeds(s, q)
        lg, _, _ = _teacher_forced(eng.generator, es, ps, None, None,
                                   [es.shape[1]], [single[s]])
        single_lg.append(lg[0])
    blg, b_ms, b_busy = _teacher_forced(eng.generator, e, p, seg, None,
                                        starts, single, profile=True)
    worst_lg, parts, shift = _batched_rule("multistream llava answer_all",
                                           single, single_lg, batch[0], blg)
    print(f"multistream llava: {smi}: MultiStreamEngine, {N} streams, clips "
          f"of {LLAVA_CLIP}, {MS_LLAVA_TICKS} ticks (the bank wraps): ms/tick "
          f"mean={np.mean(tick_ms[1:]):.2f} best={min(tick_ms[1:]):.2f}; "
          f"stream 0 against a solo session: memory within {worst:.3e} of "
          f"max (limit {LLAVA_REF_TOL}); answer_all {all_s:.3f} s against "
          f"{N} sequential answers {seq_s:.3f} s, batched logits within "
          f"{worst_lg:.3e} of max, {len(parts)} partings at tied or "
          f"neighbouring bf16 logits (stream, step, gap, shift) {parts}, "
          f"the shift elsewhere median {shift[0]:.3f} max {shift[1]:.3f} "
          f"bf16 steps; decode B={N} {b_ms:.2f} ms/token (busy {b_busy:.2f}); "
          f"K1 {n_clip} a tick", flush=True)
    return k1


def run_threaded_ingest(dev, params):
    """`run_server --threaded-ingest` on a QwenStreamSession over the 7B
    config: 120 frames at 30 fps in clips of 8 (267 ms deadlines), a
    question every 1.0 s and one after the stream, 32 tokens; every frame
    ingested, no ERROR record, and the final memory equal, bit for bit, to a
    sequential session's over the same frames and draws. Readings: missed
    deadlines, the answers' s and ms/token while ingesting against the
    final answer alone. Returns (K1, K2) of the server's run."""
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
    from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
    from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.preprocess.video import SyntheticSource
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    from flash_vstream_tpu_torch.serve.cli_server import make_parser, run_server

    cfg = VStreamQwenConfig()
    model = VStreamQwen(cfg, params)
    tok = make_byte_qwen_tokenizer()

    def session():
        return QwenStreamSession(model, tok, frame_hw=(224, 224),
                                 clip_size=MS_CLIP, bank_size=1024,
                                 max_len=4096)
    sess = session()
    timed = []
    tokens = sess.answer_tokens

    def answer_tokens(*a, **kw):
        t0 = time.perf_counter()
        ids = tokens(*a, **kw)
        torch.cuda.synchronize(dev)
        timed.append((time.perf_counter() - t0, len(ids)))
        return ids
    sess.answer_tokens = answer_tokens
    args = make_parser().parse_args([
        "--threaded-ingest", "--synthetic-frames", str(THREADED_FRAMES),
        "--fps", "30", "--play_speed", "1", "--clip-size", str(MS_CLIP),
        "--question", QUESTIONS[0], "--question_interval", "1.0",
        "--max-new-tokens", str(MS_TOKENS)])
    errors = []
    catch = logging.Handler(logging.ERROR)
    catch.emit = errors.append
    server_log = logging.getLogger("cli_server")
    server_log.addHandler(catch)
    a1, a2 = _launches()["K1"], gather_rows_cuda.launches
    t0 = time.perf_counter()
    try:
        summary = run_server(args, session=sess)
    finally:
        server_log.removeHandler(catch)
    wall = time.perf_counter() - t0
    k1, k2 = _launches()["K1"] - a1, gather_rows_cuda.launches - a2
    ref = session()
    src = SyntheticSource(THREADED_FRAMES, 224, 224, fps=30)
    frames = [src[i] for i in range(THREADED_FRAMES)]
    for i in range(0, THREADED_FRAMES, MS_CLIP):
        ref.ingest_frames(frames[i:i + MS_CLIP])
    ref.block_until_ingested()
    equal = all(torch.equal(a, b) for a, b in zip(sess._published[0],
                                                   ref._published[0]))
    m = summary["metrics"]
    missed = int(m["missed_clip_deadlines"]["val"])
    during = [(s, n) for s, n in timed[:-1]]
    alone = timed[-1]
    print(f"threaded_ingest: run_server --threaded-ingest, "
          f"{summary['frames_ingested']} frames at 30 fps in clips of "
          f"{MS_CLIP} in {wall:.2f} s: missed clip deadlines {missed} of "
          f"{THREADED_FRAMES // MS_CLIP}; {len(during)} answers while "
          f"ingesting: s {[round(s, 3) for s, _ in during]}, ms/token "
          f"{[round(s / n * 1e3, 2) for s, n in during]}; the final answer "
          f"alone {alone[0]:.3f} s, {alone[0] / alone[1] * 1e3:.2f} ms/token; "
          f"final memory {'equal' if equal else 'NOT equal'} to a sequential "
          f"session's bit for bit; K1 {k1} K2 {k2}; errors logged "
          f"{len(errors)}", flush=True)
    if (summary["frames_ingested"] != THREADED_FRAMES or errors or not equal
            or sess.n_frames != ref.n_frames):
        raise AssertionError("threaded_ingest: frames, errors or the final "
                             "memory differ from the sequential run")
    return k1, k2


def run_registry(dev, t=120, p_full=1024, p_small=256, D=1280):
    """`flash_consolidate` under REGISTRY_METHODS at the offline phase's
    shape (240 frames: t 120, P 1,024 / 256, D 1,280, f32 features from the
    seed in 20 scenes of 6 frames) and `flash_stream_update` under sample,
    merge, drop and attention over 20 clips of 4 frame pairs at the slice's
    shape (P 256 / 64, a 64-pair bank that wraps), on the card and on the
    CPU from the same inputs and draws: positions equal, features within
    REGISTRY_TOL of max. Card ms a call; a consolidation's also without
    its DAM part (spatial_length 0: the temporal method alone)."""
    import dataclasses
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.core.config import FlashMemoryConfig
    from flash_vstream_tpu_torch.models.flash_memory import (
        flash_consolidate, flash_stream_update, init_flash_state)
    from flash_vstream_tpu_torch.ops.retrieval import topk_by_weight
    from flash_vstream_tpu_torch.runtime.pipeline import seeded_draws

    # 20 scenes of 6 frames, fewer than the 60 CSM slots, so that the
    # methods merge frames and choose among them; features with a decaying
    # spectrum, so that PCA's leading subspace is well defined (over a flat
    # spectrum the 32nd component is picked by rounding, and card and CPU
    # then cluster in other spaces)
    n_scenes = 20
    g = torch.Generator().manual_seed(SEED + 300)
    scales = torch.exp(-torch.arange(D) / 64.0)
    centers = torch.randn(n_scenes, 1, D, generator=g) * scales
    scene = torch.arange(t) * n_scenes // t

    def feats(P):
        return (centers[scene]
                + 0.3 * scales * torch.randn(t, P, D, generator=g))
    x, small = feats(p_full), feats(p_small)
    rows = []

    def same(name, a, b, frames, frame_pos):
        """Card output `a` against CPU output `b`: CSM positions equal, DAM
        positions equal but where the CPU's query cluster is as near to
        both frames (a merged slot is the mean of two frames), features
        within REGISTRY_TOL of max where the frames agree."""
        if not torch.equal(a.tem_positions.cpu(), b.tem_positions):
            raise AssertionError(f"registry {name}: CSM positions differ")
        keep = a.spa_positions.cpu() == b.spa_positions
        for j in (~keep).nonzero().flatten().tolist():
            q = b.tem_x[topk_by_weight(b.tem_weights, keep.numel())[j]]
            q = q.flatten().float()
            d = [((frames[int((frame_pos == p).nonzero()[0, 0])].flatten()
                   .float() - q) ** 2).sum().item()
                 for p in (int(a.spa_positions[j]), int(b.spa_positions[j]))]
            if abs(d[0] - d[1]) > 1e-3 * max(d):
                raise AssertionError(f"registry {name}: DAM slot {j} differs "
                                     f"and is no tie {d}")
        err = 0.0
        for f, sel in (("tem_x", slice(None)), ("tem_weights", slice(None)),
                       ("spa_x", keep)):
            w = getattr(b, f)[sel].float()
            if w.numel():
                err = max(err, ((getattr(a, f).cpu()[sel].float() - w).abs()
                                .max() / w.abs().max().clamp_min(1e-30))
                          .item())
        if err > REGISTRY_TOL:
            raise AssertionError(f"registry {name}: features {err:.3e} of "
                                 f"max apart (limit {REGISTRY_TOL})")
        return err

    for method in REGISTRY_METHODS:
        cfg = dataclasses.replace(FlashMemoryConfig(), temporal_method=method)
        # gmm's PCA takes the covariance of whole frames, [P * D, P * D]
        # (JAX's too): 429 GB at P 256, so it runs at P 4
        xs, ss = (x, small) if method != "gmm" else (x[:, :16], small[:, :4])
        cpu = flash_consolidate(cfg, xs, ss, draws=seeded_draws(SEED, "cpu"))
        xd, sd = xs.to(dev), ss.to(dev)
        draws = lambda n: seeded_draws(SEED, "cpu")(n).to(dev)
        card = flash_consolidate(cfg, xd, sd, draws=draws)
        ms = []
        for c in (cfg, dataclasses.replace(cfg, spatial_length=0)):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            flash_consolidate(c, xd, sd, draws=draws)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        rows.append((f"consolidate {method}",
                     same(method, card, cpu, ss, torch.arange(t)), *ms))
        del xd, sd
    for method in ("sample", "merge", "drop", "attention"):
        cfg = dataclasses.replace(FlashMemoryConfig(), temporal_method=method)
        states = [init_flash_state(cfg, p_small, p_small // 4, D,
                                   bank_size=64, device=d)
                  for d in ("cpu", dev)]
        gs = torch.Generator().manual_seed(SEED + 301)
        worst, card_ms = 0.0, []
        for clip in range(20):
            nx = torch.randn(4, p_small, D, generator=gs)
            ns = (0.3 * scales * torch.randn(4, p_small // 4, D, generator=gs)
                  + centers[clip % centers.shape[0]])
            n_new = 3 if clip == 5 else 4
            outs = []
            for i, d in enumerate(("cpu", dev)):
                draws = lambda n: seeded_draws(clip, "cpu")(n).to(d)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                states[i], out = flash_stream_update(
                    cfg, states[i], nx.to(d), ns.to(d), n_new, draws)
                torch.cuda.synchronize(dev)
                if i:
                    card_ms.append((time.perf_counter() - t0) * 1e3)
                outs.append(out)
            worst = max(worst, same(f"stream {method} clip {clip}",
                                    outs[1], outs[0], states[0].bank_small,
                                    states[0].bank_pos))
        rows.append((f"stream {method}", worst, float(np.median(card_ms))))
    print("registry: card vs CPU, positions equal, features of max, card ms "
          "a call (a consolidation's temporal part alone after the slash): "
          + "; ".join(f"{n} {e:.2e} " + "/".join(f"{m:.1f}" for m in ms)
                      + " ms" for n, e, *ms in rows), flush=True)


def check_multistream_kernels(dev):
    """K1 and K2 at the multi-stream engine's shapes: the ViT over 8
    streams' frames ([32, 16, 256, 80] and the pooled [32, 16, 64, 80]),
    the batched prefill at B = 8 (left-padded rows, -1 padding), and K2's
    batched form (8 banks of [256, 256, 1280] bf16, 30 rows each, one
    launch); each against its plain version, timed beside SDPA or
    index_select and its bound."""
    import torch
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_reference)
    from flash_vstream_tpu_torch.kernels.gather_rows import (
        gather_rows_batched_cuda, gather_rows_batched_reference,
        gather_rows_cuda)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def heads(T, P, H, D):
        return randn(T, P, H, D).transpose(1, 2)
    B, S = MS_STREAMS, 3008
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, :32 * (b % 3)] = -1                 # left padding
        seg[b, 32 * (b % 3) + 64 + 2880 + 24:] = -1
    cases = {
        "vit_8streams": ((heads(32, 256, 16, 80), heads(32, 256, 16, 80),
                          heads(32, 256, 16, 80)), {}),
        "vit_small_8streams": ((heads(32, 64, 16, 80), heads(32, 64, 16, 80),
                                heads(32, 64, 16, 80)), {}),
        "prefill_b8": ((randn(B, 28, S, 128), randn(B, 4, S, 128),
                        randn(B, 4, S, 128)),
                       dict(causal=True, q_segment_ids=seg,
                            kv_segment_ids=seg)),
    }
    for name, (args, kw) in cases.items():
        q, k, v = args
        out = flash_attention_cuda(*args, **kw)
        ref = flash_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err, row = check_fwd(f"K1 {name}", out, ref, q, k, kw)
        del ref
        iters = 20 if name == "prefill_b8" else 50
        ms = _ms(lambda i: flash_attention_cuda(*args, **kw), iters)
        plain = _ms(lambda i: flash_attention_reference(*args, **kw),
                    1 if name == "prefill_b8" else 5)
        lib = _ms(lambda i: _sdpa(q, k, v, kw.get("causal", False)), iters)
        bound = _bound(
            _visible_pairs(q, k, kw.get("causal", False),
                           kw.get("q_segment_ids"), kw.get("kv_segment_ids"))
            * 4 * q.shape[-1],
            _nbytes(q, k, v, q, kw.get("q_segment_ids"),
                    kw.get("kv_segment_ids")))
        print(f"K1 {name}: shape q{tuple(q.shape)} k{tuple(k.shape)} "
              f"max_abs_err={err:.3e} row_err={row:.3e} kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) "
              f"library_ms={lib:.4f} (scaled_dot_product_attention"
              f"{', causal only, no segment mask' if kw else ''})",
              flush=True)
        torch.cuda.empty_cache()
    bank = randn(B, MS_BANK, 256, 1280)
    idxs = [torch.randint(0, MS_BANK, (B, 30), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(8)]
    n0 = gather_rows_cuda.launches
    for idx in idxs:
        if not torch.equal(gather_rows_batched_cuda(bank, idx),
                           gather_rows_batched_reference(bank, idx)):
            raise AssertionError("K2 batched: gather is not bit-exact")
    if gather_rows_cuda.launches - n0 != len(idxs):
        raise AssertionError("K2 batched: not one launch a call")
    ms = _ms(lambda i: gather_rows_batched_cuda(bank, idxs[i % 8]), 16)
    plain = _ms(lambda i: gather_rows_batched_reference(bank, idxs[i % 8]),
                16)
    flat = bank.view(B * MS_BANK, 256, 1280)
    offs = torch.arange(B, device=dev)[:, None] * MS_BANK
    lidx = [(i.long() + offs).reshape(-1) for i in idxs]
    lib = _ms(lambda i: flat.index_select(0, lidx[i % 8]), 16)
    bound = _bound(0, 2 * _nbytes(bank[0, :B * 30 // B]) * B
                   + _nbytes(idxs[0]))
    print(f"K2 dam_gather_8streams: bank{tuple(bank.shape)} bf16 idx"
          f"{tuple(idxs[0].shape)} bit-exact, one launch a call "
          f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bound[0]:.4f} "
          f"({bound[1]}) library_ms={lib:.4f} (index_select on the flat "
          f"bank)", flush=True)


# The llava_train phase: the LLaVA family's two-stage training at full
# width (projector pretrain at micro-batch 32, the full Vicuna-7B finetune
# at 16, S 937), one step of each other modality, card vs CPU at reduced
# depth, K1/K3/K4/K5 at the phase's shapes, run_training's entry point with
# a resume at decoder depth 4, extract_features and the eval worker
LT_FRAMES = 50               # --frame-bucket: the reference's video_max_frames
LT_PRE, LT_POST = 64, 192    # --pre-len, --post-len: S = 64 + 681 + 192
LT_STAGES = (("pretrain", 32), ("finetune", 16))   # micro-batches (SURVEY L20)
LT_STEPS = 4                 # 1 warm-up + 3 timed
LT_ITEMS = 32                # feature items (some shorter, some with `time`)
LT_RAW_BATCH = 8             # the raw-frame, image and text steps' micro-batch
LT_TEXT_LEN = 512
LT_DEPTH = 4                 # the entry point's checkpoint depth
# card bf16 against CPU f32, per trained leaf: the gradient's relative L2.
# bf16 gradients of f32 sums in another order read 1e-2-5e-2 a leaf (LoRA
# leaves up to 7.3e-2); labels shifted by one read ~1
LT_REF_TOL = 1e-1
LT_REF_LOSS_TOL = 1e-2       # the loss, relative
# the update check: Trainer steps of the finetune recipe in bf16 on the card,
# the update sliced by LT_CHECK_SLICE elements (every Vicuna layer leaf one
# layer a slice, embed and lm_head 256 rows), each step's gradients also
# handed to the CPU's whole bf16 update; each trained leaf's change within
# LT_UPDATE_TOL relative L2 (the same arithmetic on both sides; the global
# norm's f32 sums alone run in another order; it reads 0: bit-equal), a
# slice left out on the card (the planted fault) must fail it
LT_CHECK_SLICE = 1 << 20
LT_CHECK_STEPS = 2           # lr 0 (moments only), then the peak
LT_UPDATE_TOL = 1e-1


def _lt_conv(i, n_words):
    return [{"from": "human", "value": "<image>\nWhat happens in this "
             f"video, and in what order? Item {i}."},
            {"from": "gpt", "value": " ".join(
                f"Scene {j} of item {i} shows motion." for j in
                range(n_words))}]


def _lt_feature_set(root, rng, cfg, n_items=None):
    """LT_ITEMS (or `n_items`) `.npy` feature files at the real shape, f32
    [T, 64, 1024]
    (CLIP-L's 1,024 channels pooled to 8 x 8): most of 50 frames, some of
    20 or 35, every eighth a 70-frame feature with a breakpoint `time` key
    (a 30-frame window), written in one pass from one normal draw."""
    import numpy as np
    fdir = os.path.join(root, "feats")
    os.makedirs(fdir, exist_ok=True)
    base = rng.standard_normal((70, cfg.star.current_size ** 2,
                                cfg.projector.effective_input_dim),
                               dtype=np.float32)
    items = []
    for i in range(n_items or LT_ITEMS):
        T = {7: 70, 3: 20, 5: 35}.get(i % 8, 50) * LT_FRAMES // 50
        np.save(os.path.join(fdir, f"f{i}.npy"),
                np.roll(base[:T], i, axis=0) * (1 + 0.01 * i))
        item = {"id": i, "video": f"f{i}", "conversations": _lt_conv(i, 4)}
        if i % 8 == 7:
            item["time"] = T * 4 // 7
        items.append(item)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path, fdir


def _lt_raw_set(root, rng, side):
    """LT_RAW_BATCH `.npy` frame directories of LT_FRAMES frames of 224 px,
    as many `.npy` images and text items: one step of each modality."""
    import numpy as np
    media = os.path.join(root, "media")
    items = []
    frames = _offline_frames(rng, LT_FRAMES, side)
    for i in range(LT_RAW_BATCH):
        d = os.path.join(media, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for t in range(LT_FRAMES):
            np.save(os.path.join(d, f"{t:04d}.npy"), frames[(t + i) % LT_FRAMES])
        items.append({"id": f"v{i}", "video": f"v{i}",
                      "conversations": _lt_conv(i, 4)})
    for i in range(LT_RAW_BATCH):
        np.save(os.path.join(media, f"img{i}.npy"), frames[3 * i])
        items.append({"id": f"i{i}", "image": f"img{i}.npy",
                      "conversations": _lt_conv(i, 3)})
    for i in range(LT_RAW_BATCH):
        items.append({"id": f"t{i}", "conversations": [
            {"from": "human", "value": f"Tell the story number {i}. " * 3},
            {"from": "gpt", "value": f"Once there was a frame {i}. " * 12}]})
    path = os.path.join(root, "raw.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path, media


def _lt_args(dev, out, *extra):
    from flash_vstream_tpu_torch.train import train as lt
    return lt.make_parser().parse_args(
        ["--output-dir", out, "--frame-bucket", str(LT_FRAMES),
         "--pre-len", str(LT_PRE), "--post-len", str(LT_POST),
         "--video-max-frames", str(LT_FRAMES), "--text-len",
         str(LT_TEXT_LEN), "--device", str(dev), *extra])


def _lt_leaf_bytes(params, labels, which):
    """Bytes of the tensor leaves whose label is in `which`."""
    from flash_vstream_tpu_torch.train.trainer import tree_leaves_with_path
    return sum(_nbytes(x) for p, x in tree_leaves_with_path(params)
               if labels[p] in which)


def _lt_run(dev, cfg, params, tok, args, tag):
    """run_training with a record of each step: (result, [(record,
    launches of the step)], peak bytes, (params, grads, moments) bytes)."""
    import torch
    from flash_vstream_tpu_torch.train import train as lt
    recs, last = [], [_launches()]
    labels = []

    def on_step(step, trainer, rec):
        now = _launches()
        recs.append((rec, {k: now[k] - last[0][k] for k in now}))
        last[0] = now
        if not labels:
            labels.append(trainer.optimizer.labels)
        print(f"llava_train {tag} step {step + 1}: [{rec['modality']}] "
              f"loss {rec['loss']:.4f} {rec['step_time_s']:.3f} s "
              f"tokens_per_s {rec['tokens_per_s']:.0f} launches "
              + " ".join(f"{k}={v}" for k, v in recs[-1][1].items()),
              flush=True)

    _release(dev)
    res = lt.run_training(args, cfg=cfg, params=params, tokenizer=tok,
                          on_step=on_step)
    peak = torch.cuda.max_memory_allocated(dev)
    grads = _lt_leaf_bytes(res["params"], labels[0], ("train", "projector"))
    # Adam's mu and nu take each trained leaf's dtype, as the gradient
    return res, recs, peak, (_tree_nbytes(res["params"]), grads, 2 * grads)


def _lt_sums(params):
    """{leaf: byte sum} of a parameter tree (`_leaf_sums` without the
    version counter)."""
    return {p: s for p, (s, _) in _leaf_sums(params).items()}


def _lt_stage(dev, smi, cfg, params, tok, stage, B, data, work):
    """One stage at full width through run_training (no checkpoint: the
    full-width state would take ~110 s to write): LT_STEPS steps, the
    first a warm-up. Checks the losses finite and which parts moved."""
    import numpy as np
    from flash_vstream_tpu_torch.models.vstream_llava import star_valid_counts
    data_path, fdir = data
    before = _lt_sums(params)
    args = _lt_args(dev, os.path.join(work, stage), "--stage", stage,
                    "--batch-size", str(B), "--max-steps", str(LT_STEPS),
                    "--save-steps", "0", "--data-path", data_path,
                    "--feature-dir", fdir)
    res, recs, peak, (pb, gb, mb) = _lt_run(dev, cfg, params, tok, args,
                                            stage)
    after = _lt_sums(params)
    moved = {p.split(".")[0] for p in after if after[p] != before[p]}
    moved_llm = sorted(p for p in after if p.startswith("llm.")
                       and after[p] != before[p])
    losses = [r["loss"] for r, _ in recs]
    timed = [r["step_time_s"] for r, _ in recs[1:]]
    tps = [r["tokens_per_s"] for r, _ in recs[1:]]
    S = LT_PRE + sum(star_valid_counts(cfg, LT_FRAMES)) + LT_POST
    per = recs[-1][1]
    print(f"llava_train {stage} [{smi}]: micro-batch {B}, S {S:.0f}, "
          f"{LT_STEPS} steps (1 warm-up): step s "
          + " ".join(f"{t:.3f}" for t in timed)
          + f" (mean {np.mean(timed):.3f}), tokens_per_s "
          + " ".join(f"{t:.0f}" for t in tps)
          + f"; peak {peak / 2**30:.2f} GiB beside the reckoned params "
          f"{pb / 2**30:.2f} + grads {gb / 2**30:.2f} + moments "
          f"{mb / 2**30:.2f} = {(pb + gb + mb) / 2**30:.2f} GiB; launches a "
          f"step K3={per['K3']} K4={per['K4']} K5={per['K5']} K1={per['K1']};"
          f" losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; moved {sorted(moved)} ({len(moved_llm)} llm leaves)",
          flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"llava_train {stage}: a loss is not finite")
    want = {"pretrain": {"projector", "ntm"},
            "finetune": {"projector", "llm"}}[stage]
    if "vit" in moved or not want <= moved or (
            stage == "pretrain" and moved != want):
        raise AssertionError(f"llava_train {stage}: moved {sorted(moved)}")
    if stage == "finetune":
        big = [p for p in after if p.startswith("llm.") and "norm" not in p]
        if not set(big) <= set(moved_llm):
            raise AssertionError(f"llava_train finetune: llm leaves that did "
                                 f"not move: {sorted(set(big) - set(moved_llm))}")
    return dict(step_s=timed, tokens_per_s=tps, peak=peak,
                reckoned=pb + gb + mb, launches=per, losses=losses)


def _lt_ref_batch(cfg, tok, rng, frames):
    """One video micro-batch (B 1, bucket 8 frames of 8, pre 32, post 128)
    for the reduced-depth check: f32 features [8, 64, 1024] or uint8
    224 px frames."""
    import numpy as np
    from flash_vstream_tpu_torch.models.vstream_llava import star_valid_counts
    from flash_vstream_tpu_torch.train import data as td
    ids, labels = td.preprocess_v1(_lt_conv(0, 6), tok)
    s = {"input_ids": ids, "labels": labels, "n_frames": 8}
    if frames:
        s["frames"] = _offline_frames(rng, 8, cfg.vit.image_size)
    else:
        s["features"] = rng.standard_normal(
            (8, cfg.star.current_size ** 2, cfg.projector.effective_input_dim),
            dtype=np.float32)
    b = td.collate_llava([s], 8, tok.pad_token_id, fixed_pre_len=32,
                         fixed_post_len=128)
    n_mem = sum(star_valid_counts(cfg, 8))
    out = {"input_ids": b["input_ids"], "n_frames": b["n_frames"],
           "labels": td.spliced_labels(b, n_mem),
           "segments": td.spliced_segments(b, n_mem, tok.pad_token_id)}
    out["frames" if frames else "images"] = b["frames" if frames
                                              else "features"]
    return out, n_mem


def _lt_grads(cfg, params, batch, n_mem, device, shift=0):
    """(loss, {trained leaf: gradient}) of one finetune-stage video step
    (every leaf but the tower trains) on `device`."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.train import train as lt
    from flash_vstream_tpu_torch.train.finetune_flash import (
        default_kmeans_draws)
    from flash_vstream_tpu_torch.train.trainer import tree_leaves_with_path
    leaves = {p: x for p, x in tree_leaves_with_path(params)
              if not p.startswith("vit")}
    for x in leaves.values():
        x.requires_grad_(True)
    if shift:
        batch = dict(batch, labels=np.roll(batch["labels"], shift, axis=1))
    loss = lt.make_losses(cfg, torch.device(device), 32, n_mem,
                          default_kmeans_draws)["video"](params, batch, (0, 0))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {p: (torch.zeros_like(x) if g is None else g)
                         .detach().float().cpu()
                         for (p, x), g in zip(leaves.items(), grads)}


def _lt_copy(tree, device, dtype):
    """A copy of a parameter tree (dicts, lists, NamedTuples) on `device`
    in `dtype`."""
    if isinstance(tree, dict):
        return {k: _lt_copy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lt_copy(v, device, dtype) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_lt_copy(v, device, dtype) for v in tree))
    return tree.detach().to(device, dtype, copy=True)


def _lt_update_steps(dev, cfg, cut, batch, n_mem, fault=False):
    """LT_CHECK_STEPS Trainer steps of the finetune recipe (the schedule of
    LT_STEPS, as stage 2) over one video micro-batch on the card in bf16
    from `cut`'s weights, the update sliced by LT_CHECK_SLICE; each step's
    gradients also go to a whole bf16 update of a copy on the CPU.
    fault=True leaves each sliced leaf's last slice out of the card's
    update and keeps the whole update's copy on the card. Returns (losses,
    {trained leaf: rel L2 of the card's change against the copy's}, {leaf:
    share of elements that differ})."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.train import recipes
    from flash_vstream_tpu_torch.train import train as lt
    from flash_vstream_tpu_torch.train import trainer as tr
    from flash_vstream_tpu_torch.train.finetune_flash import (
        default_kmeans_draws)
    ref = dev if fault else "cpu"
    card = _lt_copy(cut, dev, torch.bfloat16)
    host = _lt_copy(cut, ref, torch.bfloat16)
    tcfg = recipes.llava_finetune(LT_STEPS)
    trainer = tr.Trainer(lt.make_losses(cfg, torch.device(dev), 32, n_mem,
                                        default_kmeans_draws)["video"],
                         card, tcfg)
    shadow = tr.AdamW(tcfg, host)
    sstate = [shadow.init(host)]
    card_update, real_slices = trainer.optimizer.update, tr._slices

    def update(grads, state, params):
        copied = {p: g.detach().to(ref, copy=True) for p, g in grads.items()}
        tr.UPDATE_SLICE, tr._slices = 1 << 62, real_slices
        sstate[0] = shadow.update(copied, sstate[0], host)
        del copied
        tr.UPDATE_SLICE = LT_CHECK_SLICE
        if fault:
            tr._slices = lambda x: real_slices(x)[:-1] or real_slices(x)
        return card_update(grads, state, params)

    trainer.optimizer.update = update
    stacked = {k: np.asarray(v)[None] for k, v in batch.items()}
    try:
        losses = [trainer.run_step(stacked, s) for s in range(LT_CHECK_STEPS)]
    finally:
        tr.UPDATE_SLICE, tr._slices = 1 << 26, real_slices
    errs, differ = {}, {}
    hosts = dict(tr.tree_leaves_with_path(host))
    start = dict(tr.tree_leaves_with_path(cut))
    for p, x in tr.tree_leaves_with_path(card):
        if trainer.optimizer.labels[p] == "frozen":
            continue
        got, want = x.detach().float(), hosts[p].to(dev).float()
        d_want = want - start[p].detach().float()
        wn = float(d_want.norm())
        errs[p] = (float((got - want).norm()) / wn if wn
                   else float((got - want).abs().max()))
        differ[p] = float((got != want).float().mean())
    del card, host, trainer, shadow, sstate
    _release(dev)
    return losses, errs, differ


def check_llava_train_update(dev, cfg, cut, batch, n_mem):
    """The bf16 update the card's stage 2 runs (sliced along the stacked
    layer axis), against the CPU's on the card's own gradients, at the
    reduced depth of `check_llava_train_reference`: every trained leaf's
    change after LT_CHECK_STEPS steps within LT_UPDATE_TOL; a slice left
    out on the card must fail it against a whole update. Prints the losses
    of the steps."""
    t0 = time.perf_counter()
    losses, errs, differ = _lt_update_steps(dev, cfg, cut, batch, n_mem)
    _, bad, _ = _lt_update_steps(dev, cfg, cut, batch, n_mem, fault=True)
    p_worst = max(errs, key=errs.get)
    f_worst = max(bad, key=bad.get)
    print(f"llava_train update: {LT_CHECK_STEPS} finetune steps in bf16 "
          f"(slices of {LT_CHECK_SLICE} elements on the card, whole on the "
          f"CPU, the card's gradients on both), {len(errs)} trained leaves: "
          f"losses " + " ".join(f"{x:.5f}" for x in losses)
          + f"; worst change rel L2 {errs[p_worst]:.3e} ({p_worst}; limit "
          f"{LT_UPDATE_TOL:.0e}), elements that differ at most "
          f"{max(differ.values()):.3e} of a leaf; planted fault (a slice "
          f"left out, against a whole update on the card) worst "
          f"{bad[f_worst]:.3e} ({f_worst}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if errs[p_worst] > LT_UPDATE_TOL or bad[f_worst] <= LT_UPDATE_TOL:
        raise AssertionError(f"llava_train update: worst leaf "
                             f"{errs[p_worst]:.3e}, fault {bad[f_worst]:.3e}")
    return errs[p_worst], bad[f_worst]


def check_llava_train_reference(dev, cfg, params, tok):
    """The finetune stage's loss and every trained leaf's gradient of one
    video-feature step and one raw-frame step at reduced depth (CLIP 2
    layers, 1 run; Vicuna 2; the Turing memory cut to 4 frames so that its
    NTM trains over 8 frames without k-means, whose decisions on random
    features the two sides' rounding could flip), every width full: the
    card on the full model's bf16 weights (K1 in the tower, K3/K4/K5 in the
    decoder) against the CPU in f32 on the same weights. Each leaf's
    gradient within LT_REF_TOL relative L2 (the NTM key bias, zero in exact
    arithmetic under the softmax, and leaves zero on both sides excepted),
    the loss within LT_REF_LOSS_TOL; labels shifted by one on the card
    (the planted fault) must fail the limit."""
    import dataclasses
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.models.layers import layer_slice
    rcfg = cfg.replace(
        vit=dataclasses.replace(cfg.vit, num_layers=2),
        llm=dataclasses.replace(cfg.llm, num_layers=2),
        star=dataclasses.replace(cfg.star, turing_length=4))
    cut = dict(params,
               vit=dict(params["vit"], layers=layer_slice(
                   params["vit"]["layers"], slice(0, 2))),
               llm=dict(params["llm"], layers=layer_slice(
                   params["llm"]["layers"], slice(0, 2))))

    rng = np.random.default_rng(SEED + 21)
    worst = {}
    for kind in ("features", "frames"):
        batch, n_mem = _lt_ref_batch(rcfg, tok, rng, kind == "frames")
        t0 = time.perf_counter()
        card_l, card_g = _lt_grads(rcfg, _lt_copy(cut, dev,
                                                  torch.bfloat16),
                                   batch, n_mem, dev)
        bad_l, bad_g = _lt_grads(rcfg, _lt_copy(cut, dev,
                                                torch.bfloat16),
                                 batch, n_mem, dev, shift=1)
        cpu_l, cpu_g = _lt_grads(rcfg, _lt_copy(cut, "cpu",
                                                torch.float32),
                                 batch, n_mem, "cpu")
        errs, fault = {}, {}
        for p, want in cpu_g.items():
            wn = float(want.norm())
            if p == "ntm.bk" or p.endswith("/.bk") or wn == 0:
                if wn == 0 and float(card_g[p].norm()) != 0:
                    raise AssertionError(f"llava_train reference: {p} is 0 "
                                         f"on the CPU, not on the card")
                continue
            errs[p] = float((card_g[p] - want).norm()) / wn
            fault[p] = float((bad_g[p] - want).norm()) / wn
        p_worst = max(errs, key=errs.get)
        f_worst = max(fault.values())
        loss_err = abs(card_l - cpu_l) / abs(cpu_l)
        print(f"llava_train reference {kind}: 2 CLIP + 2 Vicuna layers, "
              f"Turing 4, S {batch['labels'].shape[1]}, {len(errs)} leaves: "
              f"loss card {card_l:.5f} cpu {cpu_l:.5f} (rel {loss_err:.2e}, "
              f"limit {LT_REF_LOSS_TOL:.0e}); worst gradient rel L2 "
              f"{errs[p_worst]:.3e} ({p_worst}; limit {LT_REF_TOL:.0e}), "
              f"ntm {max(v for p, v in errs.items() if 'ntm' in p):.3e}, "
              f"projector {max(v for p, v in errs.items() if 'projector' in p):.3e}; "
              f"planted fault (labels shifted by one) worst {f_worst:.3e}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if (loss_err > LT_REF_LOSS_TOL or errs[p_worst] > LT_REF_TOL
                or f_worst <= LT_REF_TOL):
            raise AssertionError(f"llava_train reference {kind}: loss "
                                 f"{loss_err:.3e}, worst leaf "
                                 f"{errs[p_worst]:.3e}, fault {f_worst:.3e}")
        worst[kind] = (errs[p_worst], f_worst)
        if kind == "features":
            update_batch = (batch, n_mem)
    _release(dev)
    worst["update"] = check_llava_train_update(dev, rcfg, cut, *update_batch)
    return worst


def check_llava_train_kernels(dev):
    """K3, K4 and K5 against their plain versions at the finetune stage's
    attention shape, q/k/v [16, 32, 937, 128] causal with the collator's
    padding (-1 on a left run of the pre segment and a right run of the
    post segment, per row), and K1 at the raw-frame step's CLIP shape [8 x
    50, 16, 257, 64]; each timed by graph replay beside its plain version,
    SDPA (forward; backward dq + dk + dv: causal, no segments) and its
    bound. Returns {kernel: (row dict, shape text)}."""
    import torch
    from flash_vstream_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(SEED + 22)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    B, H, S, D = 16, 32, LT_PRE + 681 + LT_POST, 128
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, :(7 * b) % LT_PRE] = -1                 # left-padded pre
        seg[b, S - (11 * b + 5) % LT_POST:] = -1       # right-padded post
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    q, k, v, do = (randn(B, H, S, D) for _ in range(4))
    out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, out, do, lse, delta,
                                             **kw)
    p_out, p_lse = fa.flash_attention_fwd_lse_reference(q, k, v, **kw)
    p_dq, p_dk, p_dv = fa.flash_attention_bwd_reference(q, k, v, out, do,
                                                        lse, **kw)
    torch.cuda.synchronize()
    e_out, r_out = check_fwd("K3 llava_train", out, p_out, q, k, kw)
    fin = torch.isfinite(p_lse)
    e_lse = (lse[fin] - p_lse[fin]).abs().max().item()
    q_rows, k_rows = _grad_rows(q, k, kw)
    rel, row = {}, {}
    for n, a, b, r in (("dq", dq, p_dq, q_rows), ("dk", dk, p_dk, k_rows),
                       ("dv", dv, p_dv, k_rows)):
        rel[n] = ((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30)).item()
        row[n] = _row_err(a, b, r)
    if (e_lse > 1e-3 or max(rel.values()) > 2e-2 or max(row.values()) > 2e-2
            or not all(torch.isfinite(x).all() for x in (dq, dk, dv))):
        raise AssertionError(f"llava_train K3/K4/K5: lse {e_lse:.3e} "
                             f"grads/max {rel} by row {row}")
    errs = {"K3": e_out,
            "K4": (dq.float() - p_dq.float()).abs().max().item(),
            "K5": max((dk.float() - p_dk.float()).abs().max().item(),
                      (dv.float() - p_dv.float()).abs().max().item())}
    del p_out, p_lse, p_dq, p_dk, p_dv
    torch.cuda.empty_cache()
    pairs = _visible_pairs(q, k, True, seg, seg)
    seg_b = 2 * _nbytes(seg)
    t_k3 = _ms(lambda i: fa.flash_attention_fwd_lse_cuda(q, k, v, **kw), 5)
    t_plain = _ms(lambda i: fa.flash_attention_fwd_lse_reference(
        q, k, v, **kw), 1, windows=1)
    t_sdpa = _ms(lambda i: _sdpa(q, k, v, True), 5)
    (t_k4, t_k5), _ = _bwd_ms((q, k, v, out, do, lse, delta), kw, iters=3)
    t_plain_bwd = _ms(lambda i: fa.flash_attention_bwd_reference(
        q, k, v, out, do, lse, **kw), 1, windows=1)
    t_sdpa_bwd = _sdpa_bwd_ms(q, k, v, do)
    shape = f"[{B}, {H}, {S}, {D}] causal, left/right padding -1"
    res = {
        "flash_attention_fwd_lse": (errs["K3"], t_k3, t_plain, t_sdpa,
                                    _bound(pairs * 4 * D, _nbytes(
                                        q, k, v, out, lse) + seg_b)),
        "flash_attention_bwd_dq": (errs["K4"], t_k4, t_plain_bwd, t_sdpa_bwd,
                                   _bound(pairs * 6 * D, _nbytes(
                                       q, k, v, out, do, lse, dq, delta)
                                       + seg_b)),
        "flash_attention_bwd_dkv": (errs["K5"], t_k5, t_plain_bwd,
                                    t_sdpa_bwd, _bound(pairs * 8 * D, _nbytes(
                                        q, k, v, do, lse, delta, k, v)
                                        + seg_b)),
    }
    del q, k, v, do, out, lse, dq, dk, dv, delta
    torch.cuda.empty_cache()
    # K1 at the raw-frame step's CLIP shape (no mask)
    q1, k1, v1 = (randn(LT_RAW_BATCH * LT_FRAMES, 16, 257, 64)
                  for _ in range(3))
    o1 = fa.flash_attention_cuda(q1, k1, v1)
    p1 = fa.flash_attention_reference(q1, k1, v1)
    torch.cuda.synchronize()
    e1, _ = check_fwd("K1 llava_train clip", o1, p1, q1, k1, {})
    del p1
    res["flash_attention_fwd"] = (
        e1, _ms(lambda i: fa.flash_attention_cuda(q1, k1, v1), 5),
        _ms(lambda i: fa.flash_attention_reference(q1, k1, v1), 1,
            windows=1),
        _ms(lambda i: _sdpa(q1, k1, v1, False), 5),
        _bound(4 * q1.shape[0] * 16 * 257 * 257 * 64,
               _nbytes(q1, k1, v1, o1)))
    shapes = {"flash_attention_fwd": "[400, 16, 257, 64] (CLIP, 8 videos "
              "x 50 frames)"}
    out_rows = {}
    for name, (err, ms, plain, lib, (bound, by)) in res.items():
        kid = {"flash_attention_fwd": "K1", "flash_attention_fwd_lse": "K3",
               "flash_attention_bwd_dq": "K4",
               "flash_attention_bwd_dkv": "K5"}[name]
        where = shapes.get(name, shape)
        print(f"{kid} llava_train {where}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bound:.4f} "
              f"({by}) library_ms={lib:.4f} ("
              + ("SDPA backward, dq+dk+dv, causal only" if kid in ("K4", "K5")
                 else "SDPA forward" + (", causal only" if kid == "K3"
                                        else "")) + ")", flush=True)
        out_rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bound, bound_by=by, library_ms=lib)
    print(f"K3/K4/K5 llava_train by row: out {r_out:.3e}, lse {e_lse:.3e}, "
          + " ".join(f"{n}/max={rel[n]:.3e} by row {row[n]:.3e}"
                     for n in rel), flush=True)
    del q1, k1, v1, o1
    _release(dev)
    return out_rows


def _lt_entry_point(dev, cfg, params, tok, data, work):
    """run_training through its parser at Vicuna depth LT_DEPTH: a
    checkpoint written by the port's LLaVA export, `--model-path` on it,
    `--stage finetune --save-steps 2` on a 6-step schedule stopped after
    step 4's checkpoint (an exception in step 5), then a resume that takes
    steps 5 and 6 only (and writes no checkpoint); its state equal to an
    uninterrupted 6-step run's (no checkpoints). Returns (seconds, GB a
    checkpoint)."""
    import dataclasses
    import torch
    from flash_vstream_tpu_torch.models.layers import layer_slice
    from flash_vstream_tpu_torch.train import train as lt
    from flash_vstream_tpu_torch.train.checkpoint import latest_checkpoint
    from flash_vstream_tpu_torch.weights.export import (
        export_llava_checkpoint, save_hf_checkpoint)
    t0 = time.perf_counter()
    ccfg = cfg.replace(llm=dataclasses.replace(cfg.llm, num_layers=LT_DEPTH))
    cut = dict(params, llm=dict(params["llm"], layers=layer_slice(
        params["llm"]["layers"], slice(0, LT_DEPTH))))
    ckpt = os.path.join(work, "llava_depth4")
    save_hf_checkpoint(ckpt, export_llava_checkpoint(cut, ccfg),
                       max_shard_bytes=OFFLINE_SHARD)
    data_path, fdir = data
    common = ("--model-path", ckpt, "--stage", "finetune", "--batch-size",
              "2", "--max-steps", "6", "--data-path", data_path,
              "--feature-dir", fdir)

    class Stop(Exception):
        pass

    def stop_at_5(step, trainer, rec):
        if step == 4:
            raise Stop

    out = os.path.join(work, "entry")
    try:
        lt.run_training(_lt_args(dev, out, *common, "--save-steps", "2"),
                        cfg=ccfg, tokenizer=tok, on_step=stop_at_5)
        raise AssertionError("llava_train entry point: the run was not "
                             "stopped")
    except Stop:
        pass
    first = latest_checkpoint(out)[0]
    ck_gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                os.walk(os.path.join(out, f"checkpoint-{first}"))
                for f in fs) / 1e9
    # the resume reads checkpoint-4 and writes none (a 7 GB write less)
    resumed = lt.run_training(_lt_args(dev, out, *common, "--save-steps", "0"),
                              cfg=ccfg, tokenizer=tok)
    whole = lt.run_training(_lt_args(dev, os.path.join(work, "whole"), *common,
                                     "--save-steps", "0"),
                            cfg=ccfg, tokenizer=tok)
    a, b = _lt_sums(resumed["params"]), _lt_sums(whole["params"])
    differ = sorted(p for p in a if a[p] != b[p])
    print(f"llava_train entry point: --model-path (depth {LT_DEPTH}, the "
          f"port's export) --stage finetune --save-steps 2, stopped after "
          f"checkpoint-{first} ({ck_gb:.2f} GB), resumed (no checkpoint "
          f"written): steps "
          f"{len(resumed['losses'])} losses "
          + " ".join(f"{x:.4f}" for x in resumed["losses"])
          + f", uninterrupted 6 steps: last losses "
          + " ".join(f"{x:.4f}" for x in whole["losses"][-2:])
          + f"; {len(a)} leaves, {len(differ)} differ; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if first != 4 or len(resumed["losses"]) != 2 or differ or \
            resumed["losses"] != whole["losses"][-2:]:
        raise AssertionError(f"llava_train entry point: checkpoint {first}, "
                             f"resumed {resumed['losses']}, whole "
                             f"{whole['losses']}, differ {differ[:5]}")
    del resumed, whole
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, ck_gb


def _lt_extract_and_eval(dev, cfg, params, tok, work, rng):
    """extract_features over two `.npy` frame directories on the card, then
    the eval worker over what it wrote (16 new tokens): the worker's
    answers' ids (recorded) must equal LLaVAPipeline.answer_tokens on the
    same features. Returns the pipeline and the worker's ids."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.eval import model_video_qa as qa
    from flash_vstream_tpu_torch.runtime.pipeline import LLaVAPipeline
    from flash_vstream_tpu_torch.scripts import extract_features as ex
    vdir = os.path.join(work, "videos")
    for i, n in enumerate((12, 20)):
        d = os.path.join(vdir, f"clip{i}")
        os.makedirs(d, exist_ok=True)
        for t, f in enumerate(_offline_frames(rng, n, 256 + 64 * i)):
            np.save(os.path.join(d, f"{t:04d}.npy"), f)
    fdir = os.path.join(work, "features")
    t0 = time.perf_counter()
    written = ex.extract(ex.make_parser().parse_args(
        ["--video_dir", vdir, "--output_dir", fdir, "--device", str(dev)]),
        cfg, params)
    torch.cuda.synchronize(dev)
    ex_s = time.perf_counter() - t0
    if written != ["clip0", "clip1"]:
        raise AssertionError(f"extract_features wrote {written}")
    gt = os.path.join(work, "qa.json")
    with open(gt, "w") as f:
        json.dump([{"id": i, "video_id": f"clip{i}",
                    "question": "What happens in the video?"}
                   for i in range(2)], f)
    pipe = LLaVAPipeline(params, cfg, tok, max_len=4096)
    ids, generate = [], pipe.generator.generate

    def recorded(*a, **k):
        out = generate(*a, **k)
        ids.append([int(t) for t in out])
        return out
    pipe.generator.generate = recorded
    t0 = time.perf_counter()
    qa.run_inference(qa.make_parser().parse_args(
        ["--video_dir", fdir, "--gt_file", gt, "--output_dir",
         os.path.join(work, "eval"), "--max-new-tokens", "16",
         "--device", str(dev)]),
        pipeline=pipe)
    ev_s = time.perf_counter() - t0
    pipe.generator.generate = generate
    feats = [qa.load_features(fdir, f"clip{i}") for i in range(2)]
    print(f"llava_train extract_features: {written} -> "
          + ", ".join(f"{tuple(f.shape)} {f.dtype}" for f in feats)
          + f" in {ex_s:.2f} s; eval worker (16 tokens) {ev_s:.2f} s",
          flush=True)
    return pipe, ids, feats


def run_llava_train(dev, smi, root, params=None, cfg=None):
    """The LLaVA family's training path at the full width of
    VStreamLLaVAConfig() on the llava phase's random bf16 weights (built
    here when that phase did not run), trained in place:
    1. K3/K4/K5 at the finetune stage's attention shape and K1 at the
       raw-frame step's CLIP shape against their plain versions, timed
       (`check_llava_train_kernels`); the card against the CPU at reduced
       depth (`check_llava_train_reference`: gradients, then the bf16
       update of two steps, `check_llava_train_update`);
    2. the path (its launches counted from 0): stage 1, --stage pretrain,
       micro-batch 32, and stage 2, --stage finetune, micro-batch 16, each
       LT_STEPS steps through run_training over LT_ITEMS feature items at
       the real shape (bucket 50, pre 64, post 192: S 937), no checkpoint;
       one step each of raw `.npy` frames (the frozen CLIP, K1), images
       and text (micro-batch LT_RAW_BATCH, text 512); run_training's entry
       point at depth LT_DEPTH with its resume; extract_features and the
       eval worker over two `.npy` frame directories;
    3. the worker's ids against LLaVAPipeline.answer_tokens on the same
       features (after the counts are read).
    Returns (K1, K3, K4, K5 of the path, kernel rows, stage readings)."""
    import numpy as np
    import torch
    from flash_vstream_tpu_torch.core.config import VStreamLLaVAConfig
    from flash_vstream_tpu_torch.models.vstream_llava import init_llava_params
    from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig

    t_phase = time.perf_counter()
    cfg = cfg or VStreamLLaVAConfig()
    tok = ByteTokenizer()
    if params is None:
        params = init_llava_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 11), dev,
            dtype=torch.bfloat16)
    work = os.path.join(root, "build", "chip_smoke_llava_train")
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(SEED + 23)
    try:
        feats = _lt_feature_set(work, rng, cfg)
        raw = _lt_raw_set(work, rng, cfg.vit.image_size)
        print(f"llava_train: data written at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        rows = check_llava_train_kernels(dev)
        check_llava_train_reference(dev, cfg, params, tok)
        print(f"llava_train: checks done at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

        _reset_launches()
        stages = {}
        for stage, B in LT_STAGES:
            stages[stage] = _lt_stage(dev, smi, cfg, params, tok, stage, B,
                                      feats, work)
            print(f"llava_train: {stage} done at "
                  f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        B = dict(LT_STAGES)["finetune"]
        _, recs, peak, _ = _lt_run(
            dev, cfg, params, tok, _lt_args(
                dev, os.path.join(work, "offload"), "--stage", "finetune",
                "--batch-size", str(B), "--max-steps", "1", "--save-steps",
                "0", "--data-path", feats[0], "--feature-dir", feats[1],
                "--offload-moments"), "offload")
        resident = stages["finetune"]["peak"]
        print(f"llava_train offload [{smi}]: one finetune step at "
              f"micro-batch {B} with --offload-moments (mu and nu in pinned "
              f"host memory, each update slice streamed through the card): "
              f"{recs[0][0]['step_time_s']:.3f} s, loss "
              f"{recs[0][0]['loss']:.4f}, peak {peak / 2**30:.2f} GiB beside "
              f"the resident steps' {resident / 2**30:.2f} GiB", flush=True)
        if not (math.isfinite(recs[0][0]["loss"]) and peak < resident):
            raise AssertionError("llava_train offload: the peak did not drop")
        _, recs, peak, _ = _lt_run(
            dev, cfg, params, tok, _lt_args(
                dev, os.path.join(work, "raw"), "--stage", "finetune",
                "--batch-size", str(LT_RAW_BATCH), "--max-steps", "3",
                "--save-steps", "0", "--data-path", raw[0], "--video-dir",
                raw[1]), "modalities")
        kinds = [r["modality"] for r, _ in recs]
        if sorted(kinds) != ["image", "text", "video"] or not all(
                np.isfinite(r["loss"]) and r["loss"] > 0 for r, _ in recs):
            raise AssertionError(f"llava_train modalities: {kinds}, "
                                 f"{[r['loss'] for r, _ in recs]}")
        print(f"llava_train modalities: micro-batch {LT_RAW_BATCH} (raw "
              f"frames {LT_FRAMES} a video through the frozen CLIP, one "
              f"image each, text {LT_TEXT_LEN}), one step each, the first "
              f"step of its kind: "
              + ", ".join(f"{r['modality']} {r['step_time_s']:.3f} s loss "
                          f"{r['loss']:.4f} K1={c['K1']} K3={c['K3']}"
                          for r, c in recs)
              + f"; peak {peak / 2**30:.2f} GiB", flush=True)
        entry_s, ck_gb = _lt_entry_point(dev, cfg, params, tok, feats, work)
        pipe, ids, feat_np = _lt_extract_and_eval(dev, cfg, params, tok,
                                                  work, rng)
        got = _launches()
        if min(got.values()) == 0:
            raise AssertionError(f"llava_train: a kernel of the path was "
                                 f"never launched: {got}")
        gen = GenerationConfig(max_new_tokens=16,
                               eos_token_ids=(tok.eos_token_id,))
        want = [pipe.answer_tokens(None, "What happens in the video?", gen,
                                   features=torch.from_numpy(
                                       np.asarray(f, np.float32)).to(dev))
                for f in feat_np]
        if want != ids:
            raise AssertionError(f"llava_train eval worker ids {ids} != "
                                 f"LLaVAPipeline's {want}")
        print(f"llava_train eval worker: ids of both answers equal "
              f"LLaVAPipeline.answer_tokens on the same features "
              f"({[len(x) for x in ids]} tokens)", flush=True)
        print(f"llava_train: launches of the path K1={got['K1']} "
              f"K3={got['K3']} K4={got['K4']} K5={got['K5']} (the checks "
              f"apart); entry point {entry_s:.1f} s, checkpoints "
              f"{ck_gb:.2f} GB; phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _release(dev)
    return got, rows, stages


PHASES = ("kernels", "int4_kernel", "reference", "int4_reference", "entry",
          "c2",
          "slice", "disaggregated", "video_io", "llava", "serve_http",
          "offline", "backward",
          "function", "train_reference", "dry_run_train", "train_parallel",
          "train_slice",
          "production", "finetune_ckpt", "serve_kv8", "serve4", "bank_gather",
          "vit_probe", "int4_probe", "multistream", "llava_train")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run (default all; "
                             "train_parallel and entry build their own "
                             "weights; disaggregated, video_io, serve_http, "
                             "offline, the training phases, "
                             "finetune_ckpt, serve_kv8 and serve4 need "
                             "'slice'; llava runs after them, alone; "
                             "llava_train last, on llava's weights when "
                             "llava runs, else on its own)")
    parser.add_argument("--train-parallel-rank", nargs=3, default=None,
                        metavar=("WORK", "DATA", "SHARED"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--ranks", type=int, default=2,
                        help="train_parallel's ranks: 2 share the one card "
                             "over gloo; with as many cards, a card a rank "
                             "over NCCL (4 on a four-card machine)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="also profile one training-slice step into DIR, "
                             "and the disaggregated phase's decode at each "
                             "tp (device busy a token)")
    opts = parser.parse_args()
    if opts.train_parallel_rank:       # a rank of the train_parallel phase
        _tpar_rank(*opts.train_parallel_rank)
        return 0
    only = set(opts.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on an NVIDIA "
              "card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from flash_vstream_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} tf32 off", flush=True)

    t0 = time.perf_counter()

    def mark(phase):
        print(f"chip_smoke: {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    lib = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = {}
    paths = {}                # path -> {kernel: launches in that path's run}
    params = lparams = None   # the slice's and the llava phase's weights
    if "kernels" in only:
        rows.update(check_kernels(dev))
        mark("kernels")
    if "int4_kernel" in only:
        rows.update(check_int4_kernel(dev))
        mark("int4_kernel")
    if "backward" in only:
        rows.update(check_backward_kernels(dev))
        mark("backward")
    if "function" in only:
        check_function(dev)
        mark("function")
    if "reference" in only:
        check_reference(dev)
        mark("reference")
    if "int4_reference" in only:
        check_int4_reference(dev)
        mark("int4_reference")
    if "train_reference" in only:
        check_train_reference(dev)
        mark("train_reference")
    if "dry_run_train" in only:
        work = os.path.join(root, "build", "chip_smoke_dry_run")
        try:
            k = run_dry_run_train(dev, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        paths["dry_run_train"] = dict(
            flash_attention_fwd=k["K1"], flash_attention_fwd_lse=k["K3"],
            flash_attention_bwd_dq=k["K4"], flash_attention_bwd_dkv=k["K5"])
        _release(dev)
        mark("dry_run_train")
    if "train_parallel" in only:
        _release(dev)
        k = run_train_parallel(dev, smi, root, opts.ranks)
        paths["train_parallel"] = dict(
            flash_attention_fwd=k["K1"], flash_attention_fwd_lse=k["K3"],
            flash_attention_bwd_dq=k["K4"], flash_attention_bwd_dkv=k["K5"])
        _release(dev)
        mark("train_parallel")
    if "bank_gather" in only:
        row, paths["probe_bank_gather"] = check_bank_gather(dev)
        rows.update(row)
        mark("bank_gather")
    if "vit_probe" in only:
        rows.update(check_frame_attention(dev))
        paths["probe_vit_variants"] = run_vit_probe(dev)
        work = os.path.join(root, "build", "chip_smoke_w8a8")
        try:
            check_w8a8(dev, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        _release(dev)
        mark("vit_probe")
    if "int4_probe" in only:
        row, paths["probe_int4_variants"] = check_int4_probe(dev)
        rows.update(row)
        _release(dev)
        mark("int4_probe")
    if "entry" in only:
        paths["entry"] = dict(flash_attention_fwd=run_entry(dev))
        _release(dev)
        mark("entry")
    if "c2" in only:
        check_c2(dev)
        _release(dev)
        mark("c2")
    if "slice" in only:
        _reset_launches()
        k1, k2, params = run_slice(dev)
        paths["slice"] = dict(flash_attention_fwd=k1, gather_rows=k2)
        mark("slice")
        work = os.path.join(root, "build", "chip_smoke_train")
        if "disaggregated" in only:
            dwork = os.path.join(root, "build", "chip_smoke_disaggregated")
            try:
                k1, k2 = run_disaggregated(dev, smi, params, dwork,
                                           profile=bool(opts.profile))
            finally:
                shutil.rmtree(dwork, ignore_errors=True)
            paths["disaggregated"] = dict(flash_attention_fwd=k1,
                                          gather_rows=k2)
            _release(dev)
            mark("disaggregated")
        qparams = _qwen_cut(params)     # QWEN_LAYERS: the time limit
        if "video_io" in only:
            k1, k2 = run_video_io(dev, qparams, root)
            paths["video_io"] = dict(flash_attention_fwd=k1, gather_rows=k2)
            _release(dev)
            mark("video_io")
        try:
            if "serve_http" in only:
                k1, k2 = run_serve_http(dev, qparams, work)
                paths["serve_http"] = dict(flash_attention_fwd=k1,
                                           gather_rows=k2)
                _release(dev)
                mark("serve_http")
            ckpt = os.path.join(root, "build", "offline_ckpt")
            if "offline" in only:
                paths["offline"] = dict(flash_attention_fwd=run_offline(
                    dev, qparams, work, smi, root,
                    keep_ckpt="finetune_ckpt" in only))
                _release(dev)
                mark("offline")
            if "train_slice" in only:
                total, data, step_s = run_train_slice(dev, qparams, work)
                paths["train_slice"] = dict(
                    flash_attention_fwd=total["K1"],
                    flash_attention_fwd_lse=total["K3"],
                    flash_attention_bwd_dq=total["K4"],
                    flash_attention_bwd_dkv=total["K5"])
                if opts.profile:
                    os.makedirs(opts.profile, exist_ok=True)
                    profile_train_step(dev, qparams, data, work,
                                       opts.profile, step_s)
                mark("train_slice")
            if "production" in only:
                run_production_step(dev, qparams, work)
                mark("production")
            if "finetune_ckpt" in only:
                k = run_finetune_ckpt(dev, qparams, work, root, ckpt)
                paths["finetune_ckpt"] = dict(
                    flash_attention_fwd=k["K1"],
                    flash_attention_fwd_lse=k["K3"],
                    flash_attention_bwd_dq=k["K4"],
                    flash_attention_bwd_dkv=k["K5"], int4_matmul=k["K6"])
                _release(dev)
                mark("finetune_ckpt")
            qparams = None    # its views would keep serve4's frees alive
            if "serve_kv8" in only:
                k1, k2, k6 = run_serve_kv8(dev, params, work)
                paths["serve_kv8"] = dict(flash_attention_fwd=k1,
                                          gather_rows=k2, int4_matmul=k6)
                _release(dev)
                mark("serve_kv8")
            if "serve4" in only:
                _release(dev)
                k6, k1, k2 = run_serve4(dev, params, work)
                paths["serve4"] = dict(int4_matmul=k6, flash_attention_fwd=k1,
                                       gather_rows=k2)
                mark("serve4")
        finally:
            shutil.rmtree(work, ignore_errors=True)
            shutil.rmtree(ckpt, ignore_errors=True)
    if "llava" in only:
        _release(dev)
        k1, k6, lparams = run_llava(dev, smi, root)
        paths["llava"] = dict(flash_attention_fwd=k1, int4_matmul=k6)
        mark("llava")
    if "multistream" in only:
        _release(dev)
        t_phase = time.perf_counter()
        check_multistream_kernels(dev)
        print(f"multistream: kernels done at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        if params is None or "llm" not in params:
            # serve4 frees the slice's bf16 decoder: build the weights anew
            params = None
            from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
            from flash_vstream_tpu_torch.models.vstream_qwen import (
                init_qwen_params)
            params = init_qwen_params(
                VStreamQwenConfig(), torch.Generator(device=dev).manual_seed(
                    SEED), device=dev, dtype=torch.bfloat16)
        # the counts of the path's run: every wrapper's count from 0 here
        _reset_launches()
        k1, k2 = run_multistream_qwen(dev, smi, params)
        print(f"multistream: qwen engine done at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        tk1, tk2 = run_threaded_ingest(dev, params)
        print(f"multistream: threaded ingest done at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        k1, k2 = k1 + tk1, k2 + tk2
        params = None
        _release(dev)
        k1 += run_multistream_llava(dev, smi, lparams)
        if "llava_train" not in only:
            lparams = None
        from flash_vstream_tpu_torch.kernels.gather_rows import (
            gather_rows_cuda)
        got = _launches()["K1"], gather_rows_cuda.launches
        if min(k1, k2) == 0:
            raise AssertionError("multistream: a kernel of the path was "
                                 "never launched")
        print(f"multistream: launches of the path (the engines' and the "
              f"threaded server's runs) K1={k1} K2={k2}; of the checks (solo "
              f"sessions, per-stream reference answers, teacher-forced "
              f"logits, the control) K1={got[0] - k1} K2={got[1] - k2}; "
              f"llava engine done at {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        paths["multistream"] = dict(flash_attention_fwd=k1, gather_rows=k2)
        run_registry(dev)
        print(f"multistream: registry done, phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        mark("multistream")
    if "llava_train" in only:
        _release(dev)
        got, lt_rows, _ = run_llava_train(dev, smi, root, lparams)
        lparams = None
        paths["llava_train"] = dict(
            flash_attention_fwd=got["K1"], flash_attention_fwd_lse=got["K3"],
            flash_attention_bwd_dq=got["K4"],
            flash_attention_bwd_dkv=got["K5"])
        for name, row in lt_rows.items():
            rows.setdefault(name, row)
        mark("llava_train")
    sources = {
        "flash_attention_fwd": ("flash_attention.cu", ":90"),
        "gather_rows": ("gather_rows.cu", ""),
        "flash_attention_fwd_lse": ("flash_attention.cu", ":158"),
        "flash_attention_bwd_dq": ("flash_attention_bwd.cu", ":285"),
        "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", ":332"),
        "int4_matmul": ("int4_matmul.cu", ""),
        "bank_gather": ("bank_gather.cu", ""),
        "frame_attention": ("frame_attention.cu", ""),
    }
    replaces = {"gather_rows": "flash_vstream_tpu/kernels/gather_rows.py:23",
                "int4_matmul": "flash_vstream_tpu/kernels/int4_matmul.py:45",
                "bank_gather": "scripts/probe_bank_gather.py:81",
                "frame_attention": "scripts/probe_vit_variants.py:219"}
    # `launches` counts the run of the path the kernel was ported for;
    # `launches_by_path` each path's own run (counts reset before each)
    own = {"flash_attention_fwd": "slice", "gather_rows": "slice",
           "flash_attention_fwd_lse": "train_slice",
           "flash_attention_bwd_dq": "train_slice",
           "flash_attention_bwd_dkv": "train_slice", "int4_matmul": "serve4",
           "bank_gather": "probe_bank_gather",
           "frame_attention": "probe_vit_variants"}
    for variant, line in P3_LINES.items():       # P3 and P4
        name = variant.replace("-", "_")
        sources[name] = ("int4_b1.cuh" if variant in P3_FOLD
                         else "bf16_b1.cuh" if variant == "v6-bf16dot"
                         else "int4_variants.cu", "")
        replaces[name] = f"scripts/probe_int4_variants.py:{line}"
        own[name] = "probe_int4_variants"
    kernels = []
    for name, row in rows.items():
        src, line = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"flash_vstream_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces.get(
                name, f"flash_vstream_tpu/kernels/flash_attention.py{line}"),
            "launches": paths.get(own[name], {}).get(name, 0),
            "launches_by_path": {p: c[name] for p, c in paths.items()
                                 if name in c},
            "per": "call", **row})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
