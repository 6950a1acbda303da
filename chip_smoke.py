#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (flash_vstream_tpu_torch) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and exits non-zero:

1. environment: refuses to run without CUDA; prints the card's name and
   power limit (nvidia-smi) and the torch / CUDA versions;
2. build: compiles the CUDA kernels from csrc/ with nvcc into build/;
3. kernels: K1 (flash attention) and K2 (row gather) against their plain
   PyTorch versions at the slice's own shapes, with times;
4. reference: a small two-layer model (head dims 80 and 128, the 7B
   config cut in width and depth) streamed
   through the port on the card and on the CPU (plain versions), compared;
5. slice: the full-width Qwen2-VL-7B streaming session with random weights:
   21 clips ingested (one warm-up), memory saturated, 3 greedy answers,
   with the launch counts of both kernels during ingest and answering.

The line before the last is one JSON object with each kernel's launches,
error and times; the last is the device record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import os
import subprocess
import sys
import time

SEED = 0
N_CLIPS = 20
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


def check_kernels(dev):
    """K1 and K2 against their plain versions at the slice's shapes."""
    import torch
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_reference)
    from flash_vstream_tpu_torch.kernels.gather_rows import (
        gather_rows_cuda, gather_rows_reference)

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
    q_seg = torch.zeros(2, 100, dtype=torch.int32, device=dev)
    q_seg[:, 17] = 5                      # an id no key has: a masked row
    kv_seg = torch.zeros(2, 100, dtype=torch.int32, device=dev)
    cases = {
        "vit_full": ((heads(4, 256, 16, 80), heads(4, 256, 16, 80),
                      heads(4, 256, 16, 80)), {}, None),
        "vit_small": ((heads(4, 64, 16, 80), heads(4, 64, 16, 80),
                       heads(4, 64, 16, 80)), {}, None),
        "prefill": ((randn(1, 28, S, 128), randn(1, 4, S, 128),
                     randn(1, 4, S, 128)),
                    dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg),
                    (slice(None), slice(None), slice(64 + 2880 + 40, None))),
        "masked_row": ((randn(2, 4, 100, 64), randn(2, 4, 100, 64),
                        randn(2, 4, 100, 64)),
                       dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg),
                       (slice(None), slice(None), 17)),
    }
    k1_err, k1_times = 0.0, {}
    for name, (args, kw, masked) in cases.items():
        out = flash_attention_cuda(*args, **kw)
        ref = flash_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all() or err > 2e-2:
            raise AssertionError(f"K1 {name}: max_abs_err {err} > 2e-2 or "
                                 f"non-finite output")
        if masked is not None and out[masked].abs().max().item() != 0.0:
            raise AssertionError(f"K1 {name}: a fully masked row is not 0")
        iters = 20 if name == "prefill" else 50
        ms = _ms(lambda i: flash_attention_cuda(*args, **kw), iters)
        plain = _ms(lambda i: flash_attention_reference(*args, **kw), 5)
        k1_err = max(k1_err, err)
        k1_times[name] = (ms, plain)
        print(f"K1 {name}: shape q{tuple(args[0].shape)} k{tuple(args[1].shape)}"
              f" {kw.get('causal', False) and 'causal ' or ''}"
              f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain:.4f}",
              flush=True)

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
    print(f"K2 dam_gather: bank{tuple(bank.shape)} bf16 idx[30] bit-exact "
          f"kernel_ms={k2_ms:.4f} plain_ms={k2_plain:.4f}", flush=True)
    return {"k1_err": k1_err, "k1_ms": k1_times["prefill"][0],
            "k1_plain_ms": k1_times["prefill"][1], "k2_ms": k2_ms,
            "k2_plain_ms": k2_plain}


def _frames(rng, n, hw):
    import numpy as np
    return list(rng.integers(0, 256, size=(n, *hw, 3), dtype=np.uint8))


def check_reference(dev):
    """A small model (ViT head_dim 80, LLM head_dim 128, two layers each)
    streamed on the card (kernels) and on the CPU (plain versions) from the
    same bf16 weights and frames: positions must match and features agree to
    bf16 rounding; the answer's prefill logits must agree."""
    import dataclasses

    import numpy as np
    import torch
    from flash_vstream_tpu_torch.models.vstream_qwen import (
        VStreamQwen, VStreamQwenConfig, init_qwen_params)
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession

    full = VStreamQwenConfig()
    cfg = full.replace(
        vit=dataclasses.replace(full.vit, hidden_size=160,
                                intermediate_size=320, num_layers=2,
                                num_heads=2, merger_out_dim=256),
        llm=dataclasses.replace(full.llm, vocab_size=512, hidden_size=256,
                                intermediate_size=512, num_layers=2,
                                num_heads=2, num_kv_heads=1),
        flash_memory=dataclasses.replace(full.flash_memory,
                                         temporal_length=8, spatial_length=4))
    params = init_qwen_params(cfg, torch.Generator().manual_seed(SEED),
                              dtype=torch.bfloat16)
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
    return k1_ingest + k1_answer, k2_ingest + k2_answer


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on an NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    lib = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    k = check_kernels(dev)
    check_reference(dev)
    k1_launches, k2_launches = run_slice(dev)
    print(json.dumps({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "flash_vstream_tpu_torch/kernels/csrc/flash_attention.cu",
         "replaces": "flash_vstream_tpu/kernels/flash_attention.py:90",
         "launches": k1_launches, "max_abs_err": k["k1_err"],
         "ms": k["k1_ms"], "plain_ms": k["k1_plain_ms"]},
        {"name": "gather_rows", "route": "cuda",
         "source": "flash_vstream_tpu_torch/kernels/csrc/gather_rows.cu",
         "replaces": "flash_vstream_tpu/kernels/gather_rows.py:23",
         "launches": k2_launches, "max_abs_err": 0.0,
         "ms": k["k2_ms"], "plain_ms": k["k2_plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
