"""Driver entry points of the port.

The counterparts of the JAX package's `__graft_entry__.py`:

- entry(): one offline Qwen visual+LLM forward step on the flagship model
  (Qwen-generation Flash-VStream) on one card;
- dryrun_multichip(n): the sharded training step (dp x tp under ZeRO with
  grad accumulation, the Qwen QLoRA step, tp decode), the pp and sp
  sections and the disaggregated serve dry run, over n gloo ranks on the
  CPU (the port's counterpart of JAX's virtual CPU mesh).

    python -m flash_vstream_tpu_torch.entry [--device cpu]
    python -m flash_vstream_tpu_torch.entry --dryrun-multichip 4
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .core.config import (FlashMemoryConfig, LLMConfig, QWEN2_VL_VIT,
                          VStreamQwenConfig)
from .core.device import resolve_device

ENTRY_GRID = (8, 16, 16)       # 16 frames at 224 x 224: (t, h, w) patches
ENTRY_TEXT = 32                # text ids before and after the video


def entry_config() -> VStreamQwenConfig:
    """JAX's entry config: the full Qwen2-VL vision tower (32 layers, 1280
    hidden, dual-resolution stream) with its merger to 1536, and a
    Qwen2-VL-2B-shaped decoder (28 layers, 1536 hidden, GQA 12/2, M-RoPE,
    151936 vocab)."""
    return VStreamQwenConfig(
        vit=dataclasses.replace(QWEN2_VL_VIT, merger_out_dim=1536),
        llm=LLMConfig(vocab_size=151936, hidden_size=1536,
                      intermediate_size=8960, num_layers=28, num_heads=12,
                      num_kv_heads=2, attention_bias=True, rope_theta=1e6,
                      mrope_sections=(16, 24, 24)),
        flash_memory=FlashMemoryConfig(temporal_length=16, spatial_length=8),
    )


def entry(cfg: Optional[VStreamQwenConfig] = None, device=None):
    """(fn, example_args): one offline Qwen visual+LLM forward step (video
    patches -> dual-resolution ViT -> Flash memory -> merger -> decoder ->
    logits) over 16 frames at 224 x 224, as JAX's `entry()`.

    `cfg` defaults to `entry_config()` (about 5.4 GB of bf16 weights); the
    weights are drawn on `device` (default: the card; the CPU only when
    asked) from a torch generator seeded with 0. The patches and ids come
    from `np.random.default_rng(0)` as JAX draws them. `fn(params, patches,
    input_ids, draws)` returns the logits [1, S, vocab]; `draws` (n -> [n]
    uniforms) stands for JAX's PRNG key in the Flash memory's k-means."""
    from .models.llm import decoder_forward, embed_tokens, lm_head
    from .models.vstream_qwen import (build_qwen_positions, encode_video,
                                      init_qwen_params)
    from .runtime.pipeline import seeded_draws

    cfg = entry_config() if cfg is None else cfg
    device = resolve_device(device)
    params = init_qwen_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        dtype=torch.bfloat16)

    t, gh, gw = grid = ENTRY_GRID
    pd = 3 * cfg.vit.temporal_patch_size * cfg.vit.patch_size ** 2
    dam = min(t, cfg.flash_memory.dam_grid_len) * gh * gw // 4
    csm = min(t, cfg.flash_memory.csm_grid_len) * (gh // 2) * (gw // 2) // 4
    n_vis = dam + csm
    S = ENTRY_TEXT + n_vis + ENTRY_TEXT     # text | video | text
    start = ENTRY_TEXT // 2

    @torch.no_grad()
    def fn(params, patches, input_ids, draws):
        vis = encode_video(params, cfg, patches, grid, draws=draws)
        embeds = embed_tokens(params["llm"], input_ids)
        embeds = torch.cat([
            embeds[:, :start],
            vis.video_embeds[None].to(embeds.dtype),
            embeds[:, start + n_vis:],
        ], dim=1)
        positions, _ = build_qwen_positions(S, start, n_vis,
                                            vis.visual_positions)
        h = decoder_forward(params["llm"], cfg.llm, embeds, positions)
        return lm_head(params["llm"], cfg.llm, h)

    rng = np.random.default_rng(0)
    patches = torch.from_numpy(
        rng.normal(size=(t * gh * gw, pd)).astype(np.float32)).to(device)
    input_ids = torch.from_numpy(
        rng.integers(0, cfg.llm.vocab_size, size=(1, S))).to(device)
    return fn, (params, patches, input_ids, seeded_draws(0, device))


# -- dryrun_multichip -------------------------------------------------------

def _draws(table, section: str, micro: int, sample: int, seed: int):
    """n -> [n] uniforms of one sample of a loss: from `table` (JAX's
    uniforms, {(section, micro, sample): {n: array}}) when given, else from
    a torch generator seeded by (seed, micro, sample)."""
    def draws(n: int) -> torch.Tensor:
        if table is not None:
            return torch.from_numpy(np.array(
                table[(section, micro, sample)][n], np.float32))
        g = torch.Generator().manual_seed(seed * 1000 + micro * 100 + sample)
        return torch.rand(n, generator=g)
    return draws


def _tree(inputs, name: str, init):
    """A parameter tree: `inputs[name]` (numpy) carried to the CPU, else
    init()."""
    from .weights.from_jax import params_from_numpy
    if inputs is not None and name in inputs:
        return params_from_numpy(inputs[name], "cpu")
    return init()


def _llava_step(mesh, rng, inputs):
    """LLaVA's vision -> STAR memory -> LLM loss, one Trainer step of grad
    accumulation 2 over the dp x tp mesh at ZeRO 3 (JAX's first section)."""
    from .core.config import tiny_llava_config
    from .models.llm import cross_entropy_loss
    from .models.vstream_llava import (init_llava_params, llava_forward_train,
                                       star_valid_counts)
    from .train.trainer import TrainConfig, Trainer
    cfg = tiny_llava_config()
    params = _tree(inputs, "llava", lambda: init_llava_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    table = None if inputs is None else inputs.get("draws")
    T, S_text, image_slot = 4, 24, 8
    n_mem = sum(star_valid_counts(cfg, T))
    S_full = S_text - 1 + n_mem
    dp, d = mesh.dp.size, mesh.dp.rank

    def loss_fn(params, batch, key):
        _, micro = key
        logits = llava_forward_train(
            params, cfg, torch.from_numpy(batch["images"]),
            torch.from_numpy(batch["n_frames"]),
            torch.from_numpy(batch["input_ids"]), image_slot, n_mem,
            draws=lambda b, n: _draws(table, "llava", micro, d + b, 0)(n),
            remat=True)
        return cross_entropy_loss(logits, torch.from_numpy(batch["labels"]))

    tcfg = TrainConfig(learning_rate=1e-3, total_steps=4, grad_accum=2,
                       projector_lr=2e-3, zero_stage=3)
    trainer = Trainer(loss_fn, params, tcfg, mesh=mesh)
    S = cfg.vit.image_size
    batch = {
        "images": rng.normal(size=(2, dp, T, 3, S, S)).astype(np.float32),
        "n_frames": np.full((2, dp), T, np.int64),
        "input_ids": rng.integers(1, 200, size=(2, dp, S_text)),
        "labels": rng.integers(1, 200, size=(2, dp, S_full)),
    }
    local = {k: v[:, d:d + 1] for k, v in batch.items()}
    loss = mesh.dp.all_reduce(torch.tensor(trainer.run_step(local, 0)),
                              "mean")
    if not torch.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return float(loss), cfg, trainer.gathered_params()


def _qwen_qlora_step(info, mesh, rng, inputs):
    """The flagship family's QLoRA step: Flash memory inside the loss (t 6
    above both memory budgets, so the clustering and the retrieval run),
    a frozen int8 base, rank-4 adapters, grad accumulation 2 at ZeRO 3 over
    the dp rows; a tp group's ranks hold the same (the Trainer's tp rules
    do not split quantized leaves)."""
    from .core.config import tiny_qwen_config
    from .models.llm import (cross_entropy_loss, decoder_forward,
                             embed_tokens, lm_head)
    from .models.vstream_qwen import (build_qwen_positions, encode_video,
                                      init_qwen_params, visual_token_count)
    from .parallel.collectives import single_group
    from .parallel.sharding import RankMesh
    from .train.lora import QWEN_TARGETS, init_lora_params, lora_views
    from .train.trainer import TrainConfig, Trainer
    from .weights.from_jax import lora_from_numpy
    from .weights.quantize import quantize_params
    qcfg = tiny_qwen_config()
    base = quantize_params(_tree(inputs, "qwen", lambda: init_qwen_params(
        qcfg, torch.Generator().manual_seed(1), "cpu")))
    if inputs is not None and "qwen_lora" in inputs:
        lora = lora_from_numpy(inputs["qwen_lora"], "cpu")
    else:
        lora = init_lora_params(torch.Generator().manual_seed(2), base,
                                rank=4, targets=QWEN_TARGETS)
    table = None if inputs is None else inputs.get("draws")
    qt, qh, qw = grid = (6, 8, 8)
    qpd = 3 * 2 * 14 * 14
    n_dam, n_csm = visual_token_count(qcfg, qt, qh, qw)
    n_vis, start = n_dam + n_csm, 8
    SQ = start + n_vis + 8
    dp_mesh = RankMesh(info, mesh.dp, single_group(), None)
    dp, d = mesh.dp.size, mesh.dp.rank

    def one(lora_params, base, patches, ids, labels, draws):
        eff = lora_views(base, lora_params, alpha=8.0, rank=4)
        vis = encode_video(eff, qcfg, patches, grid, draws=draws)
        positions, _ = build_qwen_positions(SQ, start, n_vis,
                                            vis.visual_positions)
        embeds = embed_tokens(eff["llm"], ids[None])
        embeds = torch.cat([embeds[:, :start],
                            vis.video_embeds[None].to(embeds.dtype),
                            embeds[:, start + n_vis:]], dim=1)
        h = decoder_forward(eff["llm"], qcfg.llm, embeds, positions,
                            remat=True)
        return cross_entropy_loss(lm_head(eff["llm"], qcfg.llm, h),
                                  labels[None])

    def loss_fn(lora_params, batch, key, base):
        _, micro = key
        B = batch["ids"].shape[0]
        return torch.stack([one(
            lora_params, base, torch.from_numpy(batch["patches"][b]),
            torch.from_numpy(batch["ids"][b]),
            torch.from_numpy(batch["labels"][b]),
            _draws(table, "qwen", micro, d * B + b, 1)) for b in range(B)
        ]).mean()

    tcfg = TrainConfig(learning_rate=1e-3, total_steps=2, grad_accum=2,
                       zero_stage=3)
    trainer = Trainer(loss_fn, lora, tcfg, mesh=dp_mesh, frozen=base)
    batch = {
        "patches": rng.normal(size=(2, dp, qt * qh * qw, qpd)).astype(
            np.float32),
        "ids": rng.integers(1, 200, size=(2, dp, SQ)),
        "labels": rng.integers(1, 200, size=(2, dp, SQ)),
    }
    local = {k: v[:, d:d + 1] for k, v in batch.items()}
    loss = mesh.dp.all_reduce(torch.tensor(trainer.run_step(local, 1)),
                              "mean")
    if not torch.isfinite(loss):
        raise AssertionError(f"non-finite qwen loss {loss}")
    return float(loss)


def _tp_decode(n_devices, llm, cfg, rng):
    """The trained LLaVA decoder split over a (1, n) mesh of CPU entries,
    4 greedy tokens with an f32 cache (JAX's serving section)."""
    from .models.llm import Qwen2Decoder, embed_tokens
    from .parallel.inference import shard_params_for_inference
    from .parallel.sharding import create_mesh
    from .runtime.generation import GenerationConfig, Generator
    ids = torch.from_numpy(rng.integers(1, 200, size=(1, 12)))
    with torch.no_grad():
        dec, _ = shard_params_for_inference(
            Qwen2Decoder(cfg.llm, llm),
            mesh=create_mesh(dp=1, tp=n_devices, devices=["cpu"] * n_devices))
        out = Generator(dec, max_len=256, cache_dtype=torch.float32).generate(
            embed_tokens(llm, ids), torch.arange(12)[None],
            GenerationConfig(max_new_tokens=4, eos_token_ids=()))
    if len(out) != 4:
        raise AssertionError(out)
    return len(out)


PP_CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_layers=28, num_heads=4, num_kv_heads=2)


def _pp_sp(info, n_devices, rng, inputs):
    """Pipeline parallelism at production depth (28 layers over a dp x pp
    grid, 2 micro-batches) and sequence parallelism (the ring-attention
    decoder over dp x sp) on batches of their own, each loss against the
    plain stack's within 1e-4, every gradient finite (JAX's pp and sp
    sections)."""
    from .core.config import LLMConfig
    from .models.llm import (cross_entropy_loss, decoder_forward,
                             embed_tokens, init_llm_params, lm_head)
    from .parallel.collectives import single_group, token_mean
    from .parallel.pipeline import last_stage_loss, pipeline_decoder_forward
    from .parallel.sequence import sp_decoder_forward, sp_nll
    from .parallel.sharding import create_rank_mesh
    from .train.lora import tree_leaves_with_path
    pcfg = LLMConfig(**PP_CFG)
    stage = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    params = _tree(inputs, "pp", lambda: init_llm_params(
        pcfg, torch.Generator().manual_seed(3), "cpu"))
    pos = torch.arange(16)[None].expand(4, 16)
    out = {"stage": stage}
    for kind in ("pp", "sp"):
        ids = rng.integers(0, 128, size=(4, 16))
        mesh = create_rank_mesh(info=info, **{kind: stage})
        dp, d = mesh.dp.size, mesh.dp.rank
        rows = slice(d * 4 // dp, (d + 1) * 4 // dp)
        local = torch.from_numpy(ids[rows])
        p = params
        for _, x in tree_leaves_with_path(p):
            x.requires_grad_(True)
            x.grad = None
        embeds = embed_tokens(p, local)
        if kind == "pp":
            h = pipeline_decoder_forward(p, pcfg, embeds, pos[rows],
                                         mesh=mesh, n_micro=2)
            loss = last_stage_loss(h, mesh, lambda h: cross_entropy_loss(
                lm_head(p, pcfg, h), local))
        else:
            h = sp_decoder_forward(p, pcfg, embeds, pos[rows], mesh=mesh)
            loss = token_mean(*sp_nll(p, pcfg, h, local, mesh),
                              single_group())
        loss.backward()
        value = float(mesh.dp.all_reduce(loss.detach(), "mean"))
        with torch.no_grad():
            full = torch.from_numpy(ids)
            hh = decoder_forward(params, pcfg, embed_tokens(params, full),
                                 pos)
            ref = float(cross_entropy_loss(lm_head(params, pcfg, hh), full))
        if not (np.isfinite(value) and abs(value - ref) < 1e-4):
            raise AssertionError(f"{kind}: loss {value} against {ref}")
        if not all(torch.isfinite(x.grad).all()
                   for _, x in tree_leaves_with_path(p)
                   if x.grad is not None):
            raise AssertionError(f"{kind}: a gradient is not finite")
        out[kind] = value
    if abs(out["pp"] - out["sp"]) <= 1e-6:
        raise AssertionError("pp/sp probes should be distinct data")
    return out


def _serve2(n_devices: int, rng, inputs) -> str:
    """The disaggregated concurrent serve: ingest (the vision tower and
    Flash memory) on one entry, the decoder split over the next (2 with 3
    devices or more, else 1), all CPU entries; an answer on a thread
    against a captured snapshot while later clips ingest, its text equal to
    a one-device session's on the same snapshot (JAX's serve2 dry run)."""
    import threading

    from .core.config import tiny_qwen_config
    from .models.vstream_qwen import VStreamQwen, init_qwen_params
    from .parallel.inference import TPDecoder
    from .parallel.serve import make_serve_placement
    from .preprocess.qwen_processor import make_byte_qwen_tokenizer
    from .runtime.generation import GenerationConfig
    from .runtime.streaming import QwenStreamSession
    cfg = tiny_qwen_config()
    params = _tree(inputs, "serve", lambda: init_qwen_params(
        cfg, torch.Generator().manual_seed(7), "cpu"))
    tok = make_byte_qwen_tokenizer()
    n_decode = 2 if n_devices >= 3 else 1
    placement = make_serve_placement(n_ingest=1, n_decode=n_decode,
                                     devices=["cpu"] * (1 + n_decode))

    def mk(p):
        return QwenStreamSession(VStreamQwen(cfg, params), tok,
                                 frame_hw=(56, 56), clip_size=2,
                                 bank_size=32, max_len=512, placement=p)

    dis, ref = mk(placement), mk(None)
    frames = [rng.integers(0, 255, (56, 56, 3), np.uint8) for _ in range(8)]
    gen = GenerationConfig(max_new_tokens=4, eos_token_ids=())
    for s in (dis, ref):
        s.ingest_frames(frames[0:2])
        s.ingest_frames(frames[2:4])
        s.block_until_ingested()
    if not (isinstance(dis.llm, TPDecoder) and len(dis.llm.shards) == n_decode
            and dis.state.tem_x.device == placement.ingest_device):
        raise AssertionError("the placement is not the one asked for")
    q = "What is happening?"
    snap, nf = dis._published
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "dis", dis.answer_snapshot(snap, nf, q, gen)))
    th.start()
    dis.ingest_frames(frames[4:6])     # ingest goes on while it answers
    dis.ingest_frames(frames[6:8])
    dis.block_until_ingested()
    th.join(timeout=600)
    if th.is_alive():
        raise AssertionError("disaggregated answer deadlocked")
    rsnap, rnf = ref._published
    if out["dis"] != ref.answer_snapshot(rsnap, rnf, q, gen):
        raise AssertionError("the disaggregated answer parts from the "
                             "one-device session's")
    if int(dis.n_frames) != 4:         # 8 frames = 4 temporal pairs
        raise AssertionError(dis.n_frames)
    return (f"serve2[ingest=1,tp={n_decode}]: concurrent-answer=="
            f"single-chip, clips-during-answer=2")


def _dryrun_rank(out: str, n_devices: int, inputs) -> None:
    """One rank of dryrun_multichip: every section in JAX's order and with
    its draws of one np.random.default_rng(0); rank 0 writes the result."""
    from .parallel.collectives import init_distributed
    from .parallel.sharding import create_rank_mesh
    info = init_distributed("cpu")
    rng = np.random.default_rng(0)
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = create_rank_mesh(info=info, tp=tp)
    res = {"mesh": dict(mesh.shape)}
    res["llava"], cfg, whole = _llava_step(mesh, rng, inputs)
    res["qwen"] = _qwen_qlora_step(info, mesh, rng, inputs)
    res["decode"] = _tp_decode(n_devices, whole["llm"], cfg, rng)
    res.update(_pp_sp(info, n_devices, rng, inputs))
    res["serve2"] = _serve2(n_devices, rng, inputs)
    if info.rank == 0:
        torch.save(res, os.path.join(out, "result.pt"))


def dryrun_multichip(n_devices: int, inputs: Optional[dict] = None) -> dict:
    """The sharded training step and the parallel sections of JAX's
    `dryrun_multichip` over `n_devices` gloo ranks on the CPU (processes
    started by `parallel.collectives.spawn`): the tiny LLaVA dp x tp step
    under ZeRO 3 with grad accumulation, the Qwen QLoRA step, tp decode of
    the trained decoder, the 28-layer pp and sp probes and the
    disaggregated serve. Prints JAX's summary line and returns its numbers.

    `inputs` carries another run's numbers in: numpy parameter trees
    ("llava", "qwen" before quantization, "qwen_lora", "pp", "serve") and
    "draws", {(section, micro, sample): {n: uniforms}} for the Flash and
    STAR memories; without it the ranks draw their own from seeded torch
    generators."""
    import tempfile

    from .parallel.collectives import spawn
    with tempfile.TemporaryDirectory() as d:
        spawn(_dryrun_rank, n_devices, d, n_devices, inputs,
              init_file=os.path.join(d, "init"))
        res = torch.load(os.path.join(d, "result.pt"))
    stage = res["stage"]
    print(f"dryrun_multichip({n_devices}): mesh={res['mesh']} "
          f"llava-loss={res['llava']:.4f} qwen-qlora-loss={res['qwen']:.4f} "
          f"tp{n_devices}-decode={res['decode']}tok "
          f"pp{stage}x dp{n_devices // stage} 28L-loss={res['pp']:.4f} "
          f"sp{stage}x dp{n_devices // stage} 28L-loss={res['sp']:.4f} "
          f"{res['serve2']} OK", flush=True)
    return res


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    p.add_argument("--dryrun-multichip", type=int, default=0, metavar="N",
                   help="run dryrun_multichip(N) over N gloo ranks on the "
                        "CPU instead of the forward")
    a = p.parse_args()
    if a.dryrun_multichip:
        dryrun_multichip(a.dryrun_multichip)
    else:
        fn, args = entry(device=a.device)
        print("entry forward:", tuple(fn(*args).shape))
