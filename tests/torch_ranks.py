"""Rank workers of the training-across-ranks tests.

Each function runs in a process of its own, started by
`flash_vstream_tpu_torch.parallel.collectives.spawn` (gloo over the CPU,
init through a file in the test's tmp_path), and writes what the test
compares to `<out>/rank<r>.pt`. The module imports neither JAX nor the JAX
package, so a rank never does (test_torch_no_jax.py checks it in a rank).
Several cases run in one spawn: starting ranks costs more than a tiny
model's steps.
"""
import os
import sys

import numpy as np
import torch

from flash_vstream_tpu_torch.core.config import LLMConfig
from flash_vstream_tpu_torch.models.layers import layer_slice
from flash_vstream_tpu_torch.models.llm import (cross_entropy_loss,
                                                decoder_forward,
                                                embed_tokens, lm_head)
from flash_vstream_tpu_torch.parallel.collectives import init_distributed
from flash_vstream_tpu_torch.parallel.sharding import (ZeroShard,
                                                       create_rank_mesh)
from flash_vstream_tpu_torch.train.lora import tree_leaves_with_path
from flash_vstream_tpu_torch.train.trainer import _tensor as _local
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy


def _save(out: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out, f"rank{rank}.pt"))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy().copy()


def lm_loss_fn(cfg: LLMConfig):
    """The JAX tests' `lm_loss` (tests/test_trainer_parallel.py): the
    decoder over ids, cross entropy against labels."""
    def loss(params, batch, key, frozen=None):
        ids = torch.from_numpy(np.asarray(batch["ids"]))
        labels = torch.from_numpy(np.asarray(batch["labels"]))
        pos = torch.arange(ids.shape[1])[None].expand(ids.shape)
        h = decoder_forward(params, cfg, embed_tokens(params, ids), pos)
        out = cross_entropy_loss(lm_head(params, cfg, h), labels)
        if frozen is not None:       # the JAX test's 0 x a frozen leaf
            gate = layer_slice(frozen["layers"], 0)["mlp"]["gate"]["w"]
            out = out + 0.0 * gate[0, 0]
        return out
    return loss


def train_cases(out: str, cfg_kw: dict, params_np: dict, batches: list,
                cases: list, ckpt_dir: str = None, ckpt_after: int = 0):
    """Trainer steps for each case (zero_stage, offload, TrainConfig
    kwargs, with a frozen tree) over `batches` (global [accum, B, ...]
    numpy), each rank its share of B. Writes per case the losses, the whole
    parameters after the steps (rank 0), each rank's shard and moment
    shapes, and whether the frozen tree rests sharded. With `ckpt_dir`, the
    last case saves its gathered state after `ckpt_after` steps (rank 0
    writes)."""
    from flash_vstream_tpu_torch.train.checkpoint import save_checkpoint
    from flash_vstream_tpu_torch.train.trainer import TrainConfig, Trainer
    info = init_distributed("cpu")
    mesh = create_rank_mesh(info=info)
    cfg = LLMConfig(**cfg_kw)
    dp, d = mesh.dp.size, mesh.dp.rank
    res = []
    for stage, offload, kw, with_frozen in cases:
        params = params_from_numpy(params_np, "cpu")
        frozen = params_from_numpy(params_np, "cpu") if with_frozen else None
        tr = Trainer(lm_loss_fn(cfg), params,
                     TrainConfig(zero_stage=stage, offload_moments=offload,
                                 **kw),
                     frozen=frozen, mesh=mesh)
        losses = []
        last = (stage, offload, kw, with_frozen) == cases[-1]
        for s, b in enumerate(batches):
            Bl = b["ids"].shape[1] // dp
            local = {k: v[:, d * Bl:(d + 1) * Bl] for k, v in b.items()}
            losses.append(tr.run_step(local, s))
            if ckpt_dir is not None and last and s + 1 == ckpt_after:
                p_whole, state = tr.gathered_state()
                if info.rank == 0:
                    save_checkpoint(ckpt_dir, s + 1, p_whole, state)
        whole = tr.gathered_params()
        shards = {p: tuple((x.shard if isinstance(x, ZeroShard) else x)
                           .shape)
                  for p, x in tree_leaves_with_path(tr.params)}
        mu = {p: tuple(x.shape) for p, x in tr.opt_state["mu"].items()}
        frozen_sharded = (None if frozen is None else isinstance(
            tr.frozen["layers"]["mlp"]["gate"]["w"], ZeroShard))
        res.append(dict(losses=losses, shards=shards, mu=mu,
                        frozen_sharded=frozen_sharded,
                        params=_np_tree(whole) if info.rank == 0 else None))
    _save(out, info.rank, res)


def modules_seen(out: str):
    """Which of jax and the JAX package a rank has imported after joining
    its group and running a collective."""
    info = init_distributed("cpu")
    mesh = create_rank_mesh(info=info)
    mesh.dp.all_reduce(torch.ones(1))
    _save(out, info.rank, sorted(m for m in ("jax", "flash_vstream_tpu")
                                 if m in sys.modules))


def decoder_runs(out: str, runs: list):
    """For each run (a dict: cfg_kw, params, ids, labels, positions, kind
    "pp" or "sp", width, n_micro, seg or None; or kind "ring": q, k, v,
    seg, width, for `ring_attention_local` alone), the hidden states and every
    leaf's gradient of the shifted cross entropy through
    `pipeline_decoder_forward` or `sp_decoder_forward` on this rank's dp
    share of the batch. Each rank writes its hidden states (the last
    stage's, or its sequence chunk), the loss (averaged over dp) and the
    gradients summed over the pp/sp group and averaged over dp."""
    from flash_vstream_tpu_torch.parallel.collectives import token_mean
    from flash_vstream_tpu_torch.parallel.pipeline import (
        last_stage_loss, pipeline_decoder_forward)
    from flash_vstream_tpu_torch.parallel.sequence import (sp_decoder_forward,
                                                           sp_nll)
    info = init_distributed("cpu")
    res = []
    for run in runs:
        kind, width = run["kind"], run["width"]
        mesh = create_rank_mesh(pp=width if kind == "pp" else 1,
                                sp=width if kind != "pp" else 1, info=info)
        if kind == "ring":
            res.append(_ring(run, mesh))
            continue
        cfg = LLMConfig(**run["cfg_kw"])
        dp, d = mesh.dp.size, mesh.dp.rank
        Bl = run["ids"].shape[0] // dp
        rows = slice(d * Bl, (d + 1) * Bl)
        params = params_from_numpy(run["params"], "cpu")
        for _, x in tree_leaves_with_path(params):
            x.requires_grad_(True)
        lab = torch.from_numpy(run["labels"][rows])
        pos = torch.from_numpy(run["positions"][..., rows, :])
        seg = (None if run["seg"] is None
               else torch.from_numpy(run["seg"][rows]))
        embeds = embed_tokens(params, torch.from_numpy(run["ids"][rows]))
        if kind == "pp":
            h = pipeline_decoder_forward(params, cfg, embeds, pos, mesh=mesh,
                                         n_micro=run["n_micro"],
                                         segment_ids=seg)

            def ce(h):
                return token_mean(*_nll(params, cfg, h, lab), mesh.dp)
            loss = last_stage_loss(h, mesh, ce)
        else:
            h = sp_decoder_forward(params, cfg, embeds, pos, mesh=mesh,
                                   segment_ids=seg)
            loss = token_mean(*sp_nll(params, cfg, h, lab, mesh), mesh.dp)
        loss.backward()
        grads = {}
        for p, x in tree_leaves_with_path(params):
            g = x.grad if x.grad is not None else torch.zeros_like(x)
            grads[p] = mesh.dp.all_reduce(mesh.inner.all_reduce(g),
                                          "mean").numpy()
        last = mesh.inner.rank == mesh.inner.size - 1
        res.append(dict(
            loss=float(mesh.dp.all_reduce(loss.detach(), "mean")),
            h=(h.detach().numpy() if kind == "sp" or last else None),
            rows=(rows.start, rows.stop), inner_rank=mesh.inner.rank,
            grads=grads if info.rank == 0 else None))
    _save(out, info.rank, res)


def _ring(run: dict, mesh):
    """This rank's chunk of `ring_attention_local` over the run's q, k, v
    [B, H, S, D] (and seg), on the first dp row's ring; None elsewhere."""
    from flash_vstream_tpu_torch.parallel.sequence import ring_attention_local
    if mesh.dp.rank:
        return None
    n, r = mesh.inner.size, mesh.inner.rank
    Sl = run["q"].shape[2] // n
    part = [torch.from_numpy(run[k][:, :, r * Sl:(r + 1) * Sl])
            for k in ("q", "k", "v")]
    seg = (None if run["seg"] is None
           else torch.from_numpy(run["seg"][:, r * Sl:(r + 1) * Sl]))
    return dict(out=ring_attention_local(
        *part, group=mesh.inner, causal=True, q_segment_ids=seg,
        kv_segment_ids=seg).numpy(), inner_rank=r)


def _nll(params, cfg, h, labels):
    from flash_vstream_tpu_torch.models.llm import nll_sum_chunked
    return nll_sum_chunked(params, cfg, h[:, :-1], labels[:, 1:])


def no_draws(step, micro, sample, n):
    """The draws of a run that must take none."""
    raise AssertionError(f"unexpected draws {(step, micro, sample, n)}")


def finetune_runs(out: str, runs: list, params_np: dict, lora_np: dict):
    """`finetune_flash.run_training` once per argv of `runs` (the tiny
    config, the test's base and adapters; the runs draw nothing), all in
    one process group; each rank writes the losses and the adapters."""
    from flash_vstream_tpu_torch.core.config import tiny_qwen_config
    from flash_vstream_tpu_torch.train import finetune_flash as tft
    from flash_vstream_tpu_torch.weights.from_jax import lora_from_numpy
    res = []
    for argv in runs:
        r = tft.run_training(tft.make_parser().parse_args(argv),
                             cfg=tiny_qwen_config(),
                             params=params_from_numpy(params_np, "cpu"),
                             lora=lora_from_numpy(lora_np, "cpu"),
                             kmeans_draws=no_draws)
        res.append(dict(losses=r["losses"], lora=_np_tree(r["lora"])))
    _save(out, int(os.environ["RANK"]), res)


def llava_run(out: str, argv: list, params: dict):
    """The LLaVA `train.run_training` over argv (the tiny LLaVA config, the
    test's parameters as a tree of CPU tensors, no draws, the byte
    tokenizer); each rank writes the losses and the trained parameters."""
    from flash_vstream_tpu_torch.core.config import tiny_llava_config
    from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
    from flash_vstream_tpu_torch.train import train as ttrain
    r = ttrain.run_training(ttrain.make_parser().parse_args(argv),
                            cfg=tiny_llava_config(),
                            params=params, tokenizer=ByteTokenizer(),
                            draws=no_draws)
    _save(out, int(os.environ["RANK"]),
          dict(losses=r["losses"],
               params={p: x.detach().numpy().copy()
                       for p, x in tree_leaves_with_path(r["params"])
                       if isinstance(x, torch.Tensor)}))


def tp_lm_loss_fn(cfg: LLMConfig):
    """`lm_loss_fn` whose frozen term reads this rank's part of a split
    gate (0 x a leaf either way)."""
    def loss(params, batch, key, frozen=None):
        ids = torch.from_numpy(np.asarray(batch["ids"]))
        labels = torch.from_numpy(np.asarray(batch["labels"]))
        pos = torch.arange(ids.shape[1])[None].expand(ids.shape)
        h = decoder_forward(params, cfg, embed_tokens(params, ids), pos)
        out = cross_entropy_loss(lm_head(params, cfg, h), labels)
        if frozen is not None:
            gate = layer_slice(frozen["layers"], 0)["mlp"]["gate"]["w"]
            out = out + 0.0 * _local(gate)[0, 0]
        return out
    return loss


def tp_train_cases(out: str, cfg_kw: dict, params_np: dict, batches: list,
                   runs: list, ckpt_dir: str = None, ckpt_after: int = 0):
    """For each run (tp, cases) of `runs`, a dp x tp mesh over the world
    and Trainer steps of each case (zero_stage, offload, TrainConfig
    kwargs, with a frozen tree) over `batches` (global [accum, B, ...]
    numpy), each dp row its share of B. Writes per case the losses, the
    whole parameters after the steps (rank 0), each rank's resting shapes
    of the parameters, the moments and the frozen gate, and the first
    step's reduced gradient of every leaf left whole over tp. With
    `ckpt_dir`, the last case of the last run saves its gathered state
    after `ckpt_after` steps (rank 0 writes)."""
    from flash_vstream_tpu_torch.train.checkpoint import save_checkpoint
    from flash_vstream_tpu_torch.train.trainer import TrainConfig, Trainer
    info = init_distributed("cpu")
    cfg = LLMConfig(**cfg_kw)
    res = []
    for tp, cases in runs:
        mesh = create_rank_mesh(info=info, tp=tp)
        dp, d = mesh.dp.size, mesh.dp.rank
        for case in cases:
            stage, offload, kw, with_frozen = case
            params = params_from_numpy(params_np, "cpu")
            frozen = (params_from_numpy(params_np, "cpu") if with_frozen
                      else None)
            tr = Trainer(tp_lm_loss_fn(cfg), params,
                         TrainConfig(zero_stage=stage,
                                     offload_moments=offload, **kw),
                         frozen=frozen, mesh=mesh)
            whole_g = {}
            real = tr._reduce

            def reduce(p, g, tr=tr, real=real, whole_g=whole_g):
                g = real(p, g)
                if tr.tp_dim[p] is None and p not in whole_g:
                    w = (tr.mesh.dp.all_gather(g, tr.zero_dim[p])
                         if p in tr.sharded else g)
                    whole_g[p] = w.detach().numpy().copy()
                return g
            tr._reduce = reduce
            losses = []
            last = (tp, case) == (runs[-1][0], runs[-1][1][-1])
            for s, b in enumerate(batches):
                Bl = b["ids"].shape[1] // dp
                local = {k: v[:, d * Bl:(d + 1) * Bl] for k, v in b.items()}
                losses.append(tr.run_step(local, s))
                if ckpt_dir is not None and last and s + 1 == ckpt_after:
                    p_whole, state = tr.gathered_state()
                    if info.rank == 0:
                        save_checkpoint(ckpt_dir, s + 1, p_whole, state)
            whole = tr.gathered_params()
            res.append(dict(
                tp=tp, dp=dp, case=case, losses=losses, whole_grads=whole_g,
                shards={p: tuple(_local(x).shape)
                        for p, x in tree_leaves_with_path(tr.params)},
                mu={p: tuple(x.shape) for p, x in tr.opt_state["mu"].items()},
                frozen_gate=(None if frozen is None else tuple(_local(
                    tr.frozen["layers"]["mlp"]["gate"]["w"]).shape)),
                params=_np_tree(whole) if info.rank == 0 else None))
    _save(out, info.rank, res)


def tp_tower_forwards(out: str, clip_kw: dict, clip_np: dict, images,
                      qvit_kw: dict, qvit_np: dict, patches, grid):
    """The CLIP tower and the Qwen2-VL ViT (both its varlen blocks and its
    frame-batched blocks) whole and split over tp = world, under the
    trees' 'vit' key as LLM_RULES name it; writes each pair."""
    from flash_vstream_tpu_torch.core.config import VitConfig
    from flash_vstream_tpu_torch.models.clip_vit import clip_encode
    from flash_vstream_tpu_torch.models.qwen2_vit import (
        prepare_vit_inputs, qwen_vit_blocks, qwen_vit_blocks_frames)
    from flash_vstream_tpu_torch.parallel.tensor import TPShard, tp_shard_tree
    info = init_distributed("cpu")
    mesh = create_rank_mesh(info=info, tp=info.world)
    whole = {"vit": params_from_numpy(clip_np, "cpu")}
    split = tp_shard_tree(whole, mesh)
    n_split = sum(isinstance(x, TPShard)
                  for _, x in tree_leaves_with_path(split))
    ccfg = VitConfig(**clip_kw)
    x = torch.from_numpy(images)
    with torch.no_grad():
        clip = (clip_encode(whole["vit"], ccfg, x).numpy(),
                clip_encode(split["vit"], ccfg, x).numpy())
    qcfg = VitConfig(**qvit_kw)
    qw = {"vit": params_from_numpy(qvit_np, "cpu")}
    qs = tp_shard_tree(qw, mesh)
    p = torch.from_numpy(patches)
    pos, seg = prepare_vit_inputs([grid], patches.shape[0])
    t, h, w = grid
    kw = dict(t_full=t, hw_full=(h, w), t_small=0, hw_small=(h, w))
    with torch.no_grad():
        blocks = (qwen_vit_blocks(qw["vit"], qcfg, p, pos, seg).numpy(),
                  qwen_vit_blocks(qs["vit"], qcfg, p, pos, seg).numpy())
        frames = (qwen_vit_blocks_frames(qw["vit"], qcfg, p, **kw).numpy(),
                  qwen_vit_blocks_frames(qs["vit"], qcfg, p, **kw).numpy())
    _save(out, info.rank, dict(clip=clip, blocks=blocks, frames=frames,
                               n_split=n_split))


def llava_main(out: str, argvs: list):
    """The LLaVA `train.run_training` once per argv (its dry-run model and
    data, its default draws), all in one process group; each rank writes
    the losses, the modalities and the gathered parameters."""
    from flash_vstream_tpu_torch.train import train as ttrain
    res = []
    for argv in argvs:
        r = ttrain.run_training(ttrain.make_parser().parse_args(argv))
        res.append(dict(losses=r["losses"], modalities=r["modalities"],
                        params={p: x.detach().numpy().copy()
                                for p, x in tree_leaves_with_path(
                                    r["params"])
                                if isinstance(x, torch.Tensor)}))
    _save(out, int(os.environ["RANK"]), res)


def trainer_bytes(out: str, tps: list):
    """For each tp of `tps`, a dp x tp mesh over the world and a Trainer
    of the stage-2 recipe (scripts/plan_full7b_memory.py) over the tiny
    LLaVA model in bf16; writes this rank's resting bytes of the
    parameters, mu and nu, as the plan names them."""
    from flash_vstream_tpu_torch.core.config import tiny_llava_config
    from flash_vstream_tpu_torch.models.vstream_llava import init_llava_params
    from flash_vstream_tpu_torch.scripts.plan_full7b_memory import (
        stage2_config)
    from flash_vstream_tpu_torch.train.trainer import Trainer
    info = init_distributed("cpu")
    res = []
    for tp in tps:
        mesh = create_rank_mesh(info=info, tp=tp)
        params = init_llava_params(tiny_llava_config(),
                                   torch.Generator().manual_seed(0), "cpu",
                                   dtype=torch.bfloat16)
        tr = Trainer(lambda *a: None, params, stage2_config(), mesh=mesh)
        held = dict(params_bytes=sum(
            _local(x).numel() * _local(x).element_size()
            for _, x in tree_leaves_with_path(tr.params)
            if isinstance(_local(x), torch.Tensor)))
        for k in ("mu", "nu"):
            held[f"{k}_bytes"] = sum(m.numel() * m.element_size()
                                     for m in tr.opt_state[k].values())
        res.append(dict(dp=mesh.dp.size, tp=tp, **held))
    _save(out, info.rank, res)


def tp_lora_loss_fn(cfg: LLMConfig, alpha: float, rank: int):
    """The LoRA loss of tests/test_torch_tp_lora.py: merge-free views of the
    adapters over the frozen base (split or whole as the mesh rests it),
    the decoder over ids, cross entropy against labels."""
    from flash_vstream_tpu_torch.train.lora import lora_views

    def loss(lp, batch, key, base):
        eff = lora_views(base, lp, alpha, rank)
        ids = torch.from_numpy(np.asarray(batch["ids"]))
        labels = torch.from_numpy(np.asarray(batch["labels"]))
        pos = torch.arange(ids.shape[1])[None].expand(ids.shape)
        h = decoder_forward(eff, cfg, embed_tokens(eff, ids), pos)
        return cross_entropy_loss(lm_head(eff, cfg, h), labels)
    return loss


def _resting(x):
    """A leaf's resting shape on this rank: a split leaf's part, or each
    field of a quantized leaf (which rests whole)."""
    if hasattr(x, "_fields"):
        return {f: tuple(v.shape) for f, v in zip(x._fields, x)}
    return tuple(_local(x).shape)


def tp_lora_cases(out: str, cfg_kw: dict, bases_np: dict, lora_np: dict,
                  batches: list, runs: list, tkw: dict, alpha: float,
                  rank: int):
    """For each run (tp, base names) of `runs`, a dp x tp mesh over the
    world and Trainer steps of the adapters over each named base (frozen)
    over `batches`, each dp row its share of B. Writes per case the
    losses, the adapters after the steps, the first step's reduced
    gradient of every adapter leaf, and each rank's resting shapes of the
    base's leaves and of the adapters."""
    from flash_vstream_tpu_torch.train.trainer import TrainConfig, Trainer
    from flash_vstream_tpu_torch.weights.from_jax import lora_from_numpy
    info = init_distributed("cpu")
    cfg = LLMConfig(**cfg_kw)
    res = []
    for tp, names in runs:
        mesh = create_rank_mesh(info=info, tp=tp)
        dp, d = mesh.dp.size, mesh.dp.rank
        for name in names:
            tr = Trainer(tp_lora_loss_fn(cfg, alpha, rank),
                         lora_from_numpy(lora_np, "cpu"),
                         TrainConfig(**tkw),
                         frozen=params_from_numpy(bases_np[name], "cpu"),
                         mesh=mesh)
            grads = {}
            real = tr._reduce

            def reduce(p, g, real=real, grads=grads):
                g = real(p, g)
                grads.setdefault(p, g.detach().numpy().copy())
                return g
            tr._reduce = reduce
            losses = []
            for s, b in enumerate(batches):
                Bl = b["ids"].shape[1] // dp
                local = {k: v[:, d * Bl:(d + 1) * Bl] for k, v in b.items()}
                losses.append(tr.run_step(local, s))
            res.append(dict(
                tp=tp, dp=dp, base=name, losses=losses, grads=grads,
                lora={p: x.detach().numpy().copy() for p, x in
                      tree_leaves_with_path(tr.gathered_params())},
                frozen={p: _resting(x)
                        for p, x in tree_leaves_with_path(tr.frozen)},
                adapters={p: tuple(_local(x).shape)
                          for p, x in tree_leaves_with_path(tr.params)}))
    _save(out, info.rank, res)


def tp_chunked_losses(out: str, cfg_kw: dict, params_np: dict, hidden,
                      labels, cases: list):
    """The chunked cross entropy over a vocab-split head at tp = world: for
    each case (tied, chunk, vocab_tile), the loss and the gradients of the
    hidden states and of the head (gathered whole), from the bare tree
    split by `LLM_RULES` (lm_head by columns, or the tied embed by vocab
    rows)."""
    from flash_vstream_tpu_torch.models.llm import cross_entropy_loss_chunked
    from flash_vstream_tpu_torch.parallel.tensor import TPShard, tp_shard_tree
    info = init_distributed("cpu")
    mesh = create_rank_mesh(info=info, tp=info.world)
    res = []
    for tied, chunk, tile in cases:
        cfg = LLMConfig(**cfg_kw, tie_word_embeddings=tied)
        whole = params_from_numpy(params_np, "cpu")
        if tied:
            del whole["lm_head"]
        split = tp_shard_tree(whole, mesh)
        head = split["embed"] if tied else split["lm_head"]
        assert isinstance(head, TPShard)
        w = head.local().requires_grad_()
        h = torch.from_numpy(hidden).requires_grad_()
        loss = cross_entropy_loss_chunked(
            split, cfg, h, torch.from_numpy(labels), chunk=chunk,
            vocab_tile=tile)
        gh, gw = torch.autograd.grad(loss, (h, w))
        res.append(dict(loss=loss.item(), gh=gh.numpy(),
                        gw=mesh.tp.all_gather(gw, head.dim).numpy()))
    _save(out, info.rank, res)
