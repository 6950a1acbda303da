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
