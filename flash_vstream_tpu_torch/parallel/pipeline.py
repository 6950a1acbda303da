"""Pipeline parallelism: a GPipe schedule over the ranks of a 'pp' group.

Port of flash_vstream_tpu/parallel/pipeline.py:42-144. Stage i holds the
layers [i L/S, (i + 1) L/S) of the stacked decoder tree (`layer_slice`);
the batch splits into `n_micro` micro-batches along dim 0 (sequences are
never split, so causal masking inside a micro-batch is unchanged), and
each stage runs every micro-batch in turn: stage 0 from the embeddings,
the others from the activations the stage before sends
(`collectives.recv_forward`), each sending its output on to the next
(`send_forward`). The backward pipeline falls out of autograd: a stage's
receive sends its gradient back and its send receives the next stage's,
as `jax.grad` transposes `ppermute`.

Where JAX's scan runs every stage at every tick and masks the bubble, a
stage here runs only its own micro-batches: the point-to-point sends are
tagged by micro-batch and asynchronous, so a stage waits only on its
input. The final norm runs on the last stage, which alone returns the
hidden states; the loss runs there once (`last_stage_loss`) and its value
is broadcast, where JAX's loss runs once outside shard_map. The caller
sums the gradients over the pp group: a stage's are zero outside what it
ran (embed, the visual encoder: stage 0; final_norm, lm_head: the last).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.config import LLMConfig
from ..models.layers import layer_slice, rms_norm
from ..models.llm import _checkpoint, _rope_for, decoder_block
from .collectives import recv_forward, send_forward
from .sharding import RankMesh, create_rank_mesh


def create_pp_mesh(pp: Optional[int] = None, device=None) -> RankMesh:
    """The dp x pp grid over the world of ranks (pp None: every rank a
    stage)."""
    from .collectives import init_distributed
    info = init_distributed(device)
    return create_rank_mesh(pp=pp or info.world, info=info)


def _stage_layers(layers: dict, cfg: LLMConfig, stage: int, n_stages: int
                  ) -> dict:
    """The stage's run of the stacked layers; a tree that already holds
    only the stage's L / S layers (`stage_params`) as it is."""
    per = cfg.num_layers // n_stages
    if layers["attn_norm"].shape[0] == per:
        return layers
    return layer_slice(layers, slice(stage * per, (stage + 1) * per))


def stage_params(params: dict, cfg: LLMConfig, mesh: RankMesh) -> dict:
    """The decoder tree a stage needs (its own copy of its layers, the rest
    shared), so a stage holds L / S layers of the weights."""
    layers = _stage_layers(params["layers"], cfg, mesh.inner.rank,
                           mesh.inner.size)
    return {**params, "layers": {k: _clone(v) for k, v in layers.items()}}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):          # a quantized leaf's fields
        return type(tree)(*(f.clone() for f in tree))
    return tree.clone()


def pipeline_decoder_forward(
    params: dict,                  # LLM tree (stacked layers [L, ...])
    cfg: LLMConfig,
    input_embeds: Optional[torch.Tensor],   # [B, S, D] on stage 0
    positions: torch.Tensor,       # [B, S] or [3, B, S]
    *,
    mesh: RankMesh,
    n_micro: int,
    segment_ids: Optional[torch.Tensor] = None,   # [B, S]; -1 = padding
    remat: bool = True,
) -> torch.Tensor:
    """The pipelined no-cache decoder stack. On the last stage: the final
    hidden states [B, S, D] after final_norm, equal to `decoder_forward`'s.
    On the other stages: a 0-d tie to hand to `last_stage_loss`, whose
    backward runs this stage's. Only stage 0 reads `input_embeds` (the
    others may pass None); `remat` checkpoints each layer."""
    group = mesh.inner
    n_stages, stage = group.size, group.rank
    L = cfg.num_layers
    if L % n_stages:
        raise ValueError(f"layers {L} % stages {n_stages} != 0")
    cos, sin = _rope_for(cfg, positions)          # [B, S, hd]
    B, S = cos.shape[:2]
    if B % n_micro:
        raise ValueError(f"batch {B} % n_micro {n_micro} != 0")
    Bm = B // n_micro
    layers = _stage_layers(params["layers"], cfg, stage, n_stages)
    n_local = L // n_stages
    like = torch.empty((Bm, S, cfg.hidden_size), device=cos.device,
                       dtype=(input_embeds.dtype if input_embeds is not None
                              else layers["attn_norm"].dtype))
    pending, ties, ys = [], [], []
    for m in range(n_micro):
        rows = slice(m * Bm, (m + 1) * Bm)
        rope = (cos[rows], sin[rows])
        seg = segment_ids[rows] if segment_ids is not None else None

        def layer(x, j, rope=rope, seg=seg):
            return decoder_block(layer_slice(layers, j), cfg, x, rope, seg)

        x = (input_embeds[rows] if stage == 0
             else recv_forward(like, group, stage - 1, m))
        for j in range(n_local):
            x = _checkpoint(layer, x, j) if remat else layer(x, j)
        if stage < n_stages - 1:
            ties.append(send_forward(x, group, stage + 1, m, pending))
        else:
            ys.append(x)
    for work, _ in pending:
        work.wait()
    if stage < n_stages - 1:
        return torch.stack(ties).sum()
    h = torch.cat(ys) if len(ys) > 1 else ys[0]
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps)


def last_stage_loss(out: torch.Tensor, mesh: RankMesh,
                    loss_fn: Callable[[torch.Tensor], torch.Tensor]
                    ) -> torch.Tensor:
    """loss_fn(hidden states) on the last stage, once; its value on every
    stage. The last stage's loss carries its graph; another stage's is the
    value plus its tie times zero, so its backward drives that stage's
    sends (which receive the real gradients)."""
    group = mesh.inner
    last = group.size - 1
    if group.rank == last:
        loss = loss_fn(out).float()
        group.broadcast(loss.detach().clone(), src=last)
        return loss
    value = torch.zeros((), dtype=torch.float32, device=out.device)
    group.broadcast(value, src=last)
    return value + out * 0
