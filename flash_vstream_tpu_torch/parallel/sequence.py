"""Sequence parallelism: ring attention over the ranks of an 'sp' group.

Port of flash_vstream_tpu/parallel/sequence.py:39-195. The sequence splits
into sp equal chunks, rank r holding tokens [r S/sp, (r + 1) S/sp) of every
layer; RMS norms, projections and the MLP are position-local, and
attention runs as a ring: each rank's queries stay, the K/V chunks rotate
neighbour to neighbour (`collectives.ring_shift`, JAX's `ppermute`) and the
softmax accumulates online (running max and denominator), so no rank
holds the whole sequence. The ring is plain torch (einsums in f32, as
JAX's `preferred_element_type`), no kernel; the causal mask compares
global positions, GQA groups are expanded before the ring. Autograd
differentiates through the ring (the shift's backward is the reverse
shift), so sequence-parallel training needs no custom backward.

The parameters are whole on every rank of the ring; the caller sums their
gradients over the sp group. The loss (`sp_nll`) sums each shard's
negative log-likelihoods and counts over the ring: a rank's last hidden
row predicts the next shard's first label.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.config import LLMConfig
from ..models.layers import apply_rope, dense, layer_slice, rms_norm, swiglu_mlp
from ..models.llm import _checkpoint, _rope_for, nll_sum_chunked
from .collectives import Group, reduce_from, ring_shift
from .sharding import RankMesh, create_rank_mesh

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def create_sp_mesh(sp: Optional[int] = None, device=None) -> RankMesh:
    """The dp x sp grid over the world of ranks (sp None: every rank one
    ring)."""
    from .collectives import init_distributed
    info = init_distributed(device)
    return create_rank_mesh(sp=sp or info.world, info=info)


def ring_attention_local(q, k, v, *, group: Group, causal: bool,
                         scale: Optional[float] = None,
                         q_segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """This rank's attention output [B, H, S_local, D] of its local q, k, v
    chunks [B, H, S_local, D] (k/v heads equal to q's) over the ring's whole
    sequence; segment ids are the local [B, S_local] chunks (-1: padding,
    never attended). A row that sees no key is 0."""
    B, H, Sl, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    n, r = group.size, group.rank
    ar = torch.arange(Sl, device=q.device)
    qpos = r * Sl + ar
    m = torch.full((B, H, Sl, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sl, D), dtype=torch.float32, device=q.device)
    qf = q.float()
    kc, vc, kseg = k, v, kv_segment_ids
    for step in range(n):
        kpos = ((r - step) % n) * Sl + ar
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float()) * scale
        mask = torch.ones((B, 1, Sl, Sl), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])[None, None]
        if q_segment_ids is not None:
            seg = ((q_segment_ids[:, :, None] == kseg[:, None, :])
                   & (kseg[:, None, :] >= 0))
            mask = mask & seg[:, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vc.float())
        m = m_new
        if step < n - 1:                      # rotate the kv chunks
            if kseg is None:
                kc, vc = ring_shift(group, kc, vc)
            else:
                kc, vc, kseg = ring_shift(group, kc, vc, kseg)
    safe_l = torch.where(l > 0, l, 1.0)
    return (acc / safe_l * (l > 0)).to(q.dtype)


def _local(x: Optional[torch.Tensor], group: Group, dim: int):
    if x is None:
        return None
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n)


def sp_decoder_forward(
    params: dict,                  # LLM tree (stacked layers [L, ...])
    cfg: LLMConfig,
    input_embeds: torch.Tensor,    # [B, S, D]; S % sp == 0
    positions: torch.Tensor,       # [B, S] or [3, B, S]
    *,
    mesh: RankMesh,
    segment_ids: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> torch.Tensor:
    """This rank's chunk [B, S/sp, D] of the final hidden states (after
    final_norm) of the sequence-parallel no-cache decoder stack, equal to
    that chunk of `decoder_forward`'s. Every rank passes the whole
    embeddings, positions and segments; it runs its own chunk. `remat`
    checkpoints each layer (its ring shifts rerun in the backward)."""
    group = mesh.inner
    B, S, D = input_embeds.shape
    if S % group.size:
        raise ValueError(f"seq {S} % sp {group.size} != 0")
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = Hq // Hkv
    cos, sin = _rope_for(cfg, positions)         # [B, S, hd]
    cos, sin = _local(cos, group, 1), _local(sin, group, 1)
    seg = _local(segment_ids, group, 1)
    x = _local(input_embeds, group, 1)

    def block(x, i):
        lp = layer_slice(params["layers"], i)
        Sl = x.shape[1]
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        a = lp["attn"]
        q = dense(h, a["wq"]["w"], a["wq"].get("b"))
        k = dense(h, a["wk"]["w"], a["wk"].get("b"))
        v = dense(h, a["wv"]["w"], a["wv"].get("b"))
        q = q.reshape(B, Sl, Hq, hd).transpose(1, 2)
        k = k.reshape(B, Sl, Hkv, hd).transpose(1, 2)
        v = v.reshape(B, Sl, Hkv, hd).transpose(1, 2)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if g > 1:                     # expand GQA groups for the ring
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        attn = ring_attention_local(q, k, v, group=group, causal=True,
                                    q_segment_ids=seg, kv_segment_ids=seg)
        attn = attn.transpose(1, 2).reshape(B, Sl, Hq * hd)
        x = x + dense(attn, a["wo"]["w"], a["wo"].get("b"))
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        return x + swiglu_mlp(lp["mlp"], h)

    for i in range(cfg.num_layers):
        x = _checkpoint(block, x, i) if remat else block(x, i)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def sp_targets(labels: torch.Tensor, mesh: RankMesh,
               ignore_index: int = -100) -> torch.Tensor:
    """This rank's targets [B, S/sp] of the shifted loss: its hidden row t
    predicts labels[t + 1], the last row the next shard's first label (the
    last rank's last row has none: ignored)."""
    group = mesh.inner
    B, S = labels.shape
    Sl = S // group.size
    start = group.rank * Sl + 1
    out = labels[:, start:start + Sl]
    if out.shape[1] < Sl:
        pad = out.new_full((B, Sl - out.shape[1]), ignore_index)
        out = torch.cat([out, pad], dim=1)
    return out


def sp_nll(params: dict, cfg: LLMConfig, h_local: torch.Tensor,
           labels: torch.Tensor, mesh: RankMesh, chunk: int = 2048,
           ignore_index: int = -100):
    """(this shard's negative log-likelihood sum, differentiated as its own
    term but valued as the sum over the ring; the ring's target count) of
    the shifted loss over the whole sequence, which is their ratio: JAX's
    cross entropy over the gathered hidden states, not a mean of the
    shards' means (their valid-label counts differ)."""
    total, count = nll_sum_chunked(params, cfg, h_local,
                                   sp_targets(labels, mesh, ignore_index),
                                   chunk, ignore_index)
    count = mesh.inner.all_reduce(count.clone())
    return reduce_from(total, mesh.inner), count
