"""Decoder-only transformer (Qwen2 with M-RoPE, or Llama with 1D RoPE).

Port of flash_vstream_tpu/models/llm.py:38-83, 110-286, 296-421: random
init with the JAX tree; `decoder_forward` for a cache prefill (S > 1 tokens,
causal and segmented attention through K1, k/v written into the cache), a
decode step of one or more tokens against the cache (`decode_multi`: a
speculative verify or a prefill chunk), and the no-cache training path
with gradient checkpointing (`remat`, `remat_group`); `lm_head`,
`embed_tokens`, `cross_entropy_loss` and `cross_entropy_loss_chunked`
(vocab-tiled for quantized heads, vocab-parallel over a split head).
Layers run in a Python loop over the stacked [L, ...] parameters. The
projections and the lm_head may be quantized (weights/quantize.py): `dense`
dispatches, and a decode step over an int4 base runs K6 in each of them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import LLMConfig
from ..core.device import resolve_device

from ..parallel.collectives import copy_to, gather_from, reduce_from
from ..parallel.tensor import TPShard
from ..weights.quantize import dequantize_weight4
from .layers import (
    KVCache,
    ParamTree,
    dense,
    init_dense,
    layer_slice,
    mha,
    mrope_angles,
    rms_norm,
    rope_angles,
    swiglu_mlp,
)


def init_llm_params(cfg: LLMConfig, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> dict:
    """Random parameters with the JAX init's tree, layouts and
    distributions, drawn from `generator` on `device` (default: the card)."""
    device = resolve_device(device)
    D, I, Dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    Hq, Hkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    kw = dict(dtype=dtype, device=device)

    def stacked(din, dout, bias):
        return init_dense(generator, din, dout, bias=bias, layers=L, **kw)

    params = {
        "embed": torch.randn(cfg.vocab_size, D, generator=generator,
                             **kw).mul_(0.02),
        "layers": {
            "attn_norm": torch.ones(L, D, **kw),
            "mlp_norm": torch.ones(L, D, **kw),
            "attn": {
                "wq": stacked(D, Hq * Dh, cfg.attention_bias),
                "wk": stacked(D, Hkv * Dh, cfg.attention_bias),
                "wv": stacked(D, Hkv * Dh, cfg.attention_bias),
                "wo": stacked(Hq * Dh, D, False),
            },
            "mlp": {
                "gate": stacked(D, I, False),
                "up": stacked(D, I, False),
                "down": stacked(I, D, False),
            },
        },
        "final_norm": torch.ones(D, **kw),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = torch.randn(D, cfg.vocab_size, generator=generator,
                                        **kw).mul_(0.02)
    return params


def _rope_for(cfg: LLMConfig, positions: torch.Tensor):
    """positions: [B, S] (1D) or [3, B, S] (M-RoPE)."""
    if cfg.mrope_sections is not None:
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return mrope_angles(positions, cfg.head_dim, cfg.mrope_sections,
                            cfg.rope_theta)
    if positions.dim() == 3:
        positions = positions[0]
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _checkpoint(fn, *args):
    """Non-reentrant activation checkpoint (nests; no RNG state to keep)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def decoder_block(lp: dict, cfg: LLMConfig, x: torch.Tensor, rope,
                  segment_ids: Optional[torch.Tensor] = None,
                  mlp_seq_chunk: int = 0, **cache_kw) -> torch.Tensor:
    """One pre-norm decoder layer (`lp`: one layer's parameters): causal,
    segmented attention with rope (cos, sin), then the SwiGLU MLP (in
    checkpointed sequence chunks with `mlp_seq_chunk`), each added to the
    residual (JAX llm.py `decoder_block`). `cache_kw` are `mha`'s cache
    arguments."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    x = x + mha(lp["attn"], h, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                rope=rope, causal=True, q_segment_ids=segment_ids,
                kv_segment_ids=segment_ids, **cache_kw)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + swiglu_mlp(lp["mlp"], h, seq_chunk=mlp_seq_chunk)


def decoder_forward(
    params: dict,
    cfg: LLMConfig,
    input_embeds: torch.Tensor,                   # [B, S, D]
    positions: torch.Tensor,                      # [B, S] or [3, B, S]
    *,
    segment_ids: Optional[torch.Tensor] = None,   # [B, S]; -1 = padding
    cache: Optional[KVCache] = None,
    remat: bool = False,
    remat_group: int = 1,
    decode_multi: bool = False,
    mlp_seq_chunk: int = 0,
) -> torch.Tensor:
    """Run the decoder stack and return the final hidden states [B, S, D].

    With a cache: S > 1 without `decode_multi` prefills it from position 0
    (it must be empty); S == 1, or any S with `decode_multi`, appends the S
    tokens at `cache.length` and attends them to the whole prefix (a decode
    step, a speculative verify, a prefill chunk: JAX llm.py:124-125,
    179-260). The cache is written in place and advanced by S; an int8
    cache carries its scales through every layer.

    Without a cache (training), `remat` checkpoints every layer: its
    activations are recomputed in the backward pass instead of kept. With
    `remat_group` g > 1 dividing the layer count, each group of g layers is
    one checkpoint holding the g per-layer checkpoints (the JAX nested
    checkpoint, llm.py:158-172): only every g-th layer input stays resident,
    at the cost of running each layer's forward once more.

    `mlp_seq_chunk` > 0 runs every layer's MLP in checkpointed sequence
    chunks (`layers.swiglu_mlp`'s `seq_chunk`; exact), as JAX's does."""
    cos, sin = _rope_for(cfg, positions)
    x = input_embeds
    B, S, _ = x.shape
    if cache is not None:
        if S > 1 and cache.length and not decode_multi:
            raise ValueError(
                f"a prefill starts at an empty cache (length "
                f"{cache.length}); pass decode_multi=True to append S > 1 "
                f"tokens to a prefix")
        cache_len = cache.length
        cache.write_segments(
            segment_ids if segment_ids is not None
            else torch.zeros((B, S), dtype=torch.int32, device=x.device))

    def layer(x, i):
        kw = {}
        if cache is not None:
            kw = dict(kv_cache=cache.layer(i), cache_len=cache_len,
                      cache_segments=cache.segments,
                      decode_multi=decode_multi)
        return decoder_block(layer_slice(params["layers"], i), cfg, x,
                             (cos, sin), segment_ids, mlp_seq_chunk, **kw)

    L = cfg.num_layers
    if cache is None and remat:
        g = max(remat_group, 1)
        if g > 1 and L % g == 0:
            def group(x, first):
                for i in range(first, first + g):
                    x = _checkpoint(layer, x, i)
                return x
            for first in range(0, L, g):
                x = _checkpoint(group, x, first)
        else:
            for i in range(L):
                x = _checkpoint(layer, x, i)
    else:
        for i in range(L):
            x = layer(x, i)
    if cache is not None:
        cache.length += S
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def lm_head(params: dict, cfg: LLMConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Logits in f32. A split head (a column `TPShard`, or a tied
    vocab-split embed) computes this rank's vocab columns and gathers the
    logits whole (`gather_from`), so the cross entropy is unchanged."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"]
        if isinstance(w, TPShard):
            h = copy_to(hidden, w.group)
            out = torch.matmul(h, w.local().T.to(h.dtype)).float()
            return gather_from(out, w.group)
        w = w.T
    if isinstance(w, TPShard):
        return gather_from(dense(hidden, w).float(), w.group)
    return dense(hidden, w).float()


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows; a quantized table (custom quantization targets) is
    dequantized at gather time, in bf16, as in JAX (llm.py:268-286). A
    vocab-split table (`TPShard`) gathers the ids in this rank's rows,
    zeroes the others and sums the ranks' rows (`reduce_from`): each id's
    row comes from one rank, so the sum is exact."""
    w = params["embed"]
    if isinstance(w, TPShard):
        rows = w.local()
        n = rows.shape[0]
        local = input_ids - w.group.rank * n
        inside = (local >= 0) & (local < n)
        got = rows[local.clamp(0, n - 1)]
        return reduce_from(torch.where(inside[..., None], got,
                                       got.new_zeros(())), w.group)
    if hasattr(w, "q"):            # int8: gather rows, then scale
        return (w.q[input_ids].to(torch.bfloat16)
                * w.scale[0].to(torch.bfloat16))
    if hasattr(w, "q4"):
        # int4: rows pack along the vocab axis split-half, so row r lives in
        # byte row r % (V/2), low nibble below V/2 and high nibble above
        half = w.q4.shape[0]
        byte = w.q4[input_ids % half]                      # [..., D] uint8
        lo = (byte & 0xF).to(torch.int8) - 8
        hi = (byte >> 4).to(torch.int8) - 8
        q = torch.where((input_ids < half)[..., None], lo, hi)
        bs = 2 * half // w.scale.shape[0]
        sc = w.scale[input_ids // bs]                      # [..., D]
        return q.to(torch.bfloat16) * sc.to(torch.bfloat16)
    return w[input_ids]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Shifted causal-LM loss, the mean over non-ignored targets
    (log-softmax in f32)."""
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / torch.clamp_min(valid.sum(), 1)


def _largest_divisor_le(n: int, cap: int) -> int:
    c = min(cap, n)
    while n % c:
        c -= 1
    return c


def _tile_logits(params: dict, hh: torch.Tensor, t: int, vt: int
                 ) -> torch.Tensor:
    """f32 logits [..., vt] of vocab tile t: hidden @ the head's columns
    [t*vt, (t+1)*vt), in hidden's dtype. An int8 head casts only that
    [D, vt] slice of its values and scales the product by the slice's
    scales; an int4 head dequantizes only that slice (its scales are per
    input block, so a column slice is whole); a tied head takes embed rows
    (JAX llm.py:356-381). A vocab-split head (`TPShard`) tiles this rank's
    part of the vocabulary."""
    from ..weights.quantize import QuantWeight4
    w = params.get("lm_head")
    cols = slice(t * vt, (t + 1) * vt)
    if w is None:
        e = params["embed"]
        wt = (e.local() if isinstance(e, TPShard) else e)[cols].T
    elif isinstance(w, TPShard):
        wt = w.local()[:, cols]
    elif hasattr(w, "q"):
        lg = torch.matmul(hh, w.q[:, cols].to(hh.dtype)).float()
        return lg * w.scale[0, cols].float()
    elif hasattr(w, "q4"):
        wt = dequantize_weight4(QuantWeight4(w.q4[:, cols], w.scale[:, cols]),
                                hh.dtype)
    else:
        wt = w[:, cols]
    return torch.matmul(hh, wt.to(hh.dtype)).float()


def _tile_step(params, hh, safe, m, s, lab, t: int, vt: int):
    """One vocab tile of the online log-sum-exp: the running max m, the sum
    s of exp(logit - m) and the label logit of the tokens whose label falls
    in this tile (an in-tile gather)."""
    lg = _tile_logits(params, hh, t, vt)
    nm = torch.maximum(m, lg.amax(dim=-1))
    s = s * torch.exp(m - nm) + torch.exp(lg - nm[..., None]).sum(dim=-1)
    local = safe - t * vt
    inside = (local >= 0) & (local < vt)
    got = lg.gather(-1, local.clamp(0, vt - 1)[..., None].long())[..., 0]
    return nm, s, torch.where(inside, got, lab)


def cross_entropy_loss_chunked(params: dict, cfg: LLMConfig,
                               hidden: torch.Tensor,   # [B, S, D]
                               labels: torch.Tensor,   # [B, S]
                               chunk: int = 2048,
                               ignore_index: int = -100,
                               vocab_tile: int = 0) -> torch.Tensor:
    """`cross_entropy_loss(lm_head(hidden), labels)` without materializing
    the [S, vocab] logits: the shifted sequence runs in chunks of `chunk`
    tokens, each through lm_head + CE inside one checkpoint, so only one
    [chunk, vocab] f32 block is live at a time, forward and backward (the
    backward recomputes each chunk's logits).

    vocab_tile > 0 also tiles the vocabulary with an online log-sum-exp
    (JAX llm.py:296-409): per tile only a [chunk, tile] logits block and,
    for a quantized head, a [D, tile] dequantized slice exist, so an int8
    or int4 head never materializes its bf16 copy; each tile is its own
    checkpoint. A quantized head tiles by 8,192 unless told otherwise; the
    tile is the largest divisor of the vocabulary at most that size."""
    total, count = nll_sum_chunked(params, cfg, hidden[:, :-1],
                                   labels[:, 1:], chunk, ignore_index,
                                   vocab_tile)
    return total / torch.clamp_min(count, 1)


def nll_sum_chunked(params: dict, cfg: LLMConfig,
                    hidden: torch.Tensor,      # [B, S, D]
                    targets: torch.Tensor,     # [B, S], aligned with hidden
                    chunk: int = 2048, ignore_index: int = -100,
                    vocab_tile: int = 0):
    """(the f32 sum of the negative log-likelihoods, the count of
    targets) of hidden row t predicting targets[t], ignored targets left
    out, in `cross_entropy_loss_chunked`'s chunks and tiles: its shifted
    loss is this sum over the count, and a loss split over ranks (a
    sequence-parallel shard, a data-parallel share) sums the ranks' parts
    of both."""
    B, S, D = hidden.shape
    h, lab = hidden, targets
    w = params.get("lm_head")
    head = w if w is not None else params["embed"]
    if isinstance(head, TPShard):
        return _nll_sum_split(params, cfg, head.group, hidden, targets,
                              chunk, ignore_index, vocab_tile)
    if vocab_tile == 0 and w is not None and (hasattr(w, "q")
                                              or hasattr(w, "q4")):
        vocab_tile = 8192
    vt = _largest_divisor_le(cfg.vocab_size, vocab_tile) if vocab_tile else 0

    def one(hh, ll):
        logits = lm_head(params, cfg, hh)
        valid = ll != ignore_index
        safe = torch.where(valid, ll, 0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, safe[..., None].long())[..., 0]
        return torch.where(valid, nll, 0.0).sum()

    def one_tiled(hh, ll):
        valid = ll != ignore_index
        safe = torch.where(valid, ll, 0)
        m = torch.full(ll.shape, float("-inf"), device=hh.device)
        s = torch.zeros(ll.shape, device=hh.device)
        got = torch.zeros(ll.shape, device=hh.device)
        for t in range(cfg.vocab_size // vt):
            m, s, got = _checkpoint(_tile_step, params, hh, safe, m, s, got,
                                    t, vt)
        nll = m + torch.log(s) - got
        return torch.where(valid, nll, 0.0).sum()

    body = one_tiled if vt else one
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        total = total + _checkpoint(body, h[:, c0:c0 + chunk],
                                    lab[:, c0:c0 + chunk])
    return total, (lab != ignore_index).sum()


def _nll_sum_split(params: dict, cfg: LLMConfig, group,
                   hidden: torch.Tensor, targets: torch.Tensor, chunk: int,
                   ignore_index: int, vocab_tile: int):
    """`nll_sum_chunked` over a vocab-split head (a column `lm_head` or a
    tied vocab `embed`, `TPShard`s of `group`): Megatron's vocab-parallel
    cross entropy in the same sequence chunks. Each rank runs the online
    log-sum-exp over its V/tp columns (in tiles of the largest divisor of
    V/tp at most `vocab_tile`, each its own checkpoint), then the max is
    taken over tp (a constant of the gradient), each rank's sum of
    exp(logit - max) and the target's logit, from the rank that holds it
    (0 on the others), are summed over tp (`reduce_from`), and the hidden
    states enter through `copy_to`, whose backward sums their gradient.
    No [chunk, V] block is gathered whole."""
    S = hidden.shape[1]
    V = cfg.vocab_size // group.size
    vt = _largest_divisor_le(V, vocab_tile) if vocab_tile else V

    def body(hh, ll):
        valid = ll != ignore_index
        safe = torch.where(valid, ll, 0) - group.rank * V
        hh = copy_to(hh, group)
        m = torch.full(ll.shape, float("-inf"), device=hh.device)
        s = torch.zeros(ll.shape, device=hh.device)
        got = torch.zeros(ll.shape, device=hh.device)
        for t in range(V // vt):
            m, s, got = (_tile_step(params, hh, safe, m, s, got, t, vt)
                         if vt == V else _checkpoint(_tile_step, params, hh,
                                                     safe, m, s, got, t, vt))
        mg = group.all_gather(m.detach()[..., None], -1).amax(-1)
        s = reduce_from(s * torch.exp(m - mg), group)
        nll = mg + torch.log(s) - reduce_from(got, group)
        return torch.where(valid, nll, 0.0).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        total = total + _checkpoint(body, hidden[:, c0:c0 + chunk],
                                    targets[:, c0:c0 + chunk])
    return total, (targets != ignore_index).sum()


class Qwen2Decoder(ParamTree):
    """The decoder's parameter tree ("embed", "layers", "final_norm",
    "lm_head") as a module; `forward` is `decoder_forward`, `logits` the
    lm head."""

    def __init__(self, cfg: LLMConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, input_embeds: torch.Tensor, positions: torch.Tensor, *,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                decode_multi: bool = False) -> torch.Tensor:
        return decoder_forward(self.tree(), self.cfg, input_embeds, positions,
                               segment_ids=segment_ids, cache=cache,
                               decode_multi=decode_multi)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """`lm_head` (the name is taken by the parameter of that name)."""
        return lm_head(self.tree(), self.cfg, hidden)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self.tree(), input_ids)

    @property
    def device(self) -> torch.device:
        """Where the decoder lives (`final_norm` is never quantized)."""
        return self.final_norm.device
