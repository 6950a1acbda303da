"""Decoder-only transformer (Qwen2 with M-RoPE, or Llama with 1D RoPE).

Port of flash_vstream_tpu/models/llm.py:38-83, 110-286, 296-421: random
init with the JAX tree; `decoder_forward` for a cache prefill (S > 1 tokens,
causal and segmented attention through K1, k/v written into the cache), a
decode step of one or more tokens against the cache (`decode_multi`: a
speculative verify or a prefill chunk), and the no-cache training path
with gradient checkpointing (`remat`, `remat_group`); `lm_head`,
`embed_tokens`, `cross_entropy_loss` and `cross_entropy_loss_chunked`.
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
) -> torch.Tensor:
    """Run the decoder stack and return the final hidden states [B, S, D].

    With a cache: S > 1 without `decode_multi` prefills it from position 0
    (it must be empty); S == 1, or any S with `decode_multi`, appends the S
    tokens at `cache.length` and attends them to the whole prefix (a decode
    step, a speculative verify, a prefill chunk: JAX llm.py:124-125,
    179-228). The cache is written in place and advanced by S.

    Without a cache (training), `remat` checkpoints every layer: its
    activations are recomputed in the backward pass instead of kept. With
    `remat_group` g > 1 dividing the layer count, each group of g layers is
    one checkpoint holding the g per-layer checkpoints (the JAX nested
    checkpoint, llm.py:158-172): only every g-th layer input stays resident,
    at the cost of running each layer's forward once more."""
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
        lp = layer_slice(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        kw = {}
        if cache is not None:
            kw = dict(kv_cache=(cache.k[i], cache.v[i]), cache_len=cache_len,
                      cache_segments=cache.segments,
                      decode_multi=decode_multi)
        x = x + mha(lp["attn"], h, num_heads=cfg.num_heads,
                    num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                    rope=(cos, sin), causal=True, q_segment_ids=segment_ids,
                    kv_segment_ids=segment_ids, **kw)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        return x + swiglu_mlp(lp["mlp"], h)

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
    """Logits in f32."""
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    return dense(hidden, w).float()


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows; a quantized table (custom quantization targets) is
    dequantized at gather time, in bf16, as in JAX (llm.py:268-286)."""
    w = params["embed"]
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
    backward recomputes each chunk's logits). The JAX `vocab_tile` path for
    quantized heads (training over a quantized base) is not ported."""
    if vocab_tile or not isinstance(params.get("lm_head", params["embed"]),
                                    torch.Tensor):
        raise NotImplementedError(
            "the vocab-tiled chunked loss of quantized heads is not ported "
            "yet: ROADMAP A10, A12 (QLoRA)")
    B, S, D = hidden.shape
    h = hidden[:, :-1]
    lab = labels[:, 1:]

    def one(hh, ll):
        logits = lm_head(params, cfg, hh)
        valid = ll != ignore_index
        safe = torch.where(valid, ll, 0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, safe[..., None].long())[..., 0]
        return torch.where(valid, nll, 0.0).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S - 1, chunk):
        total = total + checkpoint(one, h[:, c0:c0 + chunk],
                                   lab[:, c0:c0 + chunk],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    count = (lab != ignore_index).sum()
    return total / torch.clamp_min(count, 1)


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
