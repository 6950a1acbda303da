"""KV-cached greedy generation.

Port of flash_vstream_tpu/runtime/generation.py:23-60, 80-176, 369-380:
`GenerationConfig`, `trim_stop_strings`, and a `Generator` that prefills a
bf16 KV cache and decodes greedily with an EOS exit. The JAX decode loop is
one compiled while-loop; here it is a host loop of single-token steps that
emits the same tokens. Sampling, prompt-lookup speculation and preemptible
chunks raise NotImplementedError (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..models.layers import KVCache
from ..models.llm import Qwen2Decoder

TODO_A6 = ("sampling, speculative decoding and preemptible chunks are not "
           "ported yet: ROADMAP A6")


@dataclasses.dataclass
class GenerationConfig:
    """Decode settings, named as in the JAX GenerationConfig. Only greedy
    decode runs here; a setting that asks for sampling (temperature > 0
    with top_k != 1), speculation or preemptible chunks raises."""
    max_new_tokens: int = 128
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 1 => greedy at any temperature
    eos_token_ids: Sequence[int] = ()
    stop_strings: Sequence[str] = ()   # cut from the text by trim_stop_strings
    speculative_k: int = 0
    preemptible_chunk: int = 0
    prefill_chunk: int = 0

    @property
    def greedy_only(self) -> bool:
        """True when these settings ask for nothing beyond greedy decode."""
        greedy = self.temperature <= 0.0 or self.top_k == 1
        return (greedy and self.speculative_k == 0
                and self.preemptible_chunk == 0 and self.prefill_chunk == 0)


def trim_stop_strings(text: str, stop_strings: Sequence[str]) -> str:
    """Cut the answer at the first conversation-separator keyword."""
    for s in stop_strings:
        if s and s in text:
            text = text.split(s)[0]
    return text.strip()


class Generator:
    """Prefill + greedy decode for one decoder and KV-cache capacity."""

    def __init__(self, llm: Qwen2Decoder, max_len: int = 4096,
                 cache_dtype=torch.bfloat16):
        self.llm = llm
        self.cfg = llm.cfg
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = llm.device

    def new_cache(self, batch: int = 1, length: Optional[int] = None) -> KVCache:
        return KVCache.create(self.cfg.num_layers, batch,
                              self.cfg.num_kv_heads, length or self.max_len,
                              self.cfg.head_dim, self.cache_dtype, self.device)

    def _active_len(self, S: int, max_new: int) -> int:
        """Tight KV capacity for one answer, bucketed to 256."""
        need = -(-(S + max_new + 1) // 256) * 256
        return min(self.max_len, need)

    @torch.no_grad()
    def prefill(self, embeds: torch.Tensor, positions: torch.Tensor,
                cache: KVCache, segment_ids: Optional[torch.Tensor] = None,
                last_idx=None) -> torch.Tensor:
        """Fill `cache` from the prompt; f32 logits [B, V] at each row's
        last real position (`last_idx`, default the last position)."""
        h = self.llm(embeds, positions, segment_ids=segment_ids, cache=cache)
        if last_idx is None:
            h_last = h[:, -1]
        else:
            rows = torch.arange(h.shape[0], device=h.device)
            last = torch.as_tensor(last_idx, device=h.device).reshape(-1)
            h_last = h[rows, last.expand(h.shape[0])]
        return self.llm.logits(h_last)

    @torch.no_grad()
    def step(self, tok: torch.Tensor, pos, cache: KVCache) -> torch.Tensor:
        """One decode step: token ids [B] at position `pos` -> logits [B, V]."""
        B = tok.shape[0]
        emb = self.llm.embed_tokens(tok[:, None])
        pos_b = torch.as_tensor(pos, device=tok.device).reshape(-1, 1)
        pos_b = pos_b.expand(B, 1)
        if self.cfg.mrope_sections is not None:
            pos_b = pos_b[None].expand(3, B, 1)
        h = self.llm(emb, pos_b, cache=cache)
        return self.llm.logits(h[:, -1])

    def generate(
        self,
        embeds: torch.Tensor,                # [1, S, D] prompt embeddings
        positions: torch.Tensor,             # [1, S] or [3, 1, S]
        gen: GenerationConfig,
        decode_pos_start=None,               # first decode position
        segment_ids: Optional[torch.Tensor] = None,   # [1, S]; -1 = padding
        last_real_idx=None,                  # logits position (right-padded)
    ) -> List[int]:
        """Greedy decode; returns the generated token ids, cut after the
        first EOS id (inclusive)."""
        if not gen.greedy_only:
            raise NotImplementedError(TODO_A6)
        B, S, _ = embeds.shape
        if B != 1:
            raise ValueError("generation supports batch 1 per stream")
        if S + gen.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({gen.max_new_tokens}) "
                f"exceeds the KV cache capacity ({self.max_len})")
        cache = self.new_cache(B, self._active_len(S, gen.max_new_tokens))
        logits = self.prefill(embeds, positions, cache, segment_ids,
                              last_real_idx)
        if decode_pos_start is None:
            decode_pos_start = S
        eos = set(gen.eos_token_ids)
        toks: List[int] = []
        tok = logits.argmax(dim=-1)
        for i in range(gen.max_new_tokens):
            toks.append(int(tok[0]))
            if toks[-1] in eos or i == gen.max_new_tokens - 1:
                break
            tok = self.step(tok, decode_pos_start + i, cache).argmax(dim=-1)
        return toks
