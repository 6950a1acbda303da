"""KV-cached generation: greedy, sampled, streamed, preemptible and
speculative decode.

Port of flash_vstream_tpu/runtime/generation.py: `GenerationConfig`,
`trim_stop_strings`, `_sample` and a `Generator` that prefills a bf16 KV
cache and decodes. The JAX decode loops are compiled while-loops; here they
are host loops that emit the same tokens:

- greedy (`generate`): one step a token with an EOS exit; single-token stop
  keywords fold into the EOS set;
- stepwise (`generate_stream`, and every sampled answer): one token at a
  time, with `KeywordsStoppingCriteria` checked on the text;
- preemptible: the prompt's prefill in sequence chunks (`prefill_chunk`)
  and the decode in chunks of `preemptible_chunk` steps whose tokens stay on
  the device, with one host read (a sync) between chunks;
- prompt-lookup speculation (`speculative_k`): k drafted tokens verified in
  one (k + 1)-token forward against the cache, the rejected slots
  overwritten by the next round;
- `generate_batch`: left-padded rows decoded together.

Sampling differs in interface only: `jax.random.categorical(key, logits)`
is argmax(logits + Gumbel noise), and torch cannot reproduce jax.random, so
the noise comes from the Generator's `gumbel` draw function (by default a
torch generator seeded with `gen.seed`); the tests hand it JAX's draws.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..models.layers import KVCache
from ..models.llm import Qwen2Decoder


@dataclasses.dataclass
class GenerationConfig:
    """Decode settings, field for field the JAX GenerationConfig."""
    max_new_tokens: int = 128
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 = off; 1 => greedy at any temperature
    top_p: float = 1.0
    eos_token_ids: Sequence[int] = ()
    seed: int = 0                  # the default Gumbel draws' seed
    stop_strings: Sequence[str] = ()   # cut from the text by trim_stop_strings
    # prompt-lookup speculation (greedy, exact): draft the k tokens that
    # followed the latest match of the trailing n-gram in the context and
    # the answer so far, verify them in one k + 1 token forward. 0 = off;
    # needs context_ids at generate() time.
    speculative_k: int = 0
    speculative_ngram: int = 3
    # preemptible answers (greedy): decode in chunks of this many steps with
    # a host sync between them, so work queued by another thread runs in
    # the gaps. 0 = off. Speculation, when active, wins (see
    # _warn_spec_preempt_once).
    preemptible_chunk: int = 0
    # with preemptible_chunk: also prefill the prompt in sequence chunks of
    # this many tokens against the growing cache. 0 = one prefill.
    prefill_chunk: int = 0

    @property
    def greedy(self) -> bool:
        """True when a token is the argmax of its logits."""
        return self.temperature <= 0.0 or self.top_k == 1


_SPEC_PREEMPT_WARNED = False


def _warn_spec_preempt_once():
    """speculative_k with preemptible_chunk: speculation runs and preemption
    is ignored; say so once a process."""
    global _SPEC_PREEMPT_WARNED
    if not _SPEC_PREEMPT_WARNED:
        _SPEC_PREEMPT_WARNED = True
        warnings.warn(
            "speculative_k and preemptible_chunk both set: speculation runs "
            "and preemption is ignored. Drop speculative_k if preemption "
            "between chunks matters more than answer latency.", stacklevel=3)


def trim_stop_strings(text: str, stop_strings: Sequence[str]) -> str:
    """Cut the answer at the first conversation-separator keyword."""
    for s in stop_strings:
        if s and s in text:
            text = text.split(s)[0]
    return text.strip()


def _sample(logits: torch.Tensor, gen: GenerationConfig,
            gumbel: Optional[torch.Tensor]) -> torch.Tensor:
    """Token ids [B] from logits [B, V]: the argmax when `gen` is greedy,
    else temperature, top-k and top-p filtering and the argmax of the
    filtered logits plus the Gumbel noise `gumbel` [B, V] (JAX
    generation.py:89-104 with categorical written out)."""
    if gen.greedy:
        return logits.argmax(dim=-1)
    logits = logits / gen.temperature
    if gen.top_k > 1:
        kth = torch.sort(logits, dim=-1).values[..., -gen.top_k, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # the smallest prefix with cumulative mass >= top_p stays
        cutoff_idx = (cum < gen.top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_logits.gather(
            -1, cutoff_idx.clamp_max(logits.shape[-1] - 1))
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return (logits + gumbel.to(logits.dtype)).argmax(dim=-1)


def torch_gumbel(gen: GenerationConfig, shape, device) -> Iterator[torch.Tensor]:
    """Standard Gumbel noise for each sampled token in turn, -log(-log(U))
    with U from a torch generator seeded with `gen.seed` (U kept in
    [tiny, 1), as jax.random.gumbel keeps it)."""
    g = torch.Generator(device=device)
    g.manual_seed(gen.seed)
    tiny = torch.finfo(torch.float32).tiny
    while True:
        u = torch.rand(shape, generator=g, device=device).clamp_min(tiny)
        yield -torch.log(-torch.log(u))


def _first_stop(toks: List[int], stop_ids) -> List[int]:
    """`toks` cut after the first stop id (inclusive)."""
    for j, t in enumerate(toks):
        if t in stop_ids:
            return toks[:j + 1]
    return toks


class Generator:
    """Prefill and decode for one decoder and KV-cache capacity. `gumbel`
    (gen, shape, device) -> an iterator of noise tensors, one a sampled
    token, is where sampling draws from (default `torch_gumbel`)."""

    def __init__(self, llm: Qwen2Decoder, max_len: int = 4096,
                 cache_dtype=torch.bfloat16,
                 gumbel: Optional[Callable] = None):
        self.llm = llm
        self.cfg = llm.cfg
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = llm.device
        self.gumbel = gumbel or torch_gumbel

    def new_cache(self, batch: int = 1, length: Optional[int] = None) -> KVCache:
        return KVCache.create(self.cfg.num_layers, batch,
                              self.cfg.num_kv_heads, length or self.max_len,
                              self.cfg.head_dim, self.cache_dtype, self.device)

    def _active_len(self, S: int, max_new: int) -> int:
        """Tight KV capacity for one answer, bucketed to 256."""
        need = -(-(S + max_new + 1) // 256) * 256
        return min(self.max_len, need)

    def _check_len(self, S: int, gen: GenerationConfig) -> None:
        if S + gen.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({gen.max_new_tokens}) "
                f"exceeds the KV cache capacity ({self.max_len})")

    def _sync(self) -> None:
        """The host waits for the card: the preemption point between two
        chunks (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _positions(self, pos0, B: int, S: int) -> torch.Tensor:
        """Positions [B, S] (or [3, B, S] with M-RoPE) from each row's first
        position `pos0` (a host int or a [B] tensor)."""
        pos = (torch.as_tensor(pos0, device=self.device).reshape(-1, 1)
               + torch.arange(S, device=self.device)[None]).expand(B, S)
        if self.cfg.mrope_sections is not None:
            pos = pos[None].expand(3, B, S)
        return pos

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
    def prefill_seq_chunk(self, embeds: torch.Tensor, positions: torch.Tensor,
                          cache: KVCache, last_rel: int,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """One prompt chunk against the cache prefix (decode_multi: causal
        within the chunk and over the whole prefix, the one-shot prefill's
        math). Logits [B, V] at the chunk's position `last_rel`; callers use
        them only from the chunk holding the last real token."""
        h = self.llm(embeds, positions, segment_ids=segment_ids, cache=cache,
                     decode_multi=True)
        return self.llm.logits(h[:, last_rel])

    @torch.no_grad()
    def step(self, tok: torch.Tensor, pos, cache: KVCache) -> torch.Tensor:
        """One decode step: token ids [B] at position `pos` (a host int or
        [B]) -> logits [B, V]."""
        emb = self.llm.embed_tokens(tok[:, None])
        h = self.llm(emb, self._positions(pos, tok.shape[0], 1), cache=cache)
        return self.llm.logits(h[:, -1])

    @torch.no_grad()
    def verify(self, toks: torch.Tensor, pos0: int,
               cache: KVCache) -> torch.Tensor:
        """Tokens [B, K] at positions pos0.. in one decode_multi forward ->
        logits [B, K, V] (the speculative verify of JAX :229-239)."""
        emb = self.llm.embed_tokens(toks)
        h = self.llm(emb, self._positions(pos0, *toks.shape), cache=cache,
                     decode_multi=True)
        return self.llm.logits(h)

    def _prefill_chunked(self, embeds, positions, cache, segment_ids,
                         last_real_idx, c: int) -> torch.Tensor:
        """The preemptible prefill (JAX :416-435): sequence chunks of `c`
        tokens through `prefill_seq_chunk`, a host sync after each; the
        logits of the chunk that holds the last real token."""
        S = embeds.shape[1]
        last = (int(np.asarray(last_real_idx).ravel()[0])
                if last_real_idx is not None else S - 1)
        logits = None
        for a in range(0, S, c):
            b = min(a + c, S)
            inside = a <= last < b
            seg = segment_ids[:, a:b] if segment_ids is not None else None
            lg = self.prefill_seq_chunk(embeds[:, a:b], positions[..., a:b],
                                        cache, last - a if inside else 0, seg)
            if inside:
                logits = lg
            self._sync()
        return logits

    @torch.no_grad()
    def _decode_chunk(self, tok: torch.Tensor, pos: int, cache: KVCache,
                      c: int, stop: torch.Tensor, done: torch.Tensor):
        """`c` greedy steps from `tok` at `pos` with the tokens kept on the
        card (JAX decode_chunk, :178-208): a row that emitted a stop id
        repeats it. Returns (the c tokens of row 0, the count JAX's loop
        would have run: through the first stop id, next token, done)."""
        outs = []
        for i in range(c):
            outs.append(tok)
            done = done | torch.isin(tok, stop)
            ntok = self.step(tok, pos + i, cache).argmax(dim=-1)
            tok = torch.where(done, tok, ntok)
        out = torch.stack(outs, dim=1)[0].tolist()     # the host sync
        stop_ids = set(stop.tolist())
        n = next((j + 1 for j, t in enumerate(out) if t in stop_ids), c)
        return out, n, tok, done

    def _spec_decode(self, first: torch.Tensor, pos_start: int,
                     cache: KVCache, context_ids, gen: GenerationConfig,
                     stop_ids) -> List[int]:
        """Greedy decode with prompt-lookup drafts (JAX spec_decode_loop,
        :210-300, and its caller, :453-468). Every emitted token is the
        argmax given its true prefix; a draft only decides how many targets
        one forward verifies. The verify writes k + 1 cache slots and the
        length is set back to keep the accepted ones; the next round's k + 1
        writes cover the rejected tail. Host arrays mirror the JAX buffers,
        clamped slices included."""
        k, ng, max_new = gen.speculative_k, gen.speculative_ngram, \
            gen.max_new_tokens
        ctx = np.asarray(context_ids, np.int64).ravel()
        H = -(-(len(ctx) + max_new + k + 1) // 128) * 128
        hist = np.zeros(H, np.int64)
        hist[:len(ctx)] = ctx
        out = np.zeros(max_new + k, np.int64)

        def put(buf, vals, at):            # dynamic_update_slice, clamped
            at = min(max(at, 0), len(buf) - len(vals))
            buf[at:at + len(vals)] = vals

        tok = int(first[0])
        put(hist, [tok], len(ctx))
        h_len = len(ctx) + 1
        out[0] = tok
        done = tok in stop_ids
        jpos = np.arange(H - ng + 1)
        windows = jpos[:, None] + np.arange(ng)[None]
        i, rounds, accepted = 1, 0, 0
        while i < max_new and not done:
            q0 = min(max(h_len - ng, 0), H - ng)
            valid = ((hist[windows] == hist[q0:q0 + ng][None]).all(axis=1)
                     & (jpos <= h_len - ng - 1) & (h_len >= ng))
            found = bool(valid.any())
            jstar = int(np.where(valid, jpos, -1).max())
            dstart = min(max(jstar + ng, 0), H - k)
            draft = hist[dstart:dstart + k]
            toks_in = torch.as_tensor(np.concatenate([[tok], draft]),
                                      device=self.device)[None]
            g = self.verify(toks_in, pos_start + i - 1, cache
                            ).argmax(dim=-1)[0].tolist()
            eq = (draft == np.asarray(g[:k])) & found
            m = int(np.cumprod(eq).sum())
            n_emit = m + 1
            hit = [j for j in range(m + 1) if g[j] in stop_ids]
            if hit:
                n_emit, done = hit[0] + 1, True
            put(out, g, i)
            put(hist, g, h_len)
            cache.length += n_emit - (k + 1)
            tok = g[n_emit - 1]
            i += n_emit
            h_len += n_emit
            rounds += 1
            accepted += n_emit - 1
        self.last_spec = {"rounds": rounds, "accepted": accepted,
                          "drafted": rounds * k}
        n = min(i, max_new + k, max_new)
        return _first_stop(out[:n].tolist(), stop_ids)

    @torch.no_grad()
    def generate(
        self,
        embeds: torch.Tensor,                # [1, S, D] prompt embeddings
        positions: torch.Tensor,             # [1, S] or [3, 1, S]
        gen: GenerationConfig,
        decode_pos_start=None,               # first decode position
        stream: bool = False,                # stepwise decode
        segment_ids: Optional[torch.Tensor] = None,   # [1, S]; -1 = padding
        last_real_idx=None,                  # logits position (right-padded)
        stopping=None,                       # KeywordsStoppingCriteria
        context_ids=None,                    # text ids for speculation
    ) -> List[int]:
        """Decode one prompt; returns the generated token ids, cut after the
        first stop id (inclusive). Routes as JAX generate (:382-509): the
        greedy loop, its preemptible chunks or speculation, and the
        stepwise loop when sampling or `stream` is asked for."""
        B, S, _ = embeds.shape
        if B != 1:
            raise ValueError("generation supports batch 1 per stream")
        self._check_len(S, gen)
        # speculative rounds may write up to k rejected slots past the final
        # length, and fixed-size chunks over-decode up to chunk - 1 steps:
        # the cache covers both
        spec_pad = (gen.speculative_k
                    if gen.speculative_k > 0 and context_ids is not None
                    else 0)
        if spec_pad and gen.preemptible_chunk > 0:
            _warn_spec_preempt_once()
        chunk_pad = 0
        if gen.preemptible_chunk > 0 and not spec_pad:
            c = gen.preemptible_chunk
            chunk_pad = (c - gen.max_new_tokens % c) % c
        cache = self.new_cache(B, self._active_len(
            S, gen.max_new_tokens + spec_pad + chunk_pad))
        if gen.preemptible_chunk > 0 and gen.prefill_chunk > 0 and not spec_pad:
            logits = self._prefill_chunked(embeds, positions, cache,
                                           segment_ids, last_real_idx,
                                           gen.prefill_chunk)
        else:
            logits = self.prefill(embeds, positions, cache, segment_ids,
                                  last_real_idx)
        if decode_pos_start is None:
            decode_pos_start = S
        decode_pos_start = int(decode_pos_start)

        if not gen.greedy or stream:
            return list(self._stream_tokens(logits, cache, gen,
                                            decode_pos_start, stopping))
        # single-token stop keywords fold into the EOS set; longer ones act
        # on the stepwise path only (trim_stop_strings backs both up)
        stop_ids = set(gen.eos_token_ids)
        if stopping is not None:
            stop_ids |= set(stopping.single_token_ids())
        first = logits.argmax(dim=-1)
        if spec_pad:
            return self._spec_decode(first, decode_pos_start, cache,
                                     context_ids, gen, stop_ids)
        if gen.preemptible_chunk > 0:
            # every chunk has the same size; the tail chunk's extra steps
            # are trimmed
            stop = torch.tensor(sorted(stop_ids), dtype=first.dtype,
                                device=first.device)
            toks: List[int] = []
            tok, pos = first, decode_pos_start
            done = torch.zeros_like(first, dtype=torch.bool)
            remaining = gen.max_new_tokens
            while remaining > 0:
                out, n, tok, done = self._decode_chunk(
                    tok, pos, cache, gen.preemptible_chunk, stop, done)
                take = min(n, remaining)
                toks += out[:take]
                pos += n
                remaining -= take
                if n == 0 or bool(done[0]):
                    break
            return _first_stop(toks, stop_ids)
        toks = []
        tok = first
        for i in range(gen.max_new_tokens):
            toks.append(int(tok[0]))
            if toks[-1] in stop_ids or i == gen.max_new_tokens - 1:
                break
            tok = self.step(tok, decode_pos_start + i, cache).argmax(dim=-1)
        return toks

    @torch.no_grad()
    def _stream_tokens(self, logits: torch.Tensor, cache: KVCache,
                       gen: GenerationConfig, decode_pos_start: int,
                       stopping=None) -> Iterator[int]:
        """Stepwise decode from a finished prefill, one token id at a time
        (JAX :511-529). A sampled token takes the next noise from
        `self.gumbel`: the first token the first draw, each later one the
        next (JAX: PRNGKey(seed), then one split a token)."""
        draws = (None if gen.greedy
                 else self.gumbel(gen, tuple(logits.shape), logits.device))

        def pick(lg):
            return _sample(lg, gen, None if draws is None else next(draws))

        out: List[int] = []
        tok = pick(logits)
        for i in range(gen.max_new_tokens):
            t = int(tok[0])
            out.append(t)
            yield t
            if t in gen.eos_token_ids:
                break
            if stopping is not None and stopping.should_stop(out):
                break
            if i == gen.max_new_tokens - 1:
                break
            tok = pick(self.step(tok, decode_pos_start + i, cache))

    @torch.no_grad()
    def generate_stream(self, embeds, positions, gen: GenerationConfig,
                        decode_pos_start=None, segment_ids=None,
                        last_real_idx=None, stopping=None) -> Iterator[int]:
        """Incremental decode: yields the generated token ids as they are
        produced (one prefill, then one step a token)."""
        B, S, _ = embeds.shape
        if B != 1:
            raise ValueError("generation supports batch 1 per stream")
        self._check_len(S, gen)
        cache = self.new_cache(B, self._active_len(S, gen.max_new_tokens))
        logits = self.prefill(embeds, positions, cache, segment_ids,
                              last_real_idx)
        if decode_pos_start is None:
            decode_pos_start = S
        yield from self._stream_tokens(logits, cache, gen,
                                       int(decode_pos_start), stopping)

    @torch.no_grad()
    def generate_batch(
        self,
        embeds: torch.Tensor,            # [B, S, D] LEFT-padded prompts
        positions: torch.Tensor,         # [B, S] or [3, B, S]
        segment_ids: torch.Tensor,       # [B, S]; -1 at padding
        gen: GenerationConfig,
        decode_pos_start,                # [B] first decode position per row
        last_real_idx=None,              # [B] last real position per row
    ) -> List[List[int]]:
        """Greedy decode of B prompts together (JAX :335-367): each row
        stops at its own EOS (and then repeats it) and the loop ends when
        every row has, or at max_new_tokens; each row is cut after its first
        EOS."""
        B, S, _ = embeds.shape
        self._check_len(S, gen)
        cache = self.new_cache(B, self._active_len(S, gen.max_new_tokens))
        logits = self.prefill(embeds, positions, cache, segment_ids,
                              last_real_idx)
        pos0 = torch.as_tensor(decode_pos_start, device=self.device).reshape(B)
        stop = torch.tensor(sorted(set(gen.eos_token_ids)),
                            dtype=torch.long, device=self.device)
        tok = logits.argmax(dim=-1)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        outs = []
        for i in range(gen.max_new_tokens):
            outs.append(tok)
            done = done | torch.isin(tok, stop)
            if bool(done.all()) or i == gen.max_new_tokens - 1:
                break
            ntok = self.step(tok, pos0 + i, cache).argmax(dim=-1)
            tok = torch.where(done, tok, ntok)
        rows = torch.stack(outs, dim=1).tolist()
        return [_first_stop(r, set(gen.eos_token_ids)) for r in rows]
