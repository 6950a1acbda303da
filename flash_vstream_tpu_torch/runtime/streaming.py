"""Streaming sessions of both families: frames in, the memory on the
device, answers against the latest memory snapshot.

`LLaVAStreamSession` is the port of flash_vstream_tpu/runtime/
streaming.py:158-460 for one stream on one device: an ingest runs the
device preprocess, CLIP (attention through K1) and `star_stream_update`
(the ring bank of max_frames_static frames, k-means into the long memory,
the NTM Turing memory, key frames retrieved from the bank) and publishes a
`STARMemory` snapshot; an answer packs the snapshot's valid tokens into a
memory bucket (`bucket_up` of the saturated count, the padded slots at
segment -1, the question's positions continuing after the real memory),
projects them, splices them into the vicuna_v1 prompt and decodes as the
GenerationConfig asks. JAX fuses the greedy answer's assembly, prefill and
decode in one jit; here every answer takes the Generator's eager paths,
which give the same ids. The k-means draws come from a generator seeded by
the ingest step (`_uniforms`), where JAX keys them by the step.

`QwenStreamSession` is the port of `QwenStreamSession`
(streaming.py:462-836) for one stream on one device:

- ingest: uint8 frames -> device preprocess -> temporal pool -> the dual-
  resolution ViT (attention through K1) -> `flash_stream_update` (ring
  banks, ordered k-means into the CSM clusters, DAM retrieval gathered by
  K2). Each ingest publishes a (snapshot, frame-pair count) pair; the
  snapshot's tensors are fresh, so a later ingest never changes them.
- answer: PatchMerger over the snapshot, AM-RoPE positions, the ChatML
  splice, a Qwen2 prefill into the KV cache (K1) and the decode that the
  GenerationConfig asks for (runtime/generation.py: greedy, sampled,
  preemptible or speculative); `answer_stream` yields the text as it
  decodes.
- `clone_fresh` gives a new stream over the same model and Generator;
  `save_session` / `load_session` keep a stream's memory across processes.

PyTorch runs eagerly, so the JAX version's jit caches and prompt-shape
buckets for compilation have no counterpart here; the memory-length buckets
of the prompt (`bucket_up`) are kept, because they decide the prompt. The
model may be quantized (int8 or int4 decoder, int8 ViT blocks), and the
answers' KV cache int8 (`kv_cache_dtype=torch.int8`). A saved session is a
`torch.save` file, where JAX writes an orbax checkpoint (orbax imports
jax); it holds no cache. Not ported yet: multi-stream and disaggregated
serving (ROADMAP A15, A16).
"""
from __future__ import annotations

import copy
import os
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import IMAGE_TOKEN_INDEX, VStreamLLaVAConfig
from ..models.flash_memory import (
    FlashState,
    am_rope_visual_positions,
    flash_stream_update,
    init_flash_state,
)
from ..models.llm import Qwen2Decoder
from ..models.projector import project
from ..models.star_memory import (STARMemory, STARState, init_star_state,
                                  star_memory_tokens, star_stream_update)
from ..models.vstream_llava import (encode_frames, pack_memory_tokens,
                                    splice_image, star_valid_counts)
from ..models.vstream_qwen import VStreamQwen
from ..ops.pooling import qwen_temporal_pool
from ..preprocess.image import (clip_device_preprocess, clip_resize_u8,
                                qwen_device_preprocess, qwen_resize_u8,
                                smart_resize)
from ..preprocess.prompts import conv_templates
from ..preprocess.qwen_processor import build_video_prompt
from .generation import (GenerationConfig, Generator, default_gen,
                         trim_stop_strings)
from .metrics import MetricMeter, Timer
from .pipeline import llava_prompt, seeded_draws


def _stream_text(generator, tokenizer, embeds, positions, gen,
                 decode_start, segment_ids, last_real,
                 stop_strings) -> Iterator[str]:
    """Text deltas of a stepwise decode (JAX streaming.py:127-155): the
    whole output is decoded again at every token, so a character made of
    several tokens or bytes is emitted once, whole, and a trailing U+FFFD
    (an incomplete UTF-8 sequence) is held back. Ends at the first stop
    string, which is cut."""
    toks: List[int] = []
    emitted = ""
    for t in generator.generate_stream(
            embeds, positions, gen, decode_pos_start=decode_start,
            segment_ids=segment_ids, last_real_idx=last_real):
        toks.append(t)
        if t in gen.eos_token_ids:
            break
        text = tokenizer.decode(toks, skip_special_tokens=True)
        trimmed = trim_stop_strings(text, stop_strings)
        if trimmed != text.strip():       # a stop string appeared
            if len(trimmed) > len(emitted):
                yield trimmed[len(emitted):]
            return
        safe = text[:-1] if text.endswith("\ufffd") else text
        if len(safe) > len(emitted):
            yield safe[len(emitted):]
            emitted = safe
    text = trim_stop_strings(
        tokenizer.decode(toks, skip_special_tokens=True), stop_strings)
    if len(text) > len(emitted):
        yield text[len(emitted):]


def bucket_candidates(cap: int):
    """The memory lengths `bucket_up` can return for a capacity."""
    return (max(cap // 4, 1), max(cap // 2, 1), cap)


def bucket_up(real: int, cap: int) -> int:
    """Round a memory length up to one of the buckets of `cap` (cap/4,
    cap/2, cap); padded memory slots are masked out by segment ids."""
    for b in bucket_candidates(cap):
        if real <= b:
            return b
    return cap


def _one_per_bucket(counts, bucket) -> List[int]:
    """The first of `counts` in each distinct `bucket(count)`."""
    seen, out = set(), []
    for n in counts:
        if bucket(n) not in seen:
            seen.add(bucket(n))
            out.append(n)
    return out


def _save_state(session, state_cls, path: str) -> str:
    """`torch.save` of a session's stream: its state's fields, the
    published snapshot (a tuple of tensors), its count and the ingest
    step; returns the absolute path."""
    snap, count = session._published
    payload = {
        "state": {k: getattr(session.state, k) for k in state_cls._fields},
        "snapshot": None if snap is None else list(snap),
        "count": int(count), "step": int(session._step)}
    path = os.path.abspath(path)
    torch.save(payload, path)
    return path


def _load_state(session, state_cls, path: str, snap_builder) -> None:
    """Restore what `_save_state` wrote into `session` (read with
    weights_only=True). A state field whose shape or dtype differs from the
    session's raises, naming the field: the config or the bank size is not
    the one saved."""
    payload = torch.load(os.path.abspath(path), map_location=session.device,
                         weights_only=True)
    fields = payload["state"]
    for name in state_cls._fields:
        want, got = getattr(session.state, name), fields[name]
        if isinstance(want, torch.Tensor) and (
                not isinstance(got, torch.Tensor)
                or got.shape != want.shape or got.dtype != want.dtype):
            desc = (f"{tuple(got.shape)} {got.dtype}"
                    if isinstance(got, torch.Tensor) else type(got))
            raise ValueError(
                f"restored session state field {name!r} is {desc}, this "
                f"session expects {tuple(want.shape)} {want.dtype}: the "
                f"config or the bank size differs")
    session.state = state_cls(**fields)
    snap = payload["snapshot"]
    session._published = (None if snap is None else snap_builder(snap),
                          int(payload["count"]))
    session._step = int(payload["step"])


class LLaVAStreamSession:
    """One live video stream answered by a Flash-VStream-LLaVA model (the
    JAX tree {"vit", "projector", "ntm", "llm"}, as the JAX session takes
    it)."""

    def __init__(self, params: dict, cfg: VStreamLLaVAConfig, tokenizer,
                 clip_size: int = 1, conv_template: str = "vicuna_v1",
                 max_len: int = 4096, kv_cache_dtype=None):
        """`params["llm"]` may carry quantized weights
        (weights/quantize.py); `kv_cache_dtype` is the answers' cache
        (default bf16; torch.int8 quantizes k/v per position)."""
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.clip_size = clip_size
        self.conv_template = conv_template
        self.metrics = MetricMeter()
        self.generator = Generator(Qwen2Decoder(cfg.llm, params["llm"]),
                                   max_len=max_len,
                                   cache_dtype=kv_cache_dtype or torch.bfloat16)
        self.device = self.generator.device
        self.reset()

    def reset(self):
        """A fresh stream: empty memory, no published snapshot, step 0."""
        self.state = init_star_state(
            self.cfg.star, self.cfg.projector.effective_input_dim,
            device=self.device)
        # (STARMemory snapshot, frame count), published together
        self._published = (None, 0)
        self._step = 0

    def _uniforms(self, step: int, n: int) -> torch.Tensor:
        """Uniform draws [n] of ingest `step` (its k-means init or drop
        coins), from a generator seeded by the step, as the JAX session
        keys its draws by the step."""
        return seeded_draws(step, self.device)(n)

    @torch.no_grad()
    def _ingest(self, frames_u8: torch.Tensor, n_new: int):
        feats = encode_frames(self.params, self.cfg,
                              clip_device_preprocess(frames_u8))
        step = self._step
        state = star_stream_update(self.params["ntm"], self.cfg.star,
                                   self.state, feats, n_new,
                                   lambda n: self._uniforms(step, n))
        return state, star_memory_tokens(self.cfg.star, state)

    def ingest_frames(self, frames: Sequence[np.ndarray]):
        """Fold up to `clip_size` frames into the memory (a partial clip is
        padded with black frames that stay invalid) and publish the new
        snapshot."""
        if len(frames) > self.clip_size:
            raise ValueError(f"{len(frames)} frames exceed clip_size "
                             f"{self.clip_size}")
        with Timer(self.metrics, "memory_latency_host_preprocess"):
            imgs = clip_resize_u8(frames, self.cfg.vit.image_size)
            n = len(frames)
            pad = self.clip_size - n
            if pad > 0:
                imgs = np.concatenate([imgs, np.zeros_like(imgs[:1])
                                       .repeat(pad, 0)])
        t0 = time.perf_counter()
        frames_dev = torch.from_numpy(imgs).to(self.device)
        self.state, snapshot = self._ingest(frames_dev, n)
        self._step += 1
        self._published = (snapshot, self._published[1] + n)
        self.metrics.update("memory_latency_dispatch",
                            time.perf_counter() - t0)

    def block_until_ingested(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def n_frames(self) -> int:
        """Published frame count (paired with the published snapshot)."""
        return self._published[1]

    def _bucket_n_mem(self, n_mem_real: int) -> int:
        """The memory token count rounded up to a bucket of its saturated
        size (`bucket_up`); the padded slots get segment -1."""
        sat = sum(star_valid_counts(self.cfg, self.cfg.star.video_max_frames,
                                    streaming=True))
        return bucket_up(n_mem_real, sat)

    def prewarm_frame_counts(self) -> List[int]:
        """One frame count for each distinct memory bucket of an answer's
        prompt (what `--prewarm` answers at)."""
        return _one_per_bucket(
            range(1, self.cfg.star.video_max_frames + 1),
            lambda n: self._bucket_n_mem(
                sum(star_valid_counts(self.cfg, n, streaming=True))))

    @torch.no_grad()
    def _prompt_parts(self, question: str, memory: STARMemory,
                      n_frames: int):
        """(embeds [1, S, D], positions [1, S], decode_start, segment row
        [S], last_real_idx) of one snapshot. The layout is [pre | n_mem
        memory slots, the first n_mem_real real | the question padded to a
        multiple of 32]; padded slots have segment -1 and position 0, and
        the question's positions continue after the real memory."""
        n_mem_real = sum(star_valid_counts(self.cfg, n_frames,
                                           streaming=True))
        n_mem = self._bucket_n_mem(n_mem_real)
        input_ids = llava_prompt(question, self.tokenizer,
                                 self.conv_template)[1]
        p = int(np.where(input_ids == IMAGE_TOKEN_INDEX)[0][0])
        pre, post = input_ids[:p], input_ids[p + 1:]
        q_real = len(post)
        qb = -(-q_real // 32) * 32
        pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        post_p = np.pad(post, (0, qb - q_real), constant_values=pad_id)
        proj = project(self.params["projector"], self.cfg.projector,
                       pack_memory_tokens(memory, n_mem))
        embeds = splice_image(self.params["llm"], pre, post_p, proj)
        S = embeds.shape[1]
        positions = np.zeros(S, np.int64)
        seg = np.full(S, -1, np.int32)
        positions[:p] = np.arange(p)
        seg[:p] = 0
        positions[p:p + n_mem_real] = p + np.arange(n_mem_real)
        seg[p:p + n_mem_real] = 0
        post_pos0 = p + n_mem_real
        positions[p + n_mem:p + n_mem + q_real] = post_pos0 + np.arange(q_real)
        seg[p + n_mem:p + n_mem + q_real] = 0
        return (embeds, torch.as_tensor(positions, device=self.device)[None],
                post_pos0 + q_real, seg, p + n_mem + q_real - 1)

    def _stop(self, gen: GenerationConfig):
        return (tuple(gen.stop_strings)
                or (conv_templates[self.conv_template].stop_str,))

    @torch.no_grad()
    def answer_tokens(self, snapshot: STARMemory, n_frames: int,
                      question: str, gen: GenerationConfig) -> List[int]:
        """The answer's token ids (up to and including EOS) against an
        explicit (snapshot, count) pair, decoded as `gen` asks.
        Speculation drafts from the prompt's text ids."""
        embeds, positions, decode_start, seg, last_real = \
            self._prompt_parts(question, snapshot, n_frames)
        ctx = None
        if gen.speculative_k > 0:
            ids = llava_prompt(question, self.tokenizer,
                               self.conv_template)[1]
            ctx = ids[ids >= 0]                  # text ids only
        return self.generator.generate(
            embeds, positions, gen, decode_pos_start=decode_start,
            segment_ids=torch.as_tensor(seg, device=self.device)[None],
            last_real_idx=last_real, context_ids=ctx)

    def answer(self, question: str,
               gen: Optional[GenerationConfig] = None) -> str:
        """Answer against the latest published snapshot."""
        with Timer(self.metrics, "llm_latency"):
            with Timer(self.metrics, "llm_latency_memoryio"):
                memory, n_frames = self._published
            if memory is None:
                raise RuntimeError("no frames ingested yet")
            gen = gen or default_gen(self.tokenizer)
            toks = self.answer_tokens(memory, n_frames, question, gen)
            self.metrics.update("answer_tokens", len(toks))
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        return trim_stop_strings(text, self._stop(gen))

    def answer_stream(self, question: str,
                      gen: Optional[GenerationConfig] = None
                      ) -> Iterator[str]:
        """The answer against the latest snapshot as text deltas, yielded
        as the tokens decode (the reference's TextStreamer,
        cli_video_stream.py:292-309)."""
        memory, n_frames = self._published
        if memory is None:
            raise RuntimeError("no frames ingested yet")
        gen = gen or default_gen(self.tokenizer)
        embeds, positions, decode_start, seg, last_real = \
            self._prompt_parts(question, memory, n_frames)
        yield from _stream_text(
            self.generator, self.tokenizer, embeds, positions, gen,
            decode_start, torch.as_tensor(seg, device=self.device)[None],
            last_real, self._stop(gen))

    def clone_fresh(self) -> "LLaVAStreamSession":
        """A new, independent stream over this session's parameters,
        Generator and tokenizer, with fresh memory, counters and metrics
        (`reset` allocates new state tensors: the banks written in place
        are never shared)."""
        c = copy.copy(self)
        c.metrics = MetricMeter()
        c.reset()
        return c

    def save_session(self, path: str) -> str:
        """Write this stream's memory (the state's fields, the published
        snapshot, its frame count and the ingest step) to `path` with
        `torch.save`; returns the absolute path."""
        return _save_state(self, STARState, path)

    def load_session(self, path: str) -> None:
        """Resume the stream `save_session` wrote (read with
        weights_only=True); a state field whose shape or dtype differs
        from this session's raises, naming the field."""
        _load_state(self, STARState, path,
                    lambda snap: STARMemory(*snap))


class QwenStreamSession:
    """One live video stream answered by a Flash-VStream-Qwen model."""

    def __init__(self, model: VStreamQwen, tokenizer, frame_hw=(224, 224),
                 clip_size: int = 2, bank_size: int = 1024,
                 max_len: int = 16384, max_pixels: int = 4 * 224 * 224,
                 kv_cache_dtype=None, placement=None):
        """`model` may carry quantized weights (weights/quantize.py);
        `kv_cache_dtype` is the answers' cache (default bf16; torch.int8
        quantizes k/v per position). A disaggregated placement is not
        ported."""
        if placement is not None:
            raise NotImplementedError("disaggregated serving is not ported "
                                      "yet: ROADMAP A16")
        if clip_size % 2:
            raise ValueError("Qwen streaming ingests temporal frame pairs; "
                             f"clip_size must be even (got {clip_size})")
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.clip_size = clip_size
        self.metrics = MetricMeter()
        self.device = model.llm.device
        self.generator = Generator(model.llm, max_len=max_len,
                                   cache_dtype=kv_cache_dtype or torch.bfloat16)
        self.resize_hw = smart_resize(*frame_hw, factor=56,
                                      max_pixels=max_pixels)
        gh, gw = self.resize_hw[0] // 14, self.resize_hw[1] // 14
        self.grid_hw = (gh, gw)
        self.p_full = gh * gw
        self.p_small = (gh // 2) * (gw // 2)
        self._bank_size = bank_size
        self.reset()

    def reset(self):
        """A fresh stream: empty memory, no published snapshot, step 0."""
        self.state = init_flash_state(
            self.cfg.flash_memory, self.p_full, self.p_small,
            self.cfg.vit.hidden_size, bank_size=self._bank_size,
            device=self.device)
        # ((spa_pos, tem_pos, spa_x, tem_x), frame-pair count), published
        # together so an answer always pairs a snapshot with its count
        self._published = (None, 0)
        self._step = 0

    def _init_scores(self, step: int, n: int) -> torch.Tensor:
        """Uniform draws [n] for the k-means init of ingest `step`, from a
        generator seeded by the step (the JAX session keys its draw by the
        step the same way)."""
        return seeded_draws(step, self.device)(n)

    @torch.no_grad()
    def _ingest(self, frames_u8: torch.Tensor, n_new: int):
        t_clip = self.clip_size // 2
        gh, gw = self.grid_hw
        S = t_clip * self.p_full
        D = self.cfg.vit.hidden_size
        patches = qwen_device_preprocess(frames_u8)
        small, _ = qwen_temporal_pool(patches, (t_clip, gh, gw))
        hidden = self.model.vit(torch.cat([patches, small]),
                                t_full=t_clip, hw_full=(gh, gw),
                                t_small=t_clip, hw_small=(gh // 2, gw // 2))
        x = hidden[:S].reshape(t_clip, self.p_full, D)
        sx = hidden[S:].reshape(t_clip, self.p_small, D)
        fm = self.cfg.flash_memory
        scores = self._init_scores(self._step, fm.csm_grid_len + t_clip)
        state, out = flash_stream_update(fm, self.state, x, sx, n_new, scores)
        # raw memory rows; the patch merger runs at answer time
        return state, (out.spa_positions, out.tem_positions, out.spa_x,
                       out.tem_x)

    def ingest_frames(self, frames: Sequence[np.ndarray]):
        """Fold up to `clip_size` frames (any layout `qwen_resize_u8` takes)
        into the memory and publish the new snapshot."""
        if len(frames) > self.clip_size:
            raise ValueError(f"{len(frames)} frames exceed clip_size "
                             f"{self.clip_size}")
        with Timer(self.metrics, "memory_latency_host_preprocess"):
            arr = list(qwen_resize_u8(frames, self.resize_hw,
                                      pad_to_even=False))
            n = len(arr)
            while len(arr) % 2 or len(arr) < self.clip_size:
                arr.append(arr[-1])
            frames_u8 = np.stack(arr)
        t0 = time.perf_counter()
        n_pairs = -(-n // 2)
        frames_dev = torch.from_numpy(frames_u8).to(self.device)
        self.state, snapshot = self._ingest(frames_dev, n_pairs)
        self._step += 1
        self._published = (snapshot, self._published[1] + n_pairs)
        self.metrics.update("memory_latency_dispatch", time.perf_counter() - t0)

    def block_until_ingested(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def n_frames(self) -> int:
        """Published frame-pair count (paired with the published snapshot)."""
        return self._published[1]

    def prewarm_frame_counts(self) -> List[int]:
        """One frame count for each distinct (DAM, CSM) bucket pair of an
        answer's prompt (what `--prewarm` answers at)."""
        fm = self.cfg.flash_memory
        return _one_per_bucket(
            sorted(set(bucket_candidates(fm.dam_grid_len))
                   | set(bucket_candidates(fm.csm_grid_len))),
            lambda n: (bucket_up(min(n, fm.dam_grid_len), fm.dam_grid_len),
                       bucket_up(min(n, fm.csm_grid_len), fm.csm_grid_len)))

    def _prompt_host(self, question: str, n_frames: int) -> dict:
        """Host-side prompt pieces for one snapshot: bucketed memory sizes,
        pre/post token ids (question padded to a multiple of 32), and the
        segment row (padded memory slots and the padded tail get id -1, so
        attention never sees them)."""
        fm = self.cfg.flash_memory
        t_dam_real = min(n_frames, fm.dam_grid_len)
        t_csm_real = min(n_frames, fm.csm_grid_len)
        t_dam = bucket_up(t_dam_real, fm.dam_grid_len)
        t_csm = bucket_up(t_csm_real, fm.csm_grid_len)
        n_dam = t_dam * self.p_full // 4
        n_csm = t_csm * self.p_small // 4
        n_vis = n_dam + n_csm

        input_ids, (start, _) = build_video_prompt(
            self.cfg, self.tokenizer, question, n_video_tokens=n_vis)
        pre = input_ids[:start]
        post = input_ids[start + n_vis:]
        q_real = len(post)
        Qb = -(-q_real // 32) * 32
        pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        post_p = np.pad(post, (0, Qb - q_real), constant_values=pad_id)
        P = len(pre)
        S = P + n_vis + Qb
        vis_valid = np.concatenate([
            np.arange(n_dam) < t_dam_real * self.p_full // 4,
            np.arange(n_csm) < t_csm_real * self.p_small // 4])
        seg_row = np.concatenate([
            np.zeros(P, np.int32),
            np.where(vis_valid, 0, -1).astype(np.int32),
            np.zeros(q_real, np.int32),
            np.full(S - P - n_vis - q_real, -1, np.int32)])
        return {"t_dam": t_dam, "t_csm": t_csm, "P": P, "Qb": Qb, "S": S,
                "n_vis": n_vis, "pre": pre, "post_p": post_p, "q_real": q_real,
                "seg_row": seg_row, "last_real": P + n_vis + q_real - 1}

    @torch.no_grad()
    def _prompt_inputs(self, snapshot, h: dict):
        """(embeds [1, S, D], positions [3, 1, S], decode_start, segment row
        [1, S]) for one snapshot and its host-side prompt pieces."""
        spa_pos, tem_pos, spa_x, tem_x = snapshot
        t_dam, t_csm, P, Qb = h["t_dam"], h["t_csm"], h["P"], h["Qb"]
        gh, gw = self.grid_hw
        dev = self.device
        llm = self.model.llm
        D = spa_x.shape[-1]
        vis = self.model.vit.merger(torch.cat([
            spa_x[:t_dam].reshape(-1, D),
            tem_x[:t_csm].to(spa_x.dtype).reshape(-1, D)]))
        vis_pos = am_rope_visual_positions(spa_pos[:t_dam], tem_pos[:t_csm],
                                           (gh, gw), (gh // 2, gw // 2))
        pre = torch.as_tensor(h["pre"], device=dev)
        post = torch.as_tensor(h["post_p"], device=dev)
        text_pre = llm.embed_tokens(pre[None])
        embeds = torch.cat([text_pre, vis[None].to(text_pre.dtype),
                            llm.embed_tokens(post[None])], dim=1)
        # 3D rope positions with the AM-RoPE visual block; text after it
        # resumes at max + 1
        vpos = vis_pos.long() + P
        st = vpos.max() + 1
        pos = torch.cat([
            torch.arange(P, device=dev)[None].expand(3, P),
            vpos,
            st + torch.arange(Qb, device=dev)[None].expand(3, Qb)], dim=1)
        seg = torch.as_tensor(h["seg_row"], device=dev)[None]
        return embeds, pos[:, None, :], st + h["q_real"], seg

    def answer(self, question: str,
               gen: Optional[GenerationConfig] = None) -> str:
        """Answer against the latest published snapshot."""
        with Timer(self.metrics, "llm_latency"):
            with Timer(self.metrics, "llm_latency_memoryio"):
                snapshot, n_frames = self._published
            if snapshot is None:
                raise RuntimeError("no frames ingested yet")
            return self.answer_snapshot(snapshot, n_frames, question, gen)

    def answer_snapshot(self, snapshot, n_frames: int, question: str,
                        gen: Optional[GenerationConfig] = None) -> str:
        """Answer against an explicit (snapshot, count) pair without
        touching the session's state, so callers holding different
        snapshots may answer at once."""
        gen = gen or default_gen(self.tokenizer)
        toks = self.answer_tokens(snapshot, n_frames, question, gen)
        self.metrics.update("answer_tokens", len(toks))
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        # ChatML assistant turns end on <|im_end|>
        return trim_stop_strings(text,
                                 tuple(gen.stop_strings) or ("<|im_end|>",))

    def answer_tokens(self, snapshot, n_frames: int, question: str,
                      gen: GenerationConfig) -> list:
        """The answer's token ids (up to and including EOS), decoded as
        `gen` asks. Speculation drafts from the prompt's text: the ids
        before the memory and the real question ids after it (JAX
        streaming.py:825-828)."""
        h = self._prompt_host(question, n_frames)
        embeds, positions, decode_start, seg = self._prompt_inputs(snapshot, h)
        ctx = (np.concatenate([h["pre"], h["post_p"][:h["q_real"]]])
               if gen.speculative_k > 0 else None)
        return self.generator.generate(
            embeds, positions, gen, decode_pos_start=decode_start,
            segment_ids=seg, last_real_idx=h["last_real"], context_ids=ctx)

    def answer_stream(self, question: str,
                      gen: Optional[GenerationConfig] = None
                      ) -> Iterator[str]:
        """The answer against the latest snapshot as text deltas, yielded
        as the tokens decode (stepwise; preemption and speculation do not
        apply)."""
        snapshot, n_frames = self._published
        if snapshot is None:
            raise RuntimeError("no frames ingested yet")
        gen = gen or default_gen(self.tokenizer)
        h = self._prompt_host(question, n_frames)
        embeds, positions, decode_start, seg = self._prompt_inputs(snapshot, h)
        yield from _stream_text(
            self.generator, self.tokenizer, embeds, positions, gen,
            decode_start, seg, h["last_real"],
            tuple(gen.stop_strings) or ("<|im_end|>",))

    def clone_fresh(self) -> "QwenStreamSession":
        """A new, independent stream over this session's model, Generator
        and tokenizer, with fresh memory, counters and metrics. `reset`
        allocates new state tensors, so the banks the two streams write in
        place are never shared."""
        c = copy.copy(self)
        c.metrics = MetricMeter()
        c.reset()
        return c

    def save_session(self, path: str) -> str:
        """Write this stream's memory (the state's fields, the published
        snapshot, its frame-pair count and the ingest step) to `path` with
        `torch.save`; returns the absolute path."""
        return _save_state(self, FlashState, path)

    def load_session(self, path: str) -> None:
        """Resume the stream `save_session` wrote (read with
        weights_only=True). A state field whose shape or dtype differs from
        this session's raises, naming the field: the config or the bank
        size is not the one saved."""
        _load_state(self, FlashState, path, tuple)
