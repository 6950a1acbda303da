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
jax); it holds no cache. With a `placement` (parallel/serve.py) the
session is disaggregated: ingest on one device, the merger and the
tensor-parallel decoder on others, the snapshot handed across at answer
time (JAX streaming.py:469-591).
"""
from __future__ import annotations

import copy
import os
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import IMAGE_TOKEN_INDEX, VStreamLLaVAConfig
from ..kernels.gather_rows import gather_rows_batched
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
from ..models.vstream_llava import (build_multimodal_embeds, encode_frames,
                                    pack_memory_tokens, splice_image,
                                    star_valid_counts)
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
        quantizes k/v per position). With a `placement`
        (parallel/serve.py) the vision tower and the memory state live on
        its ingest device and the merger and the tensor-parallel decoder on
        its decode devices; the published snapshot moves across at answer
        time."""
        if clip_size % 2:
            raise ValueError("Qwen streaming ingests temporal frame pairs; "
                             f"clip_size must be even (got {clip_size})")
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.clip_size = clip_size
        self.metrics = MetricMeter()
        self.placement = placement
        if placement is not None:
            from ..parallel.serve import place_qwen_serve_params
            ingest, decode = place_qwen_serve_params(model, placement)
            self.vit, self.llm = ingest["vit"], decode["llm"]
            self.merger = decode["vit"]["merger"]
            self.device = placement.ingest_device
        else:
            self.vit, self.merger, self.llm = (model.vit, model.vit.merger,
                                               model.llm)
            self.device = model.llm.device
        self.generator = Generator(self.llm, max_len=max_len,
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
        """Uniform draws [n] of ingest `step` (its k-means init or drop
        coins), from a generator seeded by the step (the JAX session keys
        its draws by the step the same way)."""
        return seeded_draws(step, self.device)(n)

    @torch.no_grad()
    def _ingest(self, frames_u8: torch.Tensor, n_new: int):
        t_clip = self.clip_size // 2
        gh, gw = self.grid_hw
        S = t_clip * self.p_full
        D = self.cfg.vit.hidden_size
        patches = qwen_device_preprocess(frames_u8)
        small, _ = qwen_temporal_pool(patches, (t_clip, gh, gw))
        hidden = self.vit(torch.cat([patches, small]),
                          t_full=t_clip, hw_full=(gh, gw),
                          t_small=t_clip, hw_small=(gh // 2, gw // 2))
        x = hidden[:S].reshape(t_clip, self.p_full, D)
        sx = hidden[S:].reshape(t_clip, self.p_small, D)
        step = self._step
        state, out = flash_stream_update(
            self.cfg.flash_memory, self.state, x, sx, n_new,
            lambda n: self._init_scores(step, n))
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
        """Wait for the ingest device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def n_frames(self) -> int:
        """Published frame-pair count (paired with the published snapshot)."""
        return self._published[1]

    def _snapshot_to_decode(self, snapshot):
        """The handover: the snapshot's tensors on the first decode device
        (the same tensors without a placement, or where the two devices are
        one). A snapshot's tensors are fresh outputs of its ingest, which
        no later ingest writes in place, so an answer may hold them while
        the stream goes on."""
        if self.placement is None:
            return snapshot
        return tuple(x.to(self.llm.device) for x in snapshot)

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
        [1, S]) for one snapshot and its host-side prompt pieces, built on
        the decode side."""
        spa_pos, tem_pos, spa_x, tem_x = self._snapshot_to_decode(snapshot)
        t_dam, t_csm, P, Qb = h["t_dam"], h["t_csm"], h["P"], h["Qb"]
        gh, gw = self.grid_hw
        llm = self.llm
        dev = llm.device
        D = spa_x.shape[-1]
        vis = self.merger(torch.cat([
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


def stream_draws(device) -> Callable[[int, int, int], torch.Tensor]:
    """(step, stream, n) -> [n] uniform draws of one stream's ingest `step`
    in an engine, from a generator seeded by (step, stream): the JAX
    engines key stream s of ingest `step` with split(PRNGKey(step), N)[s]."""
    def draws(step: int, s: int, n: int) -> torch.Tensor:
        return seeded_draws(step * 1_000_003 + s, device)(n)
    return draws


def _stack_state(one, n: int):
    """n copies of a state's tensor fields on a new leading stream axis,
    one allocation each (so that a stream's bank is a row of one
    contiguous [N, ...] tensor)."""
    return type(one)(**{
        k: (v.unsqueeze(0).repeat(n, *([1] * v.dim()))
            if isinstance(v, torch.Tensor) else v)
        for k, v in one._asdict().items()})


def _stream_view(states, s: int, n_frames: int):
    """Stream s of stacked states: views of its rows (a write to the view's
    bank lands in the stack), with its own host frame count."""
    return type(states)(**{
        k: (v[s] if isinstance(v, torch.Tensor) else n_frames)
        for k, v in states._asdict().items()})


def _write_back(states, s: int, new, skip=("bank", "bank_small",
                                          "bank_pos")) -> None:
    """Copy stream s's new state into the stack (the banks were written in
    place). The new state's tensors stay what they are, so a snapshot
    holding them never sees a later ingest."""
    for k, v in new._asdict().items():
        if isinstance(v, torch.Tensor) and k not in skip:
            getattr(states, k)[s].copy_(v)


def _left_pad(parts, pos_axis_3d: bool):
    """Left-pad per-stream prompts into one batch: parts are (embeds [1, n,
    D], positions [1, n] or [3, 1, n], segment row [n]); returns (embeds
    [B, S, D], positions [B, S] or [3, B, S], segments [B, S] with -1 at
    the padding, each row's pad count)."""
    S = max(e.shape[1] for e, _, _ in parts)
    B, D = len(parts), parts[0][0].shape[-1]
    dev = parts[0][0].device
    embeds = torch.zeros((B, S, D), dtype=parts[0][0].dtype, device=dev)
    pos_shape = (3, B, S) if pos_axis_3d else (B, S)
    positions = torch.zeros(pos_shape, dtype=torch.long, device=dev)
    segments = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    pads = []
    for b, (e, p, seg) in enumerate(parts):
        n = e.shape[1]
        embeds[b, S - n:] = e[0]
        if pos_axis_3d:
            positions[:, b, S - n:] = p[:, 0]
        else:
            positions[b, S - n:] = p[0]
        segments[b, S - n:] = torch.as_tensor(seg, device=dev)
        pads.append(S - n)
    return embeds, positions, segments, pads


class _Engine:
    """What both multi-stream engines share: the published (per-stream
    snapshots, per-stream frame counts) pair, swapped by one reference
    assignment, the ingest step that keys the draws, and the checks of
    per-stream arguments."""

    def _reset(self, n_streams: int, clip_size: int):
        self.n_streams = n_streams
        self.clip_size = clip_size
        self._published = (None, (0,) * n_streams)
        self._step = 0

    @property
    def n_frames(self) -> Tuple[int, ...]:
        """Published frame count of each stream (Qwen: frame pairs)."""
        return self._published[1]

    def _per_stream(self, items: Sequence, what: str) -> None:
        if len(items) != self.n_streams:
            raise ValueError(f"{len(items)} {what} for {self.n_streams} "
                             f"streams")

    def _check_clips(self, clips: Sequence[Sequence[np.ndarray]]) -> None:
        self._per_stream(clips, "clips")
        for clip in clips:
            if len(clip) > self.clip_size:
                raise ValueError(f"clip of {len(clip)} frames > clip_size "
                                 f"{self.clip_size}")

    def _publish(self, snaps: list, ns: Sequence[int]) -> None:
        self._step += 1
        self._published = (snaps, tuple(c + n for c, n in
                                        zip(self._published[1], ns)))

    def _snapshots(self):
        if self._published[0] is None:
            raise RuntimeError("no frames ingested yet")
        return self._published

    def block(self):
        """Wait for the device to finish every ingest dispatched so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class QwenMultiStreamEngine(_Engine):
    """N concurrent Qwen-family streams (JAX streaming.py:856-969): their
    FlashStates stack on a leading stream axis; an ingest runs one device
    preprocess, temporal pool and ViT over every stream's frames, then each
    stream's own `flash_stream_update` on views of the stack, then gathers
    every stream's DAM frames in one K2 launch (`gather_rows_batched`).
    `answer_all` serves every stream's question through one left-padded
    batched prefill and `Generator.generate_batch`.

    JAX vmaps the whole update; here each stream's update runs on its own,
    because the frame counts are host ints and streams fed ragged clips
    sit on different sides of the short-stream branches. Draws come from
    `draws(step, stream, n)` (default `stream_draws`)."""

    def __init__(self, model: VStreamQwen, tokenizer, n_streams: int,
                 frame_hw=(224, 224), clip_size: int = 2,
                 bank_size: int = 256, max_len: int = 8192,
                 max_pixels: int = 4 * 224 * 224, draws=None):
        self._reset(n_streams, clip_size)
        self.sess = QwenStreamSession(model, tokenizer, frame_hw=frame_hw,
                                      clip_size=clip_size,
                                      bank_size=bank_size, max_len=max_len,
                                      max_pixels=max_pixels)
        self.device = self.sess.device
        self.draws = draws or stream_draws(self.device)
        self.states = _stack_state(self.sess.state, n_streams)
        self.sess.state = None          # the engine's streams hold the state

    def ingest(self, clips: Sequence[Sequence[np.ndarray]]):
        """One clip per stream (ragged; an empty clip adds no frame, though
        its stream's memory is updated, as JAX's vmapped update does)."""
        self._check_clips(clips)
        sess = self.sess
        nh, nw = sess.resize_hw
        frames, ns = [], []
        for clip in clips:
            arr = (list(qwen_resize_u8(clip, (nh, nw), pad_to_even=False))
                   if len(clip) else [])
            n = len(arr)
            while len(arr) % 2 or len(arr) < sess.clip_size:
                arr.append(arr[-1] if arr else np.zeros((nh, nw, 3), np.uint8))
            frames.append(np.stack(arr[:sess.clip_size]))
            ns.append(-(-n // 2))
        u8 = torch.from_numpy(np.concatenate(frames)).to(self.device)
        self._publish(self._ingest(u8, ns, self._step), ns)

    @torch.no_grad()
    def _ingest(self, frames_u8: torch.Tensor, ns: List[int], step: int):
        sess = self.sess
        N, t_clip = self.n_streams, sess.clip_size // 2
        gh, gw = sess.grid_hw
        S = N * t_clip * sess.p_full
        D = sess.cfg.vit.hidden_size
        # one encode for every stream: the ViT's attention is frame-local and
        # its rope 2D, so stacking the streams' frames computes the same
        patches = qwen_device_preprocess(frames_u8)
        small, _ = qwen_temporal_pool(patches, (N * t_clip, gh, gw))
        hidden = sess.model.vit(torch.cat([patches, small]),
                                t_full=N * t_clip, hw_full=(gh, gw),
                                t_small=N * t_clip,
                                hw_small=(gh // 2, gw // 2))
        x = hidden[:S].reshape(N, t_clip, sess.p_full, D)
        sx = hidden[S:].reshape(N, t_clip, sess.p_small, D)
        fm = sess.cfg.flash_memory
        outs, idx = [], []
        for s in range(N):
            view = _stream_view(self.states, s, self._published[1][s])
            new, out, i = flash_stream_update(
                fm, view, x[s], sx[s], ns[s],
                lambda n, s=s: self.draws(step, s, n), gather=False)
            _write_back(self.states, s, new)
            outs.append(out)
            idx.append(i)
        # every stream's DAM rows in one K2 launch
        spa_x = gather_rows_batched(self.states.bank, torch.stack(idx))
        return [(o.spa_positions, o.tem_positions, spa_x[s], o.tem_x)
                for s, o in enumerate(outs)]

    def answer(self, stream_idx: int, question: str,
               gen: Optional[GenerationConfig] = None) -> str:
        """Stream i's answer against its published snapshot; the shared
        session's state is never touched, so threads may answer streams
        at once."""
        snaps, counts = self._snapshots()
        return self.sess.answer_snapshot(snaps[stream_idx],
                                         counts[stream_idx], question, gen)

    @torch.no_grad()
    def batch_inputs(self, questions: Sequence[str]):
        """The batched prefill's inputs, every stream's prompt left-padded
        to the longest: (embeds [N, S, D], positions [3, N, S], segments
        [N, S], decode starts [N], last real indices [N]), or None when the
        streams' memory buckets differ (their prompts then differ in
        layout, as in JAX)."""
        snaps, counts = self._snapshots()
        self._per_stream(questions, "questions")
        sess = self.sess
        fm = sess.cfg.flash_memory
        if (len({bucket_up(min(c, fm.dam_grid_len), fm.dam_grid_len)
                 for c in counts}) > 1
                or len({bucket_up(min(c, fm.csm_grid_len), fm.csm_grid_len)
                        for c in counts}) > 1):
            return None
        parts, starts, lasts = [], [], []
        for i, q in enumerate(questions):
            h = sess._prompt_host(q, counts[i])
            embeds, pos, dstart, seg = sess._prompt_inputs(snaps[i], h)
            parts.append((embeds, pos, seg[0]))
            starts.append(int(dstart))
            lasts.append(h["last_real"])
        embeds, positions, segments, pads = _left_pad(parts, True)
        return (embeds, positions, segments, starts,
                [p + last for p, last in zip(pads, lasts)])

    def answer_all(self, questions: Sequence[str],
                   gen: Optional[GenerationConfig] = None) -> List[str]:
        """Every stream's question through one batched prefill and decode
        loop; per-stream answers when the memory buckets differ."""
        inputs = self.batch_inputs(questions)
        if inputs is None:
            return [self.answer(i, q, gen) for i, q in enumerate(questions)]
        sess = self.sess
        gen = gen or default_gen(sess.tokenizer)
        embeds, positions, segments, starts, lasts = inputs
        outs = sess.generator.generate_batch(embeds, positions, segments, gen,
                                             starts, last_real_idx=lasts)
        stops = tuple(gen.stop_strings) or ("<|im_end|>",)
        return [trim_stop_strings(
                    sess.tokenizer.decode(o, skip_special_tokens=True), stops)
                for o in outs]


class MultiStreamEngine(_Engine):
    """N concurrent LLaVA-family streams (JAX streaming.py:1059-1164): their
    STARStates stack on a leading stream axis; an ingest runs one device
    preprocess and one CLIP encode over every stream's images, then each
    stream's `star_stream_update` on views of the stack. Answers splice the
    stream's memory with `build_multimodal_embeds(streaming=True)` (the
    JAX engine's layout, not the session's bucketed one); `answer_all`
    left-pads every stream's prompt into one `generate_batch`. Draws come
    from `draws(step, stream, n)` (default `stream_draws`)."""

    def __init__(self, params: dict, cfg: VStreamLLaVAConfig, tokenizer,
                 n_streams: int, clip_size: int = 1, max_len: int = 4096,
                 draws=None):
        self._reset(n_streams, clip_size)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.metrics = MetricMeter()
        self.generator = Generator(Qwen2Decoder(cfg.llm, params["llm"]),
                                   max_len=max_len)
        self.device = self.generator.device
        self.draws = draws or stream_draws(self.device)
        self.states = _stack_state(init_star_state(
            cfg.star, cfg.projector.effective_input_dim, device=self.device),
            n_streams)

    def ingest(self, clips: Sequence[Sequence[np.ndarray]]):
        """One frame list per stream (ragged; padded, the padding masked)."""
        self._check_clips(clips)
        side = self.cfg.vit.image_size
        imgs, ns = [], []
        for frames in clips:
            x = (clip_resize_u8(frames, side) if len(frames)
                 else np.zeros((0, side, side, 3), np.uint8))
            n = x.shape[0]
            if n < self.clip_size:
                pad = np.zeros((self.clip_size - n, *x.shape[1:]), np.uint8)
                x = np.concatenate([x, pad]) if n else pad
            imgs.append(x)
            ns.append(n)
        t0 = time.perf_counter()
        u8 = torch.from_numpy(np.concatenate(imgs)).to(self.device)
        self._publish(self._ingest(u8, ns, self._step), ns)
        self.metrics.update("memory_latency_dispatch",
                            time.perf_counter() - t0)

    @torch.no_grad()
    def _ingest(self, frames_u8: torch.Tensor, ns: List[int], step: int):
        feats = encode_frames(self.params, self.cfg,
                              clip_device_preprocess(frames_u8))
        feats = feats.reshape(self.n_streams, self.clip_size,
                              *feats.shape[1:])
        snaps = []
        for s in range(self.n_streams):
            view = _stream_view(self.states, s, self._published[1][s])
            new = star_stream_update(self.params["ntm"], self.cfg.star, view,
                                     feats[s], ns[s],
                                     lambda n, s=s: self.draws(step, s, n))
            _write_back(self.states, s, new, skip=("bank", "bank_pos"))
            snaps.append(star_memory_tokens(self.cfg.star, new))
        return snaps

    @torch.no_grad()
    def prompt_embeds(self, stream_idx: int, question: str):
        """(embeds [1, S, D], positions [1, S]) of stream i's question over
        its published memory."""
        snaps, counts = self._snapshots()
        input_ids = llava_prompt(question, self.tokenizer)[1]
        return build_multimodal_embeds(self.params, self.cfg, input_ids,
                                       snaps[stream_idx], counts[stream_idx],
                                       streaming=True)

    def _text(self, ids, gen: GenerationConfig) -> str:
        return trim_stop_strings(
            self.tokenizer.decode(ids, skip_special_tokens=True),
            tuple(gen.stop_strings) or (conv_templates["vicuna_v1"].stop_str,))

    def answer(self, stream_idx: int, question: str,
               gen: Optional[GenerationConfig] = None) -> str:
        embeds, positions = self.prompt_embeds(stream_idx, question)
        gen = gen or default_gen(self.tokenizer)
        return self._text(self.generator.generate(embeds, positions, gen), gen)

    @torch.no_grad()
    def batch_inputs(self, questions: Sequence[str]):
        """(embeds [N, S, D], positions [N, S], segments [N, S], decode
        starts [N]): every stream's prompt left-padded to the longest."""
        self._per_stream(questions, "questions")
        parts = []
        for i, q in enumerate(questions):
            e, p = self.prompt_embeds(i, q)
            parts.append((e, p, np.zeros(e.shape[1], np.int32)))
        embeds, positions, segments, _ = _left_pad(parts, False)
        return embeds, positions, segments, [e.shape[1] for e, _, _ in parts]

    def answer_all(self, questions: Sequence[str],
                   gen: Optional[GenerationConfig] = None) -> List[str]:
        """Every stream's question through one batched prefill and decode
        loop."""
        embeds, positions, segments, starts = self.batch_inputs(questions)
        gen = gen or default_gen(self.tokenizer)
        outs = self.generator.generate_batch(embeds, positions, segments,
                                             gen, starts)
        return [self._text(o, gen) for o in outs]


class ThreadedIngestor:
    """Paced ingestion on a background thread (JAX streaming.py:972-1056):
    the reference's producer/consumer (cli_video_stream.py's frame
    simulator and memory manager) as one pacing thread, while answers run
    on the caller's thread against the latest published snapshot (one
    reference swap, as the sessions publish).

    After each clip the pacing thread records a CUDA event on its current
    stream; a watcher thread waits on the events in dispatch order and
    counts a missed deadline when a clip's work completes after its wall
    deadline (start + frames / fps). It never synchronizes the device, which
    would wait for the answers' work too. Both threads use the default
    stream, so an event also follows the answer work queued before it. On
    the CPU an ingest has completed when it returns."""

    def __init__(self, session, frame_iter, fps: float, clip_size: int):
        import queue
        import threading
        self.session = session
        self.frames = list(frame_iter)
        self.fps = fps
        self.clip_size = clip_size
        self.frames_ingested = 0
        self.missed_deadlines = 0
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._done = threading.Event()
        # (completion event or None, wall deadline) per clip, then None
        self._pending = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._watcher = threading.Thread(target=self._watch, daemon=True)

    def start(self) -> "ThreadedIngestor":
        self._thread.start()
        self._watcher.start()
        return self

    def _event(self):
        dev = self.session.device
        if dev.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def _run(self):
        start = time.perf_counter()
        last = None
        i = 0
        try:
            while i < len(self.frames) and not self._stop.is_set():
                clip = self.frames[i:i + self.clip_size]
                deadline = (start + (i + len(clip)) / self.fps
                            if self.fps > 0 else 0.0)
                self.session.ingest_frames(clip)
                i += len(clip)
                self.frames_ingested = i
                last = self._event()
                self._pending.put((last, deadline))
                now = time.perf_counter()
                if self.fps > 0 and deadline > now:
                    time.sleep(deadline - now)
            if last is not None:
                last.synchronize()
        except BaseException as e:          # noqa: BLE001 - kept for wait()
            self.error = e
            raise
        finally:
            self._pending.put(None)
            self._done.set()

    def _watch(self):
        """Wait on each clip's event in dispatch order (clip i's work is
        queued after clip i - 1's, so its completion implies theirs) and
        count a miss when it completed after the clip's deadline."""
        while True:
            item = self._pending.get()
            if item is None or self._stop.is_set():
                return
            ev, deadline = item
            if ev is not None:
                ev.synchronize()
            if self.fps > 0 and time.perf_counter() > deadline + 1e-3:
                self.missed_deadlines += 1

    def wait(self, timeout=None) -> bool:
        """Whether ingestion has ended (all frames, a stop or an error),
        waiting up to `timeout` seconds; joins both threads once it has."""
        done = self._done.wait(timeout)
        if done:
            self._thread.join()
            self._watcher.join()
        return done

    def stop(self):
        """Stop after the clip in flight and join both threads."""
        self._stop.set()
        self._pending.put(None)
        self._thread.join()
        self._watcher.join(timeout=10)
