"""Qwen prompt construction: ChatML with the video-pad block expanded to the
memory's token count.

Port of flash_vstream_tpu/preprocess/qwen_processor.py:31-131 for the
streaming case, where the caller gives the visual token count, plus the
special-token constants and pad ids the training preprocessing uses.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.config import VStreamQwenConfig
from .prompts import conv_chatml
from .tokenizer import ByteTokenizer

VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
VIDEO_PAD = "<|video_pad|>"
IMAGE_PAD = "<|image_pad|>"
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"

QWEN_SPECIALS = (IM_START, IM_END, VISION_START, VISION_END, VIDEO_PAD,
                 IMAGE_PAD)


def make_byte_qwen_tokenizer() -> ByteTokenizer:
    return ByteTokenizer(specials=QWEN_SPECIALS)


def _video_pad_id(tokenizer, cfg: VStreamQwenConfig) -> int:
    if isinstance(tokenizer, ByteTokenizer):
        return tokenizer.special_id(VIDEO_PAD)
    return cfg.video_token_id


def build_mm_prompt(
    cfg: VStreamQwenConfig,
    tokenizer,
    question: str,
    media: list,   # ordered [("video_tokens", n), ...]
    system: str = "You are a helpful assistant.",
) -> Tuple[np.ndarray, list]:
    """ChatML ids with every video block expanded to its token count.
    Returns (input_ids [S], spans=[(start, n_tokens, "video"), ...]). Only
    the streaming "video_tokens" media kind is ported."""
    counts = []
    for kind, n in media:
        if kind != "video_tokens":
            raise NotImplementedError(
                f"media kind {kind!r} (offline video, images) is not ported "
                f"yet: ROADMAP A9")
        counts.append(int(n))

    conv = conv_chatml.copy()
    conv.system = system
    blocks = "".join(f"{VISION_START}{VIDEO_PAD}{VISION_END}" for _ in counts)
    conv.append_message(conv.roles[0], blocks + question)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    if isinstance(tokenizer, ByteTokenizer):
        def enc(t):
            return tokenizer.encode(t, add_bos=False)
    else:
        def enc(t):
            return tokenizer.encode(t, add_special_tokens=False)

    ids: list = []
    spans = []
    rest = prompt
    pad_id = _video_pad_id(tokenizer, cfg)
    for cnt in counts:
        pre, rest = rest.split(VIDEO_PAD, 1)
        ids.extend(enc(pre))
        spans.append((len(ids), cnt, "video"))
        ids.extend([pad_id] * cnt)
    ids.extend(enc(rest))
    return np.asarray(ids, np.int64), spans


def build_video_prompt(
    cfg: VStreamQwenConfig,
    tokenizer,
    question: str,
    n_video_tokens: int,
    system: str = "You are a helpful assistant.",
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """ChatML ids with one video block of `n_video_tokens` pads. Returns
    (input_ids [S], (video_start, n_visual))."""
    input_ids, spans = build_mm_prompt(
        cfg, tokenizer, question, [("video_tokens", n_video_tokens)],
        system=system)
    start, n, _ = spans[0]
    return input_ids, (start, n)
