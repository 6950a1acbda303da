"""Qwen prompt construction: ChatML with each video or image pad block
expanded to its token count.

Port of flash_vstream_tpu/preprocess/qwen_processor.py: the special-token
constants and pad ids, `build_mm_prompt` for any sequence of offline
videos (their count from the grid math), still images and streaming video
blocks (their count given), `build_video_prompt` and
`visual_position_ids`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.config import VStreamQwenConfig
from ..models.vstream_qwen import image_token_count, visual_token_count
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


def _image_pad_id(tokenizer, cfg: VStreamQwenConfig) -> int:
    if isinstance(tokenizer, ByteTokenizer):
        return tokenizer.special_id(IMAGE_PAD)
    return cfg.image_token_id


def build_video_prompt(
    cfg: VStreamQwenConfig,
    tokenizer,
    question: str,
    grid: Optional[Tuple[int, int, int]] = None,
    n_video_tokens: Optional[int] = None,
    system: str = "You are a helpful assistant.",
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """ChatML ids with one video block: `grid` (offline: (t, h, w), the
    token count from the grid math) or `n_video_tokens` (streaming: the
    memory's count). Returns (input_ids [S], (video_start, n_visual))."""
    media = ([("video_tokens", n_video_tokens)] if n_video_tokens is not None
             else [("video", grid)])
    input_ids, spans = build_mm_prompt(cfg, tokenizer, question, media,
                                       system=system)
    start, n, _ = spans[0]
    return input_ids, (start, n)


def build_mm_prompt(
    cfg: VStreamQwenConfig,
    tokenizer,
    question: str,
    media: list,   # ordered [("video", (t, h, w)) | ("image", (h, w)) |
                   #          ("video_tokens", n)]
    system: str = "You are a helpful assistant.",
) -> Tuple[np.ndarray, list]:
    """ChatML ids with every media block expanded, in order: a video to
    its (dam + csm) tokens from the grid math, an image to h*w//4 tokens
    (its full patch grid merged 2x2), "video_tokens" to the given count.
    Returns (input_ids [S], spans=[(start, n_tokens, kind), ...])."""
    counts, kinds = [], []
    for kind, g in media:
        if kind == "video":
            dam, csm = visual_token_count(cfg, *g)
            counts.append(dam + csm)
            kinds.append("video")
        elif kind == "video_tokens":
            counts.append(int(g))
            kinds.append("video")
        elif kind == "image":
            counts.append(image_token_count(*g))
            kinds.append("image")
        else:
            raise ValueError(f"unknown media kind {kind!r}")

    conv = conv_chatml.copy()
    conv.system = system
    blocks = "".join(
        f"{VISION_START}{VIDEO_PAD if k == 'video' else IMAGE_PAD}"
        f"{VISION_END}" for k in kinds)
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
    for kind, cnt in zip(kinds, counts):
        pad_tok = VIDEO_PAD if kind == "video" else IMAGE_PAD
        pad_id = (_video_pad_id(tokenizer, cfg) if kind == "video"
                  else _image_pad_id(tokenizer, cfg))
        pre, rest = rest.split(pad_tok, 1)
        ids.extend(enc(pre))
        spans.append((len(ids), cnt, kind))
        ids.extend([pad_id] * cnt)
    ids.extend(enc(rest))
    return np.asarray(ids, np.int64), spans


def visual_position_ids(input_ids: np.ndarray, video_span: Tuple[int, int]
                        ) -> np.ndarray:
    """0..n-1 at the video block's positions, -1 elsewhere."""
    start, n = video_span
    out = np.full(len(input_ids), -1, np.int64)
    out[start:start + n] = np.arange(n)
    return out
