"""Qwen frame preprocessing: the host half (numpy/PIL) and the device half.

The host half is a copy of flash_vstream_tpu/preprocess/image.py's
`_to_float_chw`, `_resize_bilinear`, `to_uint8_hwc`, `qwen_resize_u8`,
`smart_resize`, `qwen_patchify`, `qwen_patchify_u8`, `qwen_patch_norm` and
`qwen_preprocess` (numpy arithmetic, so the two packages agree bit for
bit); PIL loads only where a frame needs resizing. The device half is the
port of `qwen_device_preprocess` (:223).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _to_float_chw(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 CHW in [0, 1]."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[-1] in (1, 3):
        img = img.transpose(2, 0, 1)
    return img.astype(np.float32)


def _resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize a CHW float image to (H, W) via PIL (bicubic, as in JAX)."""
    from PIL import Image
    h, w = size
    chw = np.clip(img * 255.0, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    pil = Image.fromarray(chw).resize((w, h), Image.BICUBIC)
    return np.asarray(pil).astype(np.float32).transpose(2, 0, 1) / 255.0


def to_uint8_hwc(frame: np.ndarray) -> np.ndarray:
    """Normalize any supported frame layout (uint8 HWC, float HWC/CHW in
    [0,1]) to uint8 HWC."""
    f = np.asarray(frame)
    if f.dtype == np.uint8:
        return f
    if f.ndim == 3 and f.shape[0] in (1, 3) and f.shape[-1] not in (1, 3):
        f = f.transpose(1, 2, 0)
    return np.clip(f * 255.0, 0, 255).astype(np.uint8)


def qwen_resize_u8(frames: Sequence[np.ndarray], hw,
                   pad_to_even: bool = True) -> np.ndarray:
    """Host half of the Qwen streaming pipeline: any frame layout -> uint8
    HWC at the smart-resize target; optionally pads to an even count
    (temporal pairs). Device half: qwen_device_preprocess."""
    nh, nw = hw
    out = []
    for f in frames:
        f = to_uint8_hwc(f)
        if f.shape[:2] != (nh, nw):
            from PIL import Image
            f = np.asarray(Image.fromarray(f).resize((nw, nh), Image.BICUBIC))
        out.append(f)
    if pad_to_even and len(out) % 2:
        out.append(out[-1])
    return np.stack(out)


def smart_resize(height: int, width: int, factor: int = 56,
                 min_pixels: int = 56 * 56 * 4,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """Qwen smart resize: round to factor, clamp total pixels
    (vision_process.py:44-70)."""
    if height < factor or width < factor:
        scale = factor / min(height, width)
        height, width = math.ceil(height * scale), math.ceil(width * scale)
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return max(h_bar, factor), max(w_bar, factor)


def qwen_patchify(frames: np.ndarray, patch_size: int = 14,
                  temporal_patch_size: int = 2, merge_size: int = 2
                  ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Normalized frames [T, 3, H, W] -> (patch rows [t*h*w, C*tp*ps*ps],
    grid (t, h, w)) in Qwen window layout [t, h/2, w/2, 2, 2]; T is padded to
    a multiple of temporal_patch_size by repeating the last frame."""
    T, C, H, W = frames.shape
    tp, ps, m = temporal_patch_size, patch_size, merge_size
    if T % tp:
        frames = np.concatenate([frames, frames[-1:].repeat(tp - T % tp, 0)])
        T = frames.shape[0]
    t, h, w = T // tp, H // ps, W // ps
    x = frames.reshape(t, tp, C, h // m, m, ps, w // m, m, ps)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)   # [t, hb, wb, hh, ww, C, tp, ps, ps]
    return x.reshape(t * h * w, C * tp * ps * ps), (t, h, w)


def qwen_patchify_u8(frames_u8: np.ndarray, patch_size: int = 14,
                     temporal_patch_size: int = 2, merge_size: int = 2
                     ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """uint8 frames [T, H, W, 3] -> unnormalized uint8 patch rows in the
    layout of qwen_patchify (an index permutation, so it commutes with
    qwen_patch_norm's affine)."""
    T, H, W, C = frames_u8.shape
    tp, ps, m = temporal_patch_size, patch_size, merge_size
    x = frames_u8.transpose(0, 3, 1, 2)               # [T, C, H, W]
    if T % tp:
        x = np.concatenate([x, x[-1:].repeat(tp - T % tp, 0)])
        T = x.shape[0]
    t, h, w = T // tp, H // ps, W // ps
    x = x.reshape(t, tp, C, h // m, m, ps, w // m, m, ps)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(t * h * w, C * tp * ps * ps), (t, h, w)


def qwen_patch_norm(patch_size: int = 14, temporal_patch_size: int = 2,
                    channels: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """(scale_pd, shift_pd) f32 vectors over the patch feature dim such that
    normalized = u8 * scale + shift reproduces ((u8/255) - mean) / std."""
    rep = temporal_patch_size * patch_size * patch_size
    scale = np.repeat(1.0 / (255.0 * OPENAI_CLIP_STD), rep)
    shift = np.repeat(-OPENAI_CLIP_MEAN / OPENAI_CLIP_STD, rep)
    return scale.astype(np.float32), shift.astype(np.float32)


def qwen_preprocess(frames: Sequence[np.ndarray],
                    max_pixels: int = 4 * 224 * 224,
                    factor: int = 56) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Raw frames -> (f32 patch rows, grid): factor-56 smart resize,
    CLIP-normalize, patchify."""
    first = _to_float_chw(frames[0])
    _, H, W = first.shape
    nh, nw = smart_resize(H, W, factor=factor, max_pixels=max_pixels)
    out = []
    for f in frames:
        img = _to_float_chw(f)
        if img.shape[1:] != (nh, nw):    # skip no-op PIL round trips
            img = _resize_bilinear(img, (nh, nw))
        img = (img - OPENAI_CLIP_MEAN[:, None, None]) / OPENAI_CLIP_STD[:, None, None]
        out.append(img)
    return qwen_patchify(np.stack(out))


def qwen_device_preprocess(frames_u8: torch.Tensor, patch_size: int = 14,
                           temporal_patch_size: int = 2, merge_size: int = 2,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 frames [T, H, W, 3] on the device -> normalized patch rows
    [t*h*w, C*tp*ps*ps] in Qwen window layout. The window patchify runs on
    the raw values (exact in bf16) and the CLIP affine applies last, per
    patch feature, in f32. T must be a multiple of temporal_patch_size; H, W
    multiples of patch_size * merge_size."""
    T, H, W, C = frames_u8.shape
    tp, ps, m = temporal_patch_size, patch_size, merge_size
    x = frames_u8.to(torch.bfloat16).permute(0, 3, 1, 2)       # [T, C, H, W]
    t, h, w = T // tp, H // ps, W // ps
    x = x.reshape(t, tp, C, h // m, m, ps, w // m, m, ps)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    x = x.reshape(t * h * w, C * tp * ps * ps)
    scale, shift = qwen_patch_norm(ps, tp, C)
    scale = torch.from_numpy(scale).to(x.device)
    shift = torch.from_numpy(shift).to(x.device)
    return (x.float() * scale + shift).to(dtype)
