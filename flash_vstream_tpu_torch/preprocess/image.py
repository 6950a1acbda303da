"""Frame preprocessing of both families: the host half (numpy) and the
device half.

The host half is a copy of flash_vstream_tpu/preprocess/image.py's
`_to_float_chw`, `_resize_bilinear`, `expand2square`, `clip_preprocess`,
`clip_resize_u8`, `to_uint8_hwc`, `qwen_resize_u8`, `frame_hw`,
`smart_resize`, `qwen_patchify`, `qwen_patchify_u8`, `qwen_patch_norm` and
`qwen_preprocess` (numpy arithmetic, so the two packages agree bit for
bit). Where a frame must be resized, JAX calls PIL's bicubic resize;
here `resize_u8` runs the same resampling in numpy, so the port needs no
PIL: PIL's separable bicubic filter (a = -0.5, support widened by the
downscale factor), its 22-bit fixed-point weights and its uint8 rounding
after each pass, which tests/test_torch_llava.py holds equal to PIL bit
for bit. The device half is the port of `clip_device_preprocess` (:135)
and `qwen_device_preprocess` (:223).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


_PRECISION_BITS = 22             # PIL's fixed point for 8-bit resampling


def _bicubic(x: float) -> float:
    """PIL's bicubic kernel, a = -0.5."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=64)
def _resample_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for one axis: the
    first input index of each output ([out]) and the fixed-point weights
    ([out, ksize], zero past each output's window). Cached by the two
    sizes (a stream resizes every frame alike), so read-only."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    ss = 1.0 / filterscale
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss)
             for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            f = v * (1 << _PRECISION_BITS)
            kk[xx, x] = int(f - 0.5) if v < 0 else int(f + 0.5)
        first[xx] = xmin
    first.flags.writeable = False
    kk.flags.writeable = False
    return first, kk


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL resampling pass of uint8 `a` along `axis` (0: rows, 1:
    columns of an HWC image), rounded and clipped to uint8."""
    in_size = a.shape[axis]
    first, kk = _resample_coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)
    x = np.moveaxis(a, axis, 0).astype(np.int64)         # [in, ...]
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for j in range(kk.shape[1]):
        w = kk[:, j].reshape((-1,) + (1,) * (x.ndim - 1))
        acc += x[idx[:, j]] * w
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC image resized to (h, w) by PIL's bicubic resampling in
    numpy: the width first, then the height, each pass only when its size
    changes, as PIL's ImagingResample."""
    h, w = hw
    out = img
    if out.shape[1] != w:
        out = _resample_axis(out, w, 1)
    if out.shape[0] != h:
        out = _resample_axis(out, h, 0)
    return out


def _to_float_chw(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 CHW in [0, 1]."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[-1] in (1, 3):
        img = img.transpose(2, 0, 1)
    return img.astype(np.float32)


def _resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize a CHW float image to (H, W) through uint8, bicubic, as JAX
    does with PIL (`resize_u8`)."""
    hwc = np.clip(img * 255.0, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    out = resize_u8(np.ascontiguousarray(hwc), size)
    return out.astype(np.float32).transpose(2, 0, 1) / 255.0


def expand2square(img: np.ndarray, fill: Sequence[float]) -> np.ndarray:
    """A CHW image padded to a square with the per-channel `fill`, centred
    (mm_utils.py:16-28)."""
    c, h, w = img.shape
    if h == w:
        return img
    s = max(h, w)
    out = np.empty((c, s, s), img.dtype)
    out[:] = np.asarray(fill, img.dtype)[:, None, None]
    top, left = (s - h) // 2, (s - w) // 2
    out[:, top:top + h, left:left + w] = img
    return out


def clip_preprocess(frames: Sequence[np.ndarray], image_size: int = 336,
                    pad_to_square: bool = True) -> np.ndarray:
    """Frames (uint8 HWC or float CHW) -> [T, 3, S, S] f32, padded to a
    square with the CLIP mean, resized and normalized."""
    out = []
    for f in frames:
        img = _to_float_chw(f)
        if pad_to_square:
            img = expand2square(img, OPENAI_CLIP_MEAN)
        img = _resize_bilinear(img, (image_size, image_size))
        img = ((img - OPENAI_CLIP_MEAN[:, None, None])
               / OPENAI_CLIP_STD[:, None, None])
        out.append(img)
    return np.stack(out)


def clip_resize_u8(frames: Sequence[np.ndarray], image_size: int = 336,
                   pad_to_square: bool = True) -> np.ndarray:
    """Host half of the CLIP pipeline: pad to a square with the CLIP mean
    colour (centred) and resize, kept uint8 HWC ([T, S, S, 3]); the
    normalization runs on the device (`clip_device_preprocess`), a quarter
    of the f32 transfer."""
    out = []
    fill = np.array([int(round(c * 255)) for c in OPENAI_CLIP_MEAN],
                    np.uint8)
    for f in frames:
        f = np.asarray(f)
        if f.dtype != np.uint8:
            if f.ndim == 3 and f.shape[0] in (1, 3):
                f = f.transpose(1, 2, 0)
            f = np.clip(f * 255.0, 0, 255).astype(np.uint8)
        h, w = f.shape[:2]
        if pad_to_square and h != w:
            s = max(h, w)
            bg = np.empty((s, s, 3), np.uint8)
            bg[:] = fill
            top, left = (s - h) // 2, (s - w) // 2
            bg[top:top + h, left:left + w] = f
            f = bg
        out.append(resize_u8(np.ascontiguousarray(f),
                             (image_size, image_size)))
    return np.stack(out)


def clip_device_preprocess(frames_u8: torch.Tensor) -> torch.Tensor:
    """Device half of the CLIP pipeline: uint8 [T, S, S, 3] -> normalized
    f32 [T, 3, S, S], in JAX's order of operations (divide by 255, less
    the mean, over the std)."""
    dev = frames_u8.device
    x = frames_u8.float() / 255.0
    x = ((x - torch.from_numpy(OPENAI_CLIP_MEAN).to(dev))
         / torch.from_numpy(OPENAI_CLIP_STD).to(dev))
    return x.permute(0, 3, 1, 2)


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
        out.append(resize_u8(to_uint8_hwc(f), (nh, nw)))
    if pad_to_even and len(out) % 2:
        out.append(out[-1])
    return np.stack(out)


def frame_hw(frame: np.ndarray) -> Tuple[int, int]:
    """(H, W) of a frame in any supported layout (HWC, or CHW)."""
    f = np.asarray(frame)
    if f.ndim == 3 and f.shape[0] in (1, 3) and f.shape[-1] not in (1, 3):
        return f.shape[1], f.shape[2]
    return f.shape[0], f.shape[1]


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
        if img.shape[1:] != (nh, nw):    # skip no-op resizes
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
