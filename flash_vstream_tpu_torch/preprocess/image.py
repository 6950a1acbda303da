"""Device half of the Qwen frame preprocessing.

Port of `qwen_device_preprocess` (flash_vstream_tpu/preprocess/image.py:223).
The host half (`smart_resize`, `qwen_resize_u8`, `qwen_patch_norm`) holds no
JAX code and is imported from the JAX package.
"""
from __future__ import annotations

import torch

from flash_vstream_tpu.preprocess.image import (  # noqa: F401  (re-exported)
    qwen_patch_norm,
    qwen_resize_u8,
    smart_resize,
)


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
