"""Pooling of patch tokens: the STAR memory's spatial pools and 2x2 merge,
and the low-resolution pathway of the dual-resolution Qwen ViT.

Port of flash_vstream_tpu/ops/pooling.py: `spatial_pool` (:22),
`merge_2x2_tokens` (:37) and `qwen_temporal_pool` (:51-108).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def spatial_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Average-pool patch tokens x [..., P, D] (P = p*p, a square grid) to
    out_size**2 tokens (compress_spatial_features, vstream_arch.py:193-212).
    The mean runs in x's dtype, as jnp.mean does."""
    *lead, P, D = x.shape
    p = math.isqrt(P)
    if p * p != P:
        raise ValueError(f"patch grid must be square, got P={P}")
    if p == out_size:
        return x
    if out_size == 1:
        return x.mean(dim=-2, keepdim=True)
    if p % out_size:
        raise ValueError(f"grid side {p} is no multiple of {out_size}")
    r = p // out_size
    x = x.reshape(*lead, out_size, r, out_size, r, D)
    return x.mean(dim=(-4, -2)).reshape(*lead, out_size * out_size, D)


def merge_2x2_tokens(x: torch.Tensor) -> torch.Tensor:
    """Concatenate 2x2 neighbour patches channelwise: [..., P, D] ->
    [..., P/4, 4D], channels in the order (r0c0, r0c1, r1c0, r1c1) of
    reshape_2x2_image_features (vstream_arch.py:163-172)."""
    *lead, P, D = x.shape
    p = math.isqrt(P)
    if p * p != P or p % 2:
        raise ValueError(f"merge_2x2_tokens needs an even square grid, "
                         f"got P={P}")
    x = x.reshape(*lead, p // 2, 2, p // 2, 2, D).transpose(-4, -3)
    return x.reshape(*lead, (p // 2) ** 2, 4 * D)


@lru_cache(maxsize=None)
def _pool_matrix(ps: int) -> np.ndarray:
    """[4, ps*ps, ps*ps] map from a 2x2 patch window's pixels to the pooled
    patch: output pixel (p, q) averages block pixels (2p+dy, 2q+dx); block
    pixel (P, Q) lives in source patch (P//ps, Q//ps) at (P%ps, Q%ps).
    Read-only: callers copy it to a tensor."""
    M = np.zeros((4, ps * ps, ps * ps), np.float32)
    for p in range(ps):
        for q in range(ps):
            o = p * ps + q
            for dy in (0, 1):
                for dx in (0, 1):
                    P, Q = 2 * p + dy, 2 * q + dx
                    a, b = P // ps, Q // ps
                    s = (P % ps) * ps + (Q % ps)
                    M[a * 2 + b, s, o] += 0.25
    M.setflags(write=False)
    return M


def qwen_temporal_pool(x: torch.Tensor, grid_thw: Tuple[int, int, int],
                       patch_size: int = 14, temporal_patch_size: int = 2,
                       channels: int = 3
                       ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """x: [t*h*w, C*tp*ps*ps] patchified pixels in Qwen window layout ->
    (the 2x-downsampled patch stream [t*(h/2)*(w/2), C*tp*ps*ps], its grid
    (t, h/2, w/2)). The pooled patch is a fixed linear map of its window's
    four source patches, applied per (channel, temporal) plane as one f32
    product."""
    t, h, w = grid_thw
    ps, tp, C = patch_size, temporal_patch_size, channels
    xdim = C * tp * ps * ps
    if x.shape[-1] != xdim:
        raise ValueError(f"patch rows have {x.shape[-1]} features, want {xdim}")
    if h % 4 or w % 4:
        raise ValueError(f"grid h, w must be multiples of 4, got {(h, w)}")
    M = torch.from_numpy(_pool_matrix(ps).copy()).to(x.device)
    n = t * (h // 2) * (w // 2)
    blocks = x.reshape(n, 4, C * tp, ps * ps).float()
    pooled = torch.einsum("nacp,apq->ncq", blocks, M).to(x.dtype)
    # pooled grid (h/2, w/2) in row-major order == window order; re-window
    # the pooled grid into 2x2 groups for the output layout
    nh, nw = h // 4, w // 4
    pooled = pooled.reshape(t, nh, 2, nw, 2, xdim).permute(0, 1, 3, 2, 4, 5)
    return pooled.reshape(t * nh * nw * 4, xdim), (t, h // 2, w // 2)
