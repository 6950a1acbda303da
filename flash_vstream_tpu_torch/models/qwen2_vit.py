"""Qwen2-VL vision transformer (Flash-VStream-Qwen generation).

Port of flash_vstream_tpu/models/qwen2_vit.py:38-107, 153-285: the
frame-batched dual-resolution encoder (`qwen_vit_blocks_frames`), its
frame-chunked form (`qwen_vit_encode_frames_chunked`) and the PatchMerger. Attention in Qwen2-VL is block-diagonal per temporal frame, so
each resolution stream runs as a batch of small full-attention problems
[frames, heads, tokens, head_dim] through the fused kernel K1, while the
projections and MLP run once over the concatenated token stream.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import VitConfig
from ..core.device import resolve_device

from ..kernels.flash_attention import flash_attention
from .layers import (
    ParamTree,
    apply_rope,
    dense,
    gelu_exact,
    gelu_mlp,
    init_dense,
    layer_norm,
    layer_slice,
    vision_rope_angles,
)


def init_qwen_vit_params(cfg: VitConfig, generator: torch.Generator,
                         device=None, dtype=torch.float32) -> dict:
    """Random parameters with the JAX init's tree, layouts and
    distributions, drawn from `generator` on `device` (default: the card)."""
    device = resolve_device(device)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    pd = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
    kw = dict(dtype=dtype, device=device)

    def stacked(din, dout):
        return init_dense(generator, din, dout, bias=True, layers=L, **kw)

    def ln(*shape):
        return {"scale": torch.ones(shape, **kw),
                "bias": torch.zeros(shape, **kw)}

    return {
        "patch_embed": {"w": torch.randn(pd, D, generator=generator,
                                         **kw).mul_(0.02)},
        "layers": {
            "ln1": ln(L, D), "ln2": ln(L, D),
            "attn": {"wq": stacked(D, D), "wk": stacked(D, D),
                     "wv": stacked(D, D), "wo": stacked(D, D)},
            "mlp": {"fc1": stacked(D, I), "fc2": stacked(I, D)},
        },
        "merger": {
            "ln_q": ln(D),
            "fc1": init_dense(generator, D * 4, D * 4, bias=True, **kw),
            "fc2": init_dense(generator, D * 4, cfg.merger_out_dim, bias=True,
                              **kw),
        },
    }


def grid_positions(grid_thw: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """Per-token (h, w) positions for concatenated grids in Qwen window
    layout ([t, h/2, w/2, 2, 2] token order). Returns [S, 2] int32."""
    out = []
    for t, h, w in grid_thw:
        hb, wb = h // 2, w // 2
        hh = np.arange(2)
        hpos = np.arange(hb)[:, None, None, None] * 2 + hh[None, None, :, None]
        wpos = np.arange(wb)[None, :, None, None] * 2 + hh[None, None, None, :]
        hpos = np.broadcast_to(hpos, (hb, wb, 2, 2))
        wpos = np.broadcast_to(wpos, (hb, wb, 2, 2))
        pos = np.stack([hpos.reshape(-1), wpos.reshape(-1)], axis=1)
        out.append(np.tile(pos, (t, 1)))
    return np.concatenate(out, axis=0).astype(np.int32)


def grid_segments(grid_thw: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """Segment ids, one per temporal frame pair. Returns [S] int32."""
    out, seg = [], 0
    for t, h, w in grid_thw:
        for _ in range(t):
            out.append(np.full(h * w, seg, np.int32))
            seg += 1
    return np.concatenate(out)


@functools.lru_cache(maxsize=16)
def _frame_rope(hw: Tuple[int, int], head_dim: int, device):
    """cos/sin [P, head_dim] of one frame's grid, made once per (grid,
    device): an encode then copies nothing from the host, so it can be
    captured in a CUDA graph. Callers only read the tables."""
    pos = torch.from_numpy(grid_positions([(1, *hw)])).to(device)
    return vision_rope_angles(pos[:, 0], pos[:, 1], head_dim)


def _attn_stream(lp: dict, cfg: VitConfig, h: torch.Tensor, rope):
    """h [T, P, D], frames as batch. The projections run over the flattened
    [T*P, D] token stream; attention runs per frame through K1 on strided
    [T, H, P, Dh] views (no copies)."""
    T, P, D = h.shape
    hf = h.reshape(T * P, D)
    a = lp["attn"]
    q, k, v = (dense(hf, a[n]["w"], a[n].get("b"))
               .reshape(T, P, cfg.num_heads, cfg.head_dim).transpose(1, 2)
               for n in ("wq", "wk", "wv"))
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)
    out = flash_attention(q, k, v)
    out = out.transpose(1, 2).reshape(T * P, D)
    return dense(out, a["wo"]["w"], a["wo"].get("b")).reshape(T, P, D)


def qwen_vit_blocks_frames(
    params: dict,
    cfg: VitConfig,
    patches: torch.Tensor,       # [S, pd], S = t_full*P_full + t_small*P_small
    *,
    t_full: int, hw_full: Tuple[int, int],
    t_small: int, hw_small: Tuple[int, int],
) -> torch.Tensor:
    """Frame-batched encoder for the uniform-grid dual-resolution case.
    Returns [S, D] in the patches' dtype."""
    D = cfg.hidden_size
    P_full = hw_full[0] * hw_full[1]
    P_small = hw_small[0] * hw_small[1]
    n_full = t_full * P_full
    x = dense(patches, params["patch_embed"]["w"])               # [S, D]
    rope_f = _frame_rope(tuple(hw_full), cfg.head_dim, x.device)
    rope_s = _frame_rope(tuple(hw_small), cfg.head_dim, x.device)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], 1e-6)
        a_full = _attn_stream(lp, cfg, h[:n_full].reshape(t_full, P_full, D),
                              rope_f)
        a_small = _attn_stream(lp, cfg,
                               h[n_full:].reshape(t_small, P_small, D), rope_s)
        x = x + torch.cat([a_full.reshape(-1, D), a_small.reshape(-1, D)])
        h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], 1e-6)
        x = x + gelu_mlp(lp["mlp"], h, cfg.hidden_act)
    return x


def qwen_vit_encode_frames_chunked(
    params: dict,
    cfg: VitConfig,
    full: torch.Tensor,          # [T, P_full, pd] raw window-layout patches
    small: torch.Tensor,         # [T, P_small, pd] pooled patches
    *,
    hw_full: Tuple[int, int], hw_small: Tuple[int, int],
    chunk: int,
    norm_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-chunked dual-resolution encode: (x [T, P_full, D],
    sx [T, P_small, D]). Attention is per frame, so frames are independent
    through the block stack and chunking over frames is exact; only one
    chunk's activations live at a time. `norm_fn` (uint8 patches) applies
    per chunk. The JAX `remat` flag has no counterpart: the port runs the
    ViT without a graph (nothing before the merger is differentiated)."""
    T, P_full, pd = full.shape
    P_small = small.shape[1]
    if T % chunk:
        raise ValueError(f"frame count {T} not divisible by chunk {chunk}")
    D = cfg.hidden_size
    xs, sxs = [], []
    for c0 in range(0, T, chunk):
        f, s = full[c0:c0 + chunk], small[c0:c0 + chunk]
        if norm_fn is not None:
            f, s = norm_fn(f), norm_fn(s)
        allp = torch.cat([f.reshape(chunk * P_full, pd),
                          s.reshape(chunk * P_small, pd)])
        hidden = qwen_vit_blocks_frames(
            params, cfg, allp, t_full=chunk, hw_full=hw_full,
            t_small=chunk, hw_small=hw_small)
        n_full = chunk * P_full
        xs.append(hidden[:n_full].reshape(chunk, P_full, D))
        sxs.append(hidden[n_full:].reshape(chunk, P_small, D))
    return torch.cat(xs), torch.cat(sxs)


def patch_merger(params: dict, x: torch.Tensor) -> torch.Tensor:
    """HF PatchMerger over the ViT tree's "merger": LN, merge 2x2 window
    tokens, 2-layer exact-GELU MLP. x [S, D] (S a multiple of 4) ->
    [S/4, out_dim]. f32 input is cast to the weight dtype first (bf16 under
    LoRA views), as in JAX."""
    m = params["merger"]
    h = layer_norm(x, m["ln_q"]["scale"], m["ln_q"]["bias"], 1e-6)
    if h.dtype == torch.float32:
        # a LoRA view has no dtype: bf16, as in JAX
        h = h.to(getattr(m["fc1"]["w"], "dtype", torch.bfloat16))
    h = h.reshape(-1, h.shape[-1] * 4)
    h = gelu_exact(dense(h, m["fc1"]["w"], m["fc1"]["b"]))
    return dense(h, m["fc2"]["w"], m["fc2"]["b"])


class PatchMerger(ParamTree):
    """The merger's parameters ("ln_q", "fc1", "fc2") as a module."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_merger({"merger": self.tree()}, x)


class QwenVisionTransformer(ParamTree):
    """The Qwen2-VL ViT's parameter tree ("patch_embed", "layers", "merger")
    as a module; `forward` is the frame-batched dual-resolution encoder."""

    def __init__(self, cfg: VitConfig, params: dict):
        params = dict(params)
        params["merger"] = PatchMerger(params["merger"])
        super().__init__(params)
        self.cfg = cfg

    def forward(self, patches: torch.Tensor, *, t_full: int,
                hw_full: Tuple[int, int], t_small: int,
                hw_small: Tuple[int, int]) -> torch.Tensor:
        return qwen_vit_blocks_frames(
            self.tree(), self.cfg, patches, t_full=t_full, hw_full=hw_full,
            t_small=t_small, hw_small=hw_small)
