"""Flash-VStream-Qwen composition: Qwen2-VL ViT + Flash memory + Qwen2
decoder.

Port of flash_vstream_tpu/models/vstream_qwen.py:33-321: the parameter
init, the token counts and 3D rope index of video and image grids, the
offline video encode (`encode_video`: dual-resolution ViT, Flash memory
consolidation, PatchMerger), the still-image encode (`encode_image`: the
varlen ViT over the full patch grid, no Flash memory), the splice of their
embeddings into the prompt and the 3D rope positions around it, and
`qwen_forward_train`. `VStreamQwen` holds both halves as modules whose
`state_dict()` keys are the JAX tree's key paths.

The ViT and the consolidation run without a graph: nothing before the
PatchMerger is trained (LoRA adapts the merger and the decoder), so
gradients equal JAX's, where nothing before the merger is differentiated
either.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import VStreamQwenConfig
from ..core.device import resolve_device

from ..ops.pooling import qwen_temporal_pool
from .flash_memory import am_rope_visual_positions, cat_spa_tem, flash_consolidate
from .llm import Qwen2Decoder, decoder_forward, embed_tokens, init_llm_params, lm_head
from .qwen2_vit import (
    QwenVisionTransformer,
    grid_positions,
    grid_segments,
    init_qwen_vit_params,
    patch_merger,
    qwen_vit_blocks,
    qwen_vit_blocks_frames,
    qwen_vit_encode_frames_chunked,
)


def init_qwen_params(cfg: VStreamQwenConfig, generator: torch.Generator,
                     device=None, dtype=torch.float32) -> dict:
    """Random {"vit", "llm"} parameters with the JAX init's tree and
    distributions, drawn on `device` (default: the card) from `generator`
    (which must live on that device)."""
    device = resolve_device(device)
    return {
        "vit": init_qwen_vit_params(cfg.vit, generator, device, dtype),
        "llm": init_llm_params(cfg.llm, generator, device, dtype),
    }


class VStreamQwen(torch.nn.Module):
    def __init__(self, cfg: VStreamQwenConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.vit = QwenVisionTransformer(cfg.vit, params["vit"])
        self.llm = Qwen2Decoder(cfg.llm, params["llm"])


def csm_grid(cfg: VStreamQwenConfig, t: int, h: int, w: int
             ) -> Tuple[int, int, int]:
    nh, nw = h // 2, w // 2
    nh += nh % 2
    nw += nw % 2
    return (min(t, cfg.flash_memory.csm_grid_len), nh, nw)


def dam_grid(cfg: VStreamQwenConfig, t: int, h: int, w: int
             ) -> Tuple[int, int, int]:
    return (min(t, cfg.flash_memory.dam_grid_len), h, w)


def visual_token_count(cfg: VStreamQwenConfig, t: int, h: int, w: int
                       ) -> Tuple[int, int]:
    """(dam_tokens, csm_tokens) in LLM space (grid.prod() // 4 each)."""
    dt, dh, dw = dam_grid(cfg, t, h, w)
    ct, ch, cw = csm_grid(cfg, t, h, w)
    return dt * dh * dw // 4, ct * ch * cw // 4


def image_token_count(h: int, w: int) -> int:
    """LLM tokens of one still image: its full patch grid merged 2x2
    (images bypass Flash memory)."""
    return h * w // 4


def mm_grid_index(t: int, h: int, w: int) -> np.ndarray:
    """Standard Qwen2-VL 3D rope index over an LLM-space grid: (t, h//2,
    w//2) enumerated row-major. Returns [3, t*h*w//4] int64."""
    gh, gw = h // 2, w // 2
    t_idx = np.repeat(np.arange(t), gh * gw)
    h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
    w_idx = np.tile(np.arange(gw), t * gh)
    return np.stack([t_idx, h_idx, w_idx]).astype(np.int64)


def _vit_input(patches: torch.Tensor, wdtype) -> torch.Tensor:
    """Patches as the ViT takes them: bf16 patches stay bf16 (the ViT then
    computes in bf16 whatever its weights' dtype, as JAX's `dense` does);
    others take the weights' dtype (HF casts pixel values to the visual
    dtype, and the card's kernels take bf16 only)."""
    return patches if patches.dtype == torch.bfloat16 else patches.to(wdtype)


# ---------------------------------------------------------------------------
# Visual encoder pipeline (offline, training)
# ---------------------------------------------------------------------------

class QwenVisualOutput(NamedTuple):
    video_embeds: torch.Tensor       # [n_visual, llm_hidden]
    visual_positions: torch.Tensor   # [3, n_visual] AM-RoPE block positions


def encode_video(
    params: dict,
    cfg: VStreamQwenConfig,
    patches: torch.Tensor,       # [t*h*w, pd] patchified pixels
    grid: Tuple[int, int, int],  # (t, h, w)
    *,
    draws=None,                  # n -> [n] uniforms (k-means, coins)
    vit_chunk: int = 0,
    patch_norm=None,             # (scale_pd, shift_pd) for uint8 patches
) -> QwenVisualOutput:
    """Dual-resolution ViT encode + Flash memory + merger for one video.

    The pooled low-res stream is taken from the same patches (in f32 for
    uint8 input: averaging raw 0-255 values in bf16 loses mantissa bits);
    both streams enter the ViT in its weights' dtype (HF casts pixel values
    to the visual dtype; for an f32 model this is the identity); with
    `vit_chunk` the frames encode in chunks of the largest divisor of t not
    above it (exact). The ViT and the consolidation run under no_grad; the
    merger runs with the caller's grad mode."""
    t, h, w = grid
    D = cfg.vit.hidden_size
    vit = params["vit"]
    wdtype = getattr(vit["patch_embed"]["w"], "dtype", torch.bfloat16)
    with torch.no_grad():
        norm_fn = None
        if patch_norm is not None:
            scale_pd = torch.as_tensor(np.asarray(patch_norm[0]),
                                       dtype=torch.float32,
                                       device=patches.device)
            shift_pd = torch.as_tensor(np.asarray(patch_norm[1]),
                                       dtype=torch.float32,
                                       device=patches.device)

            def norm_fn(p):
                return (p.float() * scale_pd + shift_pd).to(torch.bfloat16)
        pool_in = patches.float() if patches.dtype == torch.uint8 else patches
        small, small_grid = qwen_temporal_pool(
            pool_in, grid, cfg.vit.patch_size, cfg.vit.temporal_patch_size,
            cfg.vit.in_channels)
        if norm_fn is None:
            patches = _vit_input(patches, wdtype)
            small = _vit_input(small, wdtype)
        chunk = min(vit_chunk, t) if vit_chunk else 0
        while chunk > 1 and t % chunk:   # largest divisor of t <= vit_chunk
            chunk -= 1
        P_small = small_grid[1] * small_grid[2]
        pd = patches.shape[-1]
        if 1 < chunk < t:
            x, sx = qwen_vit_encode_frames_chunked(
                vit, cfg.vit, patches.reshape(t, h * w, pd),
                small.reshape(t, P_small, pd), hw_full=(h, w),
                hw_small=(small_grid[1], small_grid[2]), chunk=chunk,
                norm_fn=norm_fn)
        else:
            if norm_fn is not None:
                patches, small = norm_fn(patches), norm_fn(small)
            hidden = qwen_vit_blocks_frames(
                vit, cfg.vit, torch.cat([patches, small]), t_full=t,
                hw_full=(h, w), t_small=small_grid[0],
                hw_small=(small_grid[1], small_grid[2]))
            x = hidden[:t * h * w].reshape(t, h * w, D)
            sx = hidden[t * h * w:].reshape(t, P_small, D)
        fm = flash_consolidate(cfg.flash_memory, x, sx, draws=draws)
        merged_in = cat_spa_tem(fm.spa_x, fm.tem_x)            # [N_tok, D]
        vis_pos = am_rope_visual_positions(
            fm.spa_positions, fm.tem_positions, (h, w),
            (small_grid[1], small_grid[2]))
    video_embeds = patch_merger(vit, merged_in)                # [N/4, llm]
    return QwenVisualOutput(video_embeds, vis_pos)


def encode_image(params: dict, cfg: VStreamQwenConfig, patches: torch.Tensor,
                 grid_hw: Tuple[int, int], patch_norm=None
                 ) -> QwenVisualOutput:
    """Still-image encode: the varlen ViT over the (1, h, w) grid as one
    segment, then the PatchMerger; no Flash memory (nothing temporal to
    consolidate) and the standard mm rope index. patches [h*w, pd] (the
    single frame duplicated over the temporal patch), uint8 with
    `patch_norm` = (scale_pd, shift_pd), normalized in f32 to bf16."""
    h, w = grid_hw
    vit = params["vit"]
    wdtype = getattr(vit["patch_embed"]["w"], "dtype", torch.bfloat16)
    with torch.no_grad():
        if patch_norm is not None:
            scale, shift = (torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                            device=patches.device)
                            for v in patch_norm)
            patches = (patches.float() * scale + shift).to(torch.bfloat16)
        else:
            patches = _vit_input(patches, wdtype)
        hidden = qwen_vit_blocks(vit, cfg.vit, patches,
                                 grid_positions([(1, h, w)]),
                                 grid_segments([(1, h, w)]))
    embeds = patch_merger(vit, hidden)                      # [h*w//4, llm]
    pos = torch.as_tensor(mm_grid_index(1, h, w), dtype=torch.int32,
                          device=embeds.device)
    return QwenVisualOutput(embeds, pos)


# ---------------------------------------------------------------------------
# LLM integration
# ---------------------------------------------------------------------------

def splice_video_embeds(params: dict, cfg: VStreamQwenConfig,
                        input_ids: np.ndarray, video_embeds: torch.Tensor,
                        pad_id: Optional[int] = None) -> torch.Tensor:
    """Replace the contiguous video-pad token block of host-side ids [S]
    with the video embeddings. Returns [1, S, llm_hidden]."""
    (vid_pos,) = np.where(input_ids == (
        cfg.video_token_id if pad_id is None else pad_id))
    if len(vid_pos) != video_embeds.shape[0]:
        raise ValueError(f"video token count {len(vid_pos)} != embeds "
                         f"{video_embeds.shape[0]}")
    start = int(vid_pos[0])
    if not np.array_equal(vid_pos, np.arange(start, start + len(vid_pos))):
        raise ValueError("video tokens must be contiguous")
    ids = torch.as_tensor(np.asarray(input_ids),
                          device=video_embeds.device)[None]
    embeds = embed_tokens(params["llm"], ids)
    return torch.cat([embeds[:, :start],
                      video_embeds[None].to(embeds.dtype),
                      embeds[:, start + len(vid_pos):]], dim=1)


def build_qwen_positions(seq_len: int, video_start: int, n_visual: int,
                         visual_positions: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D rope positions with the AM-RoPE visual block spliced in (one
    video, batch 1): text counts up to the block, the block is offset by its
    start, and the text after it resumes at max(block) + 1. Returns
    ([3, 1, seq_len], rope_delta = max(pos) + 1 - seq_len)."""
    dev = visual_positions.device
    vp = visual_positions.long()
    pre = torch.arange(video_start, device=dev)[None].expand(3, video_start)
    vis = vp + video_start
    tail_len = seq_len - video_start - n_visual
    tail = (vis.max() + 1 + torch.arange(tail_len, device=dev))[None].expand(
        3, tail_len)
    pos = torch.cat([pre, vis, tail], dim=1)
    return pos[:, None, :], pos.max() + 1 - seq_len


def build_qwen_positions_dynamic(seq_len: int, video_start, n_visual: int,
                                 visual_positions: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`build_qwen_positions` with the splice offset as data (a tensor or
    int), written as masks over a static [3, seq_len] grid, as the JAX
    version with its traced offset."""
    dev = visual_positions.device
    vp = visual_positions.long()
    i = torch.arange(seq_len, device=dev)
    start = torch.as_tensor(video_start, device=dev).long()
    j = torch.clamp(i - start, 0, n_visual - 1)
    vis_at = vp[:, j]                                          # [3, S]
    in_vis = (i >= start) & (i < start + n_visual)
    after = i >= start + n_visual
    text_after = vp.max() + start + 1 + (i - start - n_visual)
    pos = torch.where(in_vis[None], vis_at + start,
                      torch.where(after[None], text_after[None],
                                  i[None].expand(3, seq_len)))
    return pos[:, None, :], pos.max() + 1 - seq_len


def splice_embeds_dynamic(embeds: torch.Tensor, visual: torch.Tensor,
                          start) -> torch.Tensor:
    """embeds [1, S, D] with rows start:start+n_vis replaced by the visual
    block, as a new tensor (no in-place write into a tensor autograd may
    hold): gradients reach `visual` and the kept rows of `embeds`."""
    n = visual.shape[0]
    start = int(start)
    return torch.cat([embeds[:, :start], visual[None].to(embeds.dtype),
                      embeds[:, start + n:]], dim=1)


def qwen_forward_train(params: dict, cfg: VStreamQwenConfig,
                       patches: torch.Tensor, grid: Tuple[int, int, int],
                       input_ids: torch.Tensor,           # [1, S]
                       video_span: Tuple[int, int],       # (start, n_visual)
                       positions: torch.Tensor,           # [3, 1, S]
                       segment_ids: Optional[torch.Tensor] = None,
                       draws=None,
                       remat: bool = True) -> torch.Tensor:
    """Training forward -> f32 logits [1, S, vocab], positions given."""
    vis = encode_video(params, cfg, patches, grid, draws=draws)
    start, n_vis = video_span
    embeds = embed_tokens(params["llm"], input_ids)
    embeds = splice_embeds_dynamic(embeds, vis.video_embeds, start)
    h = decoder_forward(params["llm"], cfg.llm, embeds, positions,
                        segment_ids=segment_ids, remat=remat)
    return lm_head(params["llm"], cfg.llm, h)
