"""Flash-VStream-Qwen composition: Qwen2-VL ViT + Qwen2 decoder.

Port of flash_vstream_tpu/models/vstream_qwen.py:33-66: the parameter init
and the visual token count of a (t, h, w) grid. `VStreamQwen` holds both
halves as modules whose `state_dict()` keys are the JAX tree's key paths.
"""
from __future__ import annotations

from typing import Tuple

import torch

from flash_vstream_tpu.core.config import VStreamQwenConfig

from .llm import Qwen2Decoder, init_llm_params
from .qwen2_vit import QwenVisionTransformer, init_qwen_vit_params


def init_qwen_params(cfg: VStreamQwenConfig, generator: torch.Generator,
                     device=None, dtype=torch.float32) -> dict:
    """Random {"vit", "llm"} parameters with the JAX init's tree and
    distributions, drawn on `device` from `generator` (which must live on
    that device)."""
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
