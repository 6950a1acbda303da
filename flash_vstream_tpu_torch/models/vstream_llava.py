"""Flash-VStream-LLaVA composition: CLIP ViT + STAR memory + projector +
Vicuna.

Port of flash_vstream_tpu/models/vstream_llava.py:34-111, the reference's
VStreamMetaForCausalLM / VStreamLlamaForCausalLM (Flash-VStream-LLaVA/
flash_vstream/model/vstream_arch.py:68-743, language_model/
vstream_llama.py:28-129): the parameter init, the frame encode (CLIP,
optional 2x2 merge, spatial pool to the current memory's grid), the
offline consolidation, the host-side token counts of each memory section,
and the splice of the projected memory at the prompt's <image> token.
The parameters stay the JAX tree ({"vit", "projector", "ntm", "llm"}),
which the pipeline and the session take as JAX's do. The training forward
waits for ROADMAP A13.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.config import IMAGE_TOKEN_INDEX, VStreamLLaVAConfig
from ..core.device import resolve_device
from ..ops.ntm import init_ntm_params
from ..ops.pooling import merge_2x2_tokens, spatial_pool
from .clip_vit import clip_encode, init_clip_params
from .llm import embed_tokens, init_llm_params
from .projector import init_projector_params, project
from .star_memory import Draws, STARMemory, star_consolidate


def init_llava_params(cfg: VStreamLLaVAConfig, generator: torch.Generator,
                      device=None, dtype=torch.float32) -> dict:
    """Random {"vit", "projector", "ntm", "llm"} parameters with the JAX
    init's tree and distributions, drawn on `device` (default: the card)
    from `generator` (which must live on that device)."""
    device = resolve_device(device)
    return {
        "vit": init_clip_params(cfg.vit, generator, device, dtype),
        "projector": init_projector_params(cfg.projector, generator, device,
                                           dtype),
        "ntm": init_ntm_params(generator, cfg.projector.effective_input_dim,
                               cfg.star.turing_hidden_dim, device, dtype),
        "llm": init_llm_params(cfg.llm, generator, device, dtype),
    }


def encode_frames(params: dict, cfg: VStreamLLaVAConfig,
                  images: torch.Tensor) -> torch.Tensor:
    """CLIP-encode frames [T, C, H, W] -> pooled features [T, P_cur, D]
    (encode_images, the optional 2x2 merge, compress_spatial_features:
    vstream_arch.py:316-319)."""
    feats = clip_encode(params["vit"], cfg.vit, images)      # [T, P, D]
    if cfg.projector.use_4_vision_tokens:
        feats = merge_2x2_tokens(feats)                      # [T, P/4, 4D]
    return spatial_pool(feats, cfg.star.current_size)        # [T, P_cur, D]


def consolidate(params: dict, cfg: VStreamLLaVAConfig,
                features: torch.Tensor, n_valid: int,
                draws: Draws) -> STARMemory:
    return star_consolidate(params["ntm"], cfg.star, features, n_valid, draws)


def star_valid_counts(cfg: VStreamLLaVAConfig, n_frames: int,
                      streaming: bool = False) -> Tuple[int, int, int, int]:
    """Token counts (Turing, long, key, current) of the valid memory of a
    video of n_frames. Offline keeps the current frames out of the history
    (vstream_arch.py:248-250); streaming folds every frame into the long
    and Turing memories (vstream_arch.py:657-658)."""
    star = cfg.star
    n_hist = n_frames if streaming else max(n_frames - star.current_length, 0)
    n_turing = min(n_hist, star.turing_length) * star.turing_size ** 2
    n_long = min(n_hist, star.long_length) * star.long_size ** 2
    n_key = (star.key_length if n_hist > 0 and star.long_length > 0
             else 0) * star.current_size ** 2
    n_cur = min(n_frames, star.current_length) * star.current_size ** 2
    return n_turing, n_long, n_key, n_cur


def pack_memory_tokens(memory: STARMemory, n_mem: int) -> torch.Tensor:
    """The valid memory tokens, in order, packed into [n_mem, D] (rows
    past the valid count are the invalid ones, in order)."""
    order = torch.argsort((~memory.valid).to(torch.int8), stable=True)
    return memory.tokens[order][:n_mem]


def build_multimodal_embeds(
    params: dict,
    cfg: VStreamLLaVAConfig,
    input_ids: np.ndarray,          # [S] host ids, one IMAGE_TOKEN_INDEX
    memory: STARMemory,
    n_frames: int,
    streaming: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projected memory tokens spliced in at the <image> position
    (prepare_inputs_labels_for_multimodal, vstream_arch.py:355-436, for
    batch 1): (embeds [1, S', D], positions [1, S'])."""
    n_mem = sum(star_valid_counts(cfg, n_frames, streaming=streaming))
    mem_proj = project(params["projector"], cfg.projector,
                       pack_memory_tokens(memory, n_mem))
    (img_pos,) = np.where(np.asarray(input_ids) == IMAGE_TOKEN_INDEX)
    if len(img_pos) != 1:
        raise ValueError(f"expected exactly one <image> token, got "
                         f"{len(img_pos)}")
    p = int(img_pos[0])
    embeds = splice_image(params["llm"], input_ids[:p], input_ids[p + 1:],
                          mem_proj)
    positions = torch.arange(embeds.shape[1], device=embeds.device)[None]
    return embeds, positions


def splice_image(llm: dict, pre_ids, post_ids,
                 visual: torch.Tensor) -> torch.Tensor:
    """[1, S', D]: the embedded `pre_ids`, `visual` [N, D] in the
    embedding's dtype, the embedded `post_ids` (host ids)."""
    def emb(ids):
        t = torch.as_tensor(np.asarray(ids, np.int64), device=visual.device)
        return embed_tokens(llm, t[None])
    return torch.cat([emb(pre_ids), visual[None].to(llm["embed"].dtype),
                      emb(post_ids)], dim=1)
