"""Flash-VStream-LLaVA composition: CLIP ViT + STAR memory + projector +
Vicuna.

Port of flash_vstream_tpu/models/vstream_llava.py:34-111, the reference's
VStreamMetaForCausalLM / VStreamLlamaForCausalLM (Flash-VStream-LLaVA/
flash_vstream/model/vstream_arch.py:68-743, language_model/
vstream_llama.py:28-129): the parameter init, the frame encode (CLIP,
optional 2x2 merge, spatial pool to the current memory's grid), the
offline consolidation, the host-side token counts of each memory section,
the splice of the projected memory at the prompt's <image> token, and the
training forward (`llava_forward_train`, JAX :121-159): a batch of frame
buckets through the frozen encode (no graph unless a CLIP leaf trains),
one consolidation and `pack_memory_tokens` per sample (JAX vmaps them;
here a loop, each sample with its own draws), the projector, the splice at
the batch's static image slot and the decoder with segment ids under
checkpointing. The parameters stay the JAX tree ({"vit", "projector",
"ntm", "llm"}), which the pipeline and the session take as JAX's do.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.config import IMAGE_TOKEN_INDEX, VStreamLLaVAConfig
from ..core.device import resolve_device
from ..ops.ntm import init_ntm_params
from ..ops.pooling import merge_2x2_tokens, spatial_pool
from .clip_vit import clip_encode, init_clip_params
from .llm import decoder_forward, embed_tokens, init_llm_params, lm_head
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


def _tree_trains(tree) -> bool:
    """Whether any tensor of a parameter subtree requires a gradient (a
    split leaf's: its shard's)."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if hasattr(tree, "shard"):                      # TPShard, ZeroShard
        return _tree_trains(tree.shard)
    if isinstance(tree, dict):
        return any(_tree_trains(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):             # NamedTuples too
        return any(_tree_trains(v) for v in tree)
    return False


def _tower_grad(params: dict):
    """A training loss runs the tower without a graph unless one of its
    leaves trains (both LLaVA recipes freeze it)."""
    return torch.set_grad_enabled(torch.is_grad_enabled()
                                  and _tree_trains(params["vit"]))


def clip_train(params: dict, cfg: VStreamLLaVAConfig,
               images: torch.Tensor) -> torch.Tensor:
    """`clip_encode` of [N, C, H, W] images in a training loss."""
    with _tower_grad(params):
        return clip_encode(params["vit"], cfg.vit, images)


def encode_frames_train(params: dict, cfg: VStreamLLaVAConfig,
                        images: torch.Tensor) -> torch.Tensor:
    """`encode_frames` of [B, T, C, H, W] frames -> [B, T, P_cur, D] in a
    training loss."""
    B, T = images.shape[:2]
    with _tower_grad(params):
        feats = encode_frames(params, cfg,
                              images.reshape(B * T, *images.shape[2:]))
    return feats.reshape(B, T, *feats.shape[1:])


def memory_embeds(params: dict, cfg: VStreamLLaVAConfig,
                  feats: torch.Tensor, n_frames, n_mem: int,
                  draws: Callable[[int, int], torch.Tensor]) -> torch.Tensor:
    """[B, n_mem, D_llm]: each sample's frame-bucket features [T, P, D]
    consolidated over its n_frames[b] frames (draws(b, n): sample b's n
    uniforms), its valid memory packed into n_mem rows, then projected.
    With fewer frames than the bucket's count, the rows past the valid
    memory are invalid ones, as JAX's fixed n_mem splices them."""
    mems = []
    for b in range(feats.shape[0]):
        mem = consolidate(params, cfg, feats[b], int(n_frames[b]),
                          lambda n, b=b: draws(b, n))
        mems.append(pack_memory_tokens(mem, n_mem))
    return project(params["projector"], cfg.projector, torch.stack(mems))


def splice_batch(llm: dict, input_ids: torch.Tensor, image_slot: int,
                 visual: torch.Tensor) -> torch.Tensor:
    """[B, S', D]: the embedded ids before `image_slot`, `visual` [B, N, D]
    in the embedding's dtype, the embedded ids after it (the slot's own id
    is dropped)."""
    return torch.cat([embed_tokens(llm, input_ids[:, :image_slot]),
                      visual.to(llm["embed"].dtype),
                      embed_tokens(llm, input_ids[:, image_slot + 1:])],
                     dim=1)


def decode_train(params: dict, cfg: VStreamLLaVAConfig,
                 embeds: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None,
                 remat: bool = True) -> torch.Tensor:
    """The decoder's final hidden states [B, S, D] of a training batch,
    positions 0..S-1 in every row."""
    B, S = embeds.shape[:2]
    positions = torch.arange(S, device=embeds.device)[None].expand(B, S)
    return decoder_forward(params["llm"], cfg.llm, embeds, positions,
                           segment_ids=segment_ids, remat=remat)


def llava_forward_train(
    params: dict,
    cfg: VStreamLLaVAConfig,
    images: torch.Tensor,        # [B, T, C, H, W] normalized frames
    n_frames,                    # [B] frames present
    input_ids: torch.Tensor,     # [B, S] with the image slot at image_slot
    image_slot: int,             # static splice position (the collator's)
    n_mem: int,                  # static memory token count of the bucket
    segment_ids: Optional[torch.Tensor] = None,   # [B, S'], -1 = padding
    draws: Optional[Callable[[int, int], torch.Tensor]] = None,
    remat: bool = True,
) -> torch.Tensor:
    """Training forward -> f32 logits [B, S', V], S' = S - 1 + n_mem. The
    collator pads every sample of a batch to one frame bucket and splice
    position, so the spliced sequence has one shape (train/data.py).
    `draws(b, n)` gives sample b's n uniforms (default: a generator seeded
    with b, anew at every call); JAX splits one key per sample."""
    if draws is None:
        def draws(b, n):
            g = torch.Generator(device=images.device).manual_seed(b)
            return torch.rand(n, generator=g, device=images.device)
    feats = encode_frames_train(params, cfg, images)
    mem_proj = memory_embeds(params, cfg, feats, n_frames, n_mem, draws)
    embeds = splice_batch(params["llm"], input_ids, image_slot, mem_proj)
    h = decode_train(params, cfg, embeds, segment_ids, remat)
    return lm_head(params["llm"], cfg.llm, h)
