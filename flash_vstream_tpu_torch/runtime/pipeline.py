"""Offline question answering over a whole video or one still image, Qwen
family.

Port of `QwenPipeline` (flash_vstream_tpu/runtime/pipeline.py:132-229),
the reference's offline `model.generate()` (inference_mcq_vqa.py:291-346):
frames -> smart resize on the host -> uint8 to the device -> patchify and
normalize -> `encode_video` (the dual-resolution ViT over every frame at
once, Flash memory consolidation, PatchMerger) -> ChatML prompt with the
video block -> AM-RoPE positions -> prefill (K1 on the card) and greedy or
sampled decode. `answer_image` takes the standard Qwen2-VL route: the
varlen ViT over the full patch grid (`encode_image`), no Flash memory, the
mm rope index.

The k-means init of the consolidation draws `[t]` uniforms from a
`torch.Generator` seeded with `seed`, where JAX draws them from
`PRNGKey(seed)`; callers may hand the draws in (`init_scores`), as the
tests hand in JAX's. PyTorch compiles nothing, so the JAX version's jit
cache per grid has no counterpart. `LLaVAPipeline` waits for ROADMAP A13.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import VStreamQwenConfig
from ..models.flash_memory import mm_rope_positions
from ..models.llm import Qwen2Decoder
from ..models.vstream_qwen import (build_qwen_positions, encode_image,
                                   encode_video, splice_video_embeds)
from ..preprocess.image import (frame_hw, qwen_device_preprocess,
                                qwen_resize_u8, smart_resize)
from ..preprocess.qwen_processor import (_image_pad_id, _video_pad_id,
                                         build_mm_prompt, build_video_prompt)
from .generation import GenerationConfig, Generator, trim_stop_strings

# model inputs of one question: (embeds [1, S, D], positions [3, 1, S],
# first decode position)
Inputs = Tuple[torch.Tensor, torch.Tensor, int]


class QwenPipeline:
    """Offline Qwen-generation video QA / MCQ on the device of `params`."""

    def __init__(self, params: dict, cfg: VStreamQwenConfig, tokenizer,
                 max_len: int = 16384, max_pixels: int = 4 * 224 * 224):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_pixels = max_pixels
        self.generator = Generator(Qwen2Decoder(cfg.llm, params["llm"]),
                                   max_len=max_len)
        self.device = self.generator.device

    def _resize(self, frames: Sequence[np.ndarray]):
        """uint8 frames [T, h, w, 3] on the device (T padded to even) at the
        smart-resize target of the first frame, and their patch grid."""
        H, W = frame_hw(frames[0])
        nh, nw = smart_resize(H, W, factor=56, max_pixels=self.max_pixels)
        u8 = torch.from_numpy(qwen_resize_u8(frames, (nh, nw)))
        return u8.to(self.device), (nh // 14, nw // 14)

    def _default_gen(self) -> GenerationConfig:
        return GenerationConfig(
            max_new_tokens=128, eos_token_ids=(self.tokenizer.eos_token_id,))

    def _text(self, ids: List[int], gen: GenerationConfig) -> str:
        text = self.tokenizer.decode(ids, skip_special_tokens=True)
        # ChatML assistant turns end on <|im_end|>
        return trim_stop_strings(text,
                                 tuple(gen.stop_strings) or ("<|im_end|>",))

    @torch.no_grad()
    def video_inputs(self, frames: Sequence[np.ndarray], question: str,
                     seed: int = 0,
                     init_scores: Optional[torch.Tensor] = None) -> Inputs:
        """The prompt of a video question: every frame through the ViT and
        Flash memory, the video block spliced into the ChatML ids."""
        u8, (gh, gw) = self._resize(frames)
        grid = (u8.shape[0] // 2, gh, gw)
        if init_scores is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            init_scores = torch.rand(grid[0], generator=g, device=self.device)
        vis = encode_video(self.params, self.cfg, qwen_device_preprocess(u8),
                           grid, init_scores=init_scores.to(self.device))
        input_ids, (start, n) = build_video_prompt(
            self.cfg, self.tokenizer, question, grid=grid)
        # the tokenizer's pad id (JAX splices at cfg.video_token_id, the
        # same id for an HF tokenizer and for the tiny config's byte one)
        embeds = splice_video_embeds(
            self.params, self.cfg, input_ids, vis.video_embeds,
            pad_id=_video_pad_id(self.tokenizer, self.cfg))
        positions, delta = build_qwen_positions(len(input_ids), start, n,
                                                vis.visual_positions)
        return embeds, positions, len(input_ids) + int(delta)

    @torch.no_grad()
    def image_inputs(self, image: np.ndarray, question: str) -> Inputs:
        """The prompt of an image question: the full patch grid through the
        varlen ViT, the image block spliced into the ChatML ids."""
        u8, grid_hw = self._resize([image])
        vis = encode_image(self.params, self.cfg, qwen_device_preprocess(u8),
                           grid_hw)
        input_ids, spans = build_mm_prompt(
            self.cfg, self.tokenizer, question, [("image", grid_hw)])
        embeds = splice_video_embeds(
            self.params, self.cfg, input_ids, vis.video_embeds,
            pad_id=_image_pad_id(self.tokenizer, self.cfg))
        positions, delta = mm_rope_positions(
            input_ids, [(spans[0][0], vis.visual_positions)])
        positions = torch.as_tensor(positions, device=self.device)[:, None]
        return embeds, positions, len(input_ids) + delta

    @torch.no_grad()
    def answer_tokens(self, frames: Sequence[np.ndarray], question: str,
                      gen: Optional[GenerationConfig] = None, seed: int = 0,
                      init_scores: Optional[torch.Tensor] = None
                      ) -> List[int]:
        """The answer's token ids over a whole video."""
        embeds, positions, start = self.video_inputs(frames, question, seed,
                                                     init_scores)
        return self.generator.generate(embeds, positions,
                                       gen or self._default_gen(),
                                       decode_pos_start=start)

    @torch.no_grad()
    def answer(self, frames: Sequence[np.ndarray], question: str,
               gen: Optional[GenerationConfig] = None, seed: int = 0,
               init_scores: Optional[torch.Tensor] = None) -> str:
        gen = gen or self._default_gen()
        return self._text(self.answer_tokens(frames, question, gen, seed,
                                             init_scores), gen)

    @torch.no_grad()
    def answer_image_tokens(self, image: np.ndarray, question: str,
                            gen: Optional[GenerationConfig] = None
                            ) -> List[int]:
        """The answer's token ids over one still image."""
        embeds, positions, start = self.image_inputs(image, question)
        return self.generator.generate(embeds, positions,
                                       gen or self._default_gen(),
                                       decode_pos_start=start)

    @torch.no_grad()
    def answer_image(self, image: np.ndarray, question: str,
                     gen: Optional[GenerationConfig] = None) -> str:
        gen = gen or self._default_gen()
        return self._text(self.answer_image_tokens(image, question, gen), gen)


def load_qwen_model(model_path: Optional[str], device=None,
                    dry_run: bool = False,
                    flash_memory_dict: Optional[str] = None):
    """(cfg, params, tokenizer) of a Qwen entry point on `device` (default:
    the card). With `dry_run`: the tiny config, random weights from a torch
    generator seeded 0 (f32 on the CPU, as the JAX dry run; bf16 on the
    card, the kernels' type) and the byte tokenizer. Else the HF checkpoint
    directory `model_path`: its weights in bf16, its config.json (where
    JAX's entry points take the 7B config; a Qwen2-VL-7B checkpoint gives
    the same), `flash_memory_dict` (JSON) over its Flash memory, and its
    HF tokenizer (`transformers`)."""
    import json

    from ..core.config import FlashMemoryConfig, tiny_qwen_config
    from ..core.device import dry_run_dtype, resolve_device
    device = resolve_device(device)
    if dry_run:
        from ..models.vstream_qwen import init_qwen_params
        from ..preprocess.qwen_processor import make_byte_qwen_tokenizer
        cfg = tiny_qwen_config()
        params = init_qwen_params(
            cfg, torch.Generator(device=device).manual_seed(0), device,
            dtype=dry_run_dtype(device))
        return cfg, params, make_byte_qwen_tokenizer()
    if not model_path:
        raise ValueError("pass --model-path DIR (an HF checkpoint "
                         "directory) or --dry-run")
    from ..preprocess.tokenizer import load_tokenizer
    from ..weights.convert import load_qwen_checkpoint, qwen_config_from_hf
    cfg = qwen_config_from_hf(model_path)
    if flash_memory_dict:
        cfg = cfg.replace(flash_memory=FlashMemoryConfig.from_dict(
            json.loads(flash_memory_dict)))
    params = load_qwen_checkpoint(model_path, cfg, dtype=torch.bfloat16,
                                  device=device)
    return cfg, params, load_tokenizer(model_path)
