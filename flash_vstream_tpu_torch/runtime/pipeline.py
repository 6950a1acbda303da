"""Offline question answering over a whole video or one still image, both
families.

`LLaVAPipeline` is the port of flash_vstream_tpu/runtime/pipeline.py:
41-129, the reference's offline LLaVA generate (eval_video/
model_msvd_qa.py:147-156): frames -> pad to square and resize on the host
-> uint8 to the device -> normalize -> CLIP (K1 on the card) -> pooled
features, padded to a frame-count bucket (`_bucket`) -> STAR consolidation
-> the projected memory spliced at <image> in the vicuna_v1 prompt ->
prefill (K1) and decode. `answer_image` projects an image's full CLIP
patch features (256 tokens at 224 px) with no memory. The consolidation's
k-means draws `[Tb]` uniforms from a `torch.Generator` seeded with `seed`
for each draw, where JAX draws them from `PRNGKey(seed)`; callers may hand
a draw function in (`draws`), as the tests hand in JAX's.

`QwenPipeline` is the port of `QwenPipeline` (pipeline.py:132-229),
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
`PRNGKey(seed)`; callers may hand the draws in (`draws`: a function n ->
[n] uniforms), as the tests hand in JAX's. PyTorch compiles nothing, so
the JAX versions' jit caches have no counterpart.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import (IMAGE_TOKEN_INDEX, VStreamLLaVAConfig,
                           VStreamQwenConfig)
from ..models.clip_vit import clip_encode
from ..models.flash_memory import mm_rope_positions
from ..models.llm import Qwen2Decoder
from ..models.projector import project
from ..models.vstream_llava import (build_multimodal_embeds, consolidate,
                                    encode_frames, splice_image)
from ..models.vstream_qwen import (build_qwen_positions, encode_image,
                                   encode_video, splice_video_embeds)
from ..preprocess.image import (clip_device_preprocess, clip_preprocess,
                                clip_resize_u8, frame_hw,
                                qwen_device_preprocess, qwen_resize_u8,
                                smart_resize)
from ..preprocess.prompts import conv_templates
from ..preprocess.qwen_processor import (_image_pad_id, _video_pad_id,
                                         build_mm_prompt, build_video_prompt)
from ..preprocess.tokenizer import (KeywordsStoppingCriteria,
                                    tokenizer_image_token)
from .generation import (GenerationConfig, Generator, default_gen,
                         trim_stop_strings)

# model inputs of one question: (embeds [1, S, D], positions [3, 1, S],
# first decode position)
Inputs = Tuple[torch.Tensor, torch.Tensor, int]


def _bucket(n: int, sizes=(8, 16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    """The frame-count bucket a video is padded to before consolidation
    (JAX compiles once a bucket; the draws and the padding follow it)."""
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


def seeded_draws(seed: int, device) -> Callable[[int], torch.Tensor]:
    """n -> [n] uniform f32 draws from a torch generator seeded with `seed`,
    anew at every call: like a JAX key, the same n gives the same draws."""
    def draws(n: int) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.rand(n, generator=g, device=device)
    return draws


def llava_prompt(question: str, tokenizer, conv_template: str = "vicuna_v1"):
    """(the conversation, its ids with IMAGE_TOKEN_INDEX at <image>) of one
    LLaVA question: `<image>` and the question as the user's turn, the
    assistant's turn open."""
    conv = conv_templates[conv_template].copy()
    conv.append_message(conv.roles[0], "<image>\n" + question)
    conv.append_message(conv.roles[1], None)
    return conv, tokenizer_image_token(conv.get_prompt(), tokenizer)


class LLaVAPipeline:
    """Offline LLaVA-generation video and image QA on the device of
    `params`."""

    def __init__(self, params: dict, cfg: VStreamLLaVAConfig, tokenizer,
                 conv_template: str = "vicuna_v1", max_len: int = 4096):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.conv_template = conv_template
        self.generator = Generator(Qwen2Decoder(cfg.llm, params["llm"]),
                                   max_len=max_len)
        self.device = self.generator.device

    def _generate(self, embeds, positions, conv, gen) -> List[int]:
        # sampled decodes (the reference evaluates at temperature 0.002)
        # stop on the conversation separator as they go
        return self.generator.generate(
            embeds, positions, gen,
            stopping=KeywordsStoppingCriteria([conv.stop_str],
                                              self.tokenizer))

    def _text(self, ids: List[int], gen: GenerationConfig) -> str:
        text = self.tokenizer.decode(ids, skip_special_tokens=True)
        stop = conv_templates[self.conv_template].stop_str
        return trim_stop_strings(text, tuple(gen.stop_strings) or (stop,))

    @torch.no_grad()
    def encode_video(self, frames: Sequence[np.ndarray]) -> torch.Tensor:
        """Pooled CLIP features [T, P_cur, D] of every frame at once."""
        u8 = torch.from_numpy(clip_resize_u8(frames, self.cfg.vit.image_size))
        return encode_frames(self.params, self.cfg,
                             clip_device_preprocess(u8.to(self.device)))

    @torch.no_grad()
    def answer_tokens(self, frames: Sequence[np.ndarray], question: str,
                      gen: Optional[GenerationConfig] = None, seed: int = 0,
                      features: Optional[torch.Tensor] = None,
                      draws: Optional[Callable] = None) -> List[int]:
        """The answer's token ids over a whole video (or its features)."""
        if features is None:
            features = self.encode_video(frames)
        T = features.shape[0]
        pad = _bucket(T) - T
        feats = torch.cat([features, features.new_zeros(
            pad, *features.shape[1:])]) if pad > 0 else features
        memory = consolidate(self.params, self.cfg, feats, T,
                             draws or seeded_draws(seed, self.device))
        conv, input_ids = llava_prompt(question, self.tokenizer,
                                       self.conv_template)
        embeds, positions = build_multimodal_embeds(
            self.params, self.cfg, input_ids, memory, T)
        return self._generate(embeds, positions, conv,
                              gen or default_gen(self.tokenizer))

    @torch.no_grad()
    def answer(self, frames: Sequence[np.ndarray], question: str,
               gen: Optional[GenerationConfig] = None, seed: int = 0,
               features: Optional[torch.Tensor] = None,
               draws: Optional[Callable] = None) -> str:
        gen = gen or default_gen(self.tokenizer)
        return self._text(self.answer_tokens(frames, question, gen, seed,
                                             features, draws), gen)

    @torch.no_grad()
    def answer_image_tokens(self, image: np.ndarray, question: str,
                            gen: Optional[GenerationConfig] = None
                            ) -> List[int]:
        """The answer's token ids over one image: its full CLIP patch
        features projected, no memory (vstream_arch.py:333-336)."""
        imgs = torch.from_numpy(clip_preprocess([image],
                                                self.cfg.vit.image_size))
        feats = clip_encode(self.params["vit"], self.cfg.vit,
                            imgs.to(self.device))[0]
        proj = project(self.params["projector"], self.cfg.projector, feats)
        conv, input_ids = llava_prompt(question, self.tokenizer,
                                       self.conv_template)
        p = int(np.where(input_ids == IMAGE_TOKEN_INDEX)[0][0])
        embeds = splice_image(self.params["llm"], input_ids[:p],
                              input_ids[p + 1:], proj)
        positions = torch.arange(embeds.shape[1], device=self.device)[None]
        return self._generate(embeds, positions, conv,
                              gen or default_gen(self.tokenizer))

    @torch.no_grad()
    def answer_image(self, image: np.ndarray, question: str,
                     gen: Optional[GenerationConfig] = None) -> str:
        gen = gen or default_gen(self.tokenizer)
        return self._text(self.answer_image_tokens(image, question, gen), gen)


def load_llava_model(model_path: Optional[str], device=None,
                     dry_run: bool = False):
    """(cfg, params, tokenizer) of a LLaVA entry point on `device`
    (default: the card). With `dry_run`: the tiny config, random weights
    from a torch generator seeded 0 (f32 on the CPU, bf16 on the card) and
    the byte tokenizer. Else the Flash-VStream-LLaVA checkpoint directory
    `model_path` in bf16 with `VStreamLLaVAConfig()`, as the JAX server
    loads it, and its HF tokenizer (`transformers`)."""
    from ..core.config import tiny_llava_config
    from ..core.device import dry_run_dtype, resolve_device
    device = resolve_device(device)
    if dry_run:
        from ..models.vstream_llava import init_llava_params
        from ..preprocess.tokenizer import ByteTokenizer
        cfg = tiny_llava_config()
        params = init_llava_params(
            cfg, torch.Generator(device=device).manual_seed(0), device,
            dtype=dry_run_dtype(device))
        return cfg, params, ByteTokenizer()
    if not model_path:
        raise ValueError("pass --model-path DIR (a Flash-VStream-LLaVA "
                         "checkpoint directory) or --dry-run")
    from ..preprocess.tokenizer import load_tokenizer
    from ..weights.convert import load_llava_checkpoint
    cfg = VStreamLLaVAConfig()
    params = load_llava_checkpoint(model_path, cfg, dtype=torch.bfloat16,
                                   device=device)
    return cfg, params, load_tokenizer(model_path)


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

    def _text(self, ids: List[int], gen: GenerationConfig) -> str:
        text = self.tokenizer.decode(ids, skip_special_tokens=True)
        # ChatML assistant turns end on <|im_end|>
        return trim_stop_strings(text,
                                 tuple(gen.stop_strings) or ("<|im_end|>",))

    @torch.no_grad()
    def video_inputs(self, frames: Sequence[np.ndarray], question: str,
                     seed: int = 0,
                     draws: Optional[Callable] = None) -> Inputs:
        """The prompt of a video question: every frame through the ViT and
        Flash memory, the video block spliced into the ChatML ids."""
        u8, (gh, gw) = self._resize(frames)
        grid = (u8.shape[0] // 2, gh, gw)
        if draws is None:
            draws = seeded_draws(seed, self.device)
        vis = encode_video(self.params, self.cfg, qwen_device_preprocess(u8),
                           grid, draws=draws)
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
                      draws: Optional[Callable] = None) -> List[int]:
        """The answer's token ids over a whole video."""
        embeds, positions, start = self.video_inputs(frames, question, seed,
                                                     draws)
        return self.generator.generate(embeds, positions,
                                       gen or default_gen(self.tokenizer),
                                       decode_pos_start=start)

    @torch.no_grad()
    def answer(self, frames: Sequence[np.ndarray], question: str,
               gen: Optional[GenerationConfig] = None, seed: int = 0,
               draws: Optional[Callable] = None) -> str:
        gen = gen or default_gen(self.tokenizer)
        return self._text(self.answer_tokens(frames, question, gen, seed,
                                             draws), gen)

    @torch.no_grad()
    def answer_image_tokens(self, image: np.ndarray, question: str,
                            gen: Optional[GenerationConfig] = None
                            ) -> List[int]:
        """The answer's token ids over one still image."""
        embeds, positions, start = self.image_inputs(image, question)
        return self.generator.generate(embeds, positions,
                                       gen or default_gen(self.tokenizer),
                                       decode_pos_start=start)

    @torch.no_grad()
    def answer_image(self, image: np.ndarray, question: str,
                     gen: Optional[GenerationConfig] = None) -> str:
        gen = gen or default_gen(self.tokenizer)
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
