"""A tiny Qwen2-VL checkpoint directory written by the port, for the tests
of the port's `--model-path` entry points.

The tiny config's towers with a vocabulary that holds Qwen2-VL's special
token ids (the HF tokenizer of tests/hf_tok.py pins them at 151643-151656),
random f32 weights from a torch generator, written with the port's own
safetensors writer, a config.json (`hf_qwen_config`) and the tokenizer's
files beside them.
"""
import dataclasses

import torch

from flash_vstream_tpu_torch.core.config import tiny_qwen_config
from flash_vstream_tpu_torch.models.vstream_qwen import init_qwen_params
from flash_vstream_tpu_torch.weights.export import (export_llama,
                                                    export_qwen_vit,
                                                    hf_qwen_config,
                                                    save_hf_checkpoint)
from hf_tok import make_hf_qwen_tokenizer


def checkpoint_config():
    tiny = tiny_qwen_config()
    return tiny.replace(
        llm=dataclasses.replace(tiny.llm, vocab_size=151680),
        image_token_id=151655, video_token_id=151656,
        vision_start_token_id=151652)


def write_tiny_checkpoint(path: str, seed: int = 0):
    """Writes the checkpoint into `path`; returns (cfg, f32 params)."""
    cfg = checkpoint_config()
    params = init_qwen_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    sd = export_llama(params["llm"], cfg.llm)
    sd.update(export_qwen_vit(params["vit"], cfg.vit))
    save_hf_checkpoint(path, sd, config=hf_qwen_config(cfg))
    make_hf_qwen_tokenizer().save_pretrained(path)
    return cfg, params


def write_tiny_llava_checkpoint(path: str, seed: int = 0):
    """A tiny Flash-VStream-LLaVA checkpoint (the tiny LLaVA config, random
    f32 weights, the reference's layout) with a Llama-style HF tokenizer
    (bos 1, eos 2, a vocabulary inside the tiny config's 512) beside it;
    returns (cfg, f32 params)."""
    from flash_vstream_tpu_torch.core.config import tiny_llava_config
    from flash_vstream_tpu_torch.models.vstream_llava import init_llava_params
    from flash_vstream_tpu_torch.weights.export import export_llava_checkpoint
    from hf_tok import make_hf_llama_tokenizer
    cfg = tiny_llava_config()
    params = init_llava_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    save_hf_checkpoint(path, export_llava_checkpoint(params, cfg))
    make_hf_llama_tokenizer().save_pretrained(path)
    return cfg, params
