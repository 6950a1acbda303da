"""HF checkpoint -> the port's parameter tree, Qwen family.

Port of flash_vstream_tpu/weights/convert.py:27-101, 147-202, 261-327,
425-488: a directory of `.safetensors` shards (read with the port's own
reader, weights/safetensors_io.py) or an in-memory {name: tensor} state
dict becomes the tree of models/llm.py and models/qwen2_vit.py. Linear
weights transpose from torch's [out, in] to the tree's [in, out], the
packed qkv of the vision blocks splits into q, k and v, and the conv patch
embedding flattens to one matmul weight.

Each stacked [L, ...] leaf is allocated once on the target device and
filled layer by layer from the mapped shards, so a 7B load holds one copy
of the weights on the device and none on the host beyond one layer's
tensor in flight. `apply_lora_adapter` merges a torch-PEFT adapter into
the stacked decoder tree. The LLaVA converters and `load_pretrained_model`
wait for ROADMAP A13.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import torch

from ..core.config import (FlashMemoryConfig, LLMConfig, VitConfig,
                           VStreamQwenConfig)
from ..core.device import resolve_device
from .safetensors_io import load_file


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` shard of a directory, in name order, as one
    state dict of tensors that view the mapped files. An index file
    (`model.safetensors.index.json`) is not read."""
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".safetensors"):
            sd.update(load_file(os.path.join(path, name)))
    if not sd:
        raise FileNotFoundError(f"no .safetensors shards under {path}")
    return sd


def detect_prefix(sd: Dict[str, torch.Tensor], probe: str, candidates) -> str:
    """The prefix of `candidates` under which `probe` exists: checkpoint
    layouts differ across transformers versions ('visual.' or
    'model.visual.', 'model.' or 'model.language_model.')."""
    for c in candidates:
        if c + probe in sd:
            return c
    raise KeyError(f"none of {candidates} + {probe} found in state dict")


class _Converter:
    """Copies state-dict tensors into new leaves of `dtype` on `device`."""

    def __init__(self, sd: Dict[str, torch.Tensor], device, dtype):
        self.sd = sd
        self.device = resolve_device(device)
        self.dtype = dtype

    def one(self, key, transpose: bool = False) -> torch.Tensor:
        """A new leaf from the tensor at `key` (or the tensor itself)."""
        src = self.sd[key] if isinstance(key, str) else key
        src = src.to(self.device)
        src = src.T if transpose else src
        out = torch.empty(src.shape, dtype=self.dtype, device=self.device)
        return out.copy_(src)

    def stack(self, fmt: str, n: int, transpose: bool = False,
              rows: Optional[slice] = None) -> torch.Tensor:
        """[n, ...] from the tensors fmt.format(i=i), each taken at `rows`
        (dim 0, before the transpose) when given."""
        out = None
        for i in range(n):
            src = self.sd[fmt.format(i=i)]
            if rows is not None:
                src = src[rows]
            src = src.to(self.device)
            src = src.T if transpose else src
            if out is None:
                out = torch.empty((n, *src.shape), dtype=self.dtype,
                                  device=self.device)
            out[i].copy_(src)
        return out

    def lin(self, fmt: str, n: int, bias: bool) -> dict:
        p = {"w": self.stack(fmt + ".weight", n, transpose=True)}
        if bias:
            p["b"] = self.stack(fmt + ".bias", n)
        return p


def convert_llama(sd: Dict[str, torch.Tensor], cfg: LLMConfig,
                  prefix: Optional[str] = None, dtype=torch.float32,
                  device=None) -> dict:
    """LlamaForCausalLM / Qwen2 decoder state dict -> the models/llm.py
    tree on `device` (default: the card), every leaf in `dtype`."""
    if prefix is None:
        prefix = detect_prefix(sd, "embed_tokens.weight",
                               ("model.", "model.language_model.",
                                "language_model.", ""))
    c = _Converter(sd, device, dtype)
    L = cfg.num_layers
    lay = prefix + "layers.{i}."
    params = {
        "embed": c.one(prefix + "embed_tokens.weight"),
        "layers": {
            "attn_norm": c.stack(lay + "input_layernorm.weight", L),
            "mlp_norm": c.stack(lay + "post_attention_layernorm.weight", L),
            "attn": {
                "wq": c.lin(lay + "self_attn.q_proj", L, cfg.attention_bias),
                "wk": c.lin(lay + "self_attn.k_proj", L, cfg.attention_bias),
                "wv": c.lin(lay + "self_attn.v_proj", L, cfg.attention_bias),
                "wo": c.lin(lay + "self_attn.o_proj", L, False),
            },
            "mlp": {
                "gate": c.lin(lay + "mlp.gate_proj", L, False),
                "up": c.lin(lay + "mlp.up_proj", L, False),
                "down": c.lin(lay + "mlp.down_proj", L, False),
            },
        },
        "final_norm": c.one(prefix + "norm.weight"),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = c.one("lm_head.weight", transpose=True)
    return params


def convert_qwen_vit(sd: Dict[str, torch.Tensor], cfg: VitConfig,
                     prefix: Optional[str] = None, dtype=torch.float32,
                     device=None) -> dict:
    """HF Qwen2-VL vision tower state dict -> the models/qwen2_vit.py tree
    on `device` (default: the card). The packed qkv Linear splits into q,
    k and v; the conv patch embedding [D, C, tp, ps, ps] becomes the
    matmul weight [C*tp*ps*ps, D]."""
    if prefix is None:
        prefix = detect_prefix(sd, "patch_embed.proj.weight",
                               ("visual.", "model.visual.", ""))
    c = _Converter(sd, device, dtype)
    L, D = cfg.num_layers, cfg.hidden_size
    lay = prefix + "blocks.{i}."

    def ln(fmt, stacked=True):
        if stacked:
            return {"scale": c.stack(fmt + ".weight", L),
                    "bias": c.stack(fmt + ".bias", L)}
        return {"scale": c.one(fmt + ".weight"), "bias": c.one(fmt + ".bias")}

    def qkv(which: int) -> dict:
        rows = slice(which * D, (which + 1) * D)
        return {"w": c.stack(lay + "attn.qkv.weight", L, transpose=True,
                             rows=rows),
                "b": c.stack(lay + "attn.qkv.bias", L, rows=rows)}

    patch = sd[prefix + "patch_embed.proj.weight"]
    patch = patch.reshape(patch.shape[0], -1)      # [D, C*tp*ps*ps]
    return {
        "patch_embed": {"w": c.one(patch, transpose=True)},
        "layers": {
            "ln1": ln(lay + "norm1"),
            "ln2": ln(lay + "norm2"),
            "attn": {
                "wq": qkv(0), "wk": qkv(1), "wv": qkv(2),
                "wo": c.lin(lay + "attn.proj", L, True),
            },
            "mlp": {
                "fc1": c.lin(lay + "mlp.fc1", L, True),
                "fc2": c.lin(lay + "mlp.fc2", L, True),
            },
        },
        "merger": {
            "ln_q": ln(prefix + "merger.ln_q", stacked=False),
            "fc1": {"w": c.one(prefix + "merger.mlp.0.weight", transpose=True),
                    "b": c.one(prefix + "merger.mlp.0.bias")},
            "fc2": {"w": c.one(prefix + "merger.mlp.2.weight", transpose=True),
                    "b": c.one(prefix + "merger.mlp.2.bias")},
        },
    }


def resize_token_embeddings(llm_params: dict, new_size: int) -> dict:
    """Grow the embed rows (and the lm_head's columns) to `new_size`; the
    new ones take the mean of the existing ones, computed in the leaf's
    dtype (initialize_vision_tokenizer). Checkpoints that extended the
    tokenizer need this before their embed rows load. Returns the same
    tree when it is already large enough."""
    embed = llm_params["embed"]
    n_old = embed.shape[0]
    if new_size <= n_old:
        return llm_params
    out = dict(llm_params)
    mean_in = embed.mean(dim=0, keepdim=True)
    out["embed"] = torch.cat(
        [embed, mean_in.expand(new_size - n_old, embed.shape[1])
         .to(embed.dtype)])
    if "lm_head" in llm_params:           # [D, V]
        head = llm_params["lm_head"]
        mean_out = head.mean(dim=1, keepdim=True)
        out["lm_head"] = torch.cat(
            [head, mean_out.expand(head.shape[0], new_size - n_old)
             .to(head.dtype)], dim=1)
    return out


_LORA_PROJ = {"q_proj": ("attn", "wq"), "k_proj": ("attn", "wk"),
              "v_proj": ("attn", "wv"), "o_proj": ("attn", "wo"),
              "gate_proj": ("mlp", "gate"), "up_proj": ("mlp", "up"),
              "down_proj": ("mlp", "down")}


def apply_lora_adapter(llm_params: dict, adapter_sd: Dict[str, object],
                       alpha: float, rank: int) -> dict:
    """Merge torch-PEFT LoRA deltas into the stacked decoder tree:
    W[in, out] += (alpha / r) * (B @ A)^T (merge_and_unload), summed in f32
    and cast back to each leaf's dtype. Adapter keys look like
    base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight; their
    values are tensors or arrays. Returns a new tree; `llm_params` is not
    changed."""
    scale = alpha / rank
    pat = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\."
                     r"lora_(A|B)\.weight$")
    deltas: Dict[tuple, dict] = {}
    for k, v in adapter_sd.items():
        m = pat.search(k)
        if m:
            deltas.setdefault((int(m.group(1)), m.group(2)), {})[
                m.group(3)] = torch.as_tensor(v).float().cpu()
    stacked: Dict[tuple, dict] = {}
    for (i, proj), ab in deltas.items():
        if "A" not in ab or "B" not in ab:
            raise ValueError(f"incomplete LoRA pair for {proj} of layer {i}")
        stacked.setdefault(_LORA_PROJ[proj], {})[i] = \
            scale * (ab["B"] @ ab["A"]).T   # torch [out, in] -> [in, out]
    params = dict(llm_params)
    layers = {k: dict(v) if isinstance(v, dict) else v
              for k, v in llm_params["layers"].items()}
    for (grp, name), per_layer in stacked.items():
        old = llm_params["layers"][grp][name]["w"]
        w = old.float().clone()
        for i, d in per_layer.items():
            w[i] += d.to(w.device)
        layers[grp][name] = dict(layers[grp][name], w=w.to(old.dtype))
    params["layers"] = layers
    return params


def load_qwen_checkpoint(model_dir: str, cfg: VStreamQwenConfig,
                         dtype=torch.float32, device=None) -> dict:
    """A Flash-VStream-Qwen (or base Qwen2-VL) HF checkpoint directory ->
    {"vit", "llm"} on `device` (default: the card) in `dtype`."""
    sd = load_safetensors_dir(model_dir)
    return {
        "vit": convert_qwen_vit(sd, cfg.vit, dtype=dtype, device=device),
        "llm": convert_llama(sd, cfg.llm, dtype=dtype, device=device),
    }


def qwen_config_from_hf(model_dir_or_dict) -> VStreamQwenConfig:
    """A VStreamQwenConfig from an HF checkpoint's config.json (a directory
    or the parsed dict), with the field layout of
    FlashVStreamQwen2VLConfig: the text fields at the top level or under
    `text_config`, the vision fields under `vision_config` (with an
    optional `flash_memory_config`). The JAX function leaves the vision
    config's `image_size` at VitConfig's CLIP default of 224; here it is
    0, Qwen2-VL's variable resolution, as in QWEN2_VL_VIT, so that a
    Qwen2-VL-7B config.json gives `VStreamQwenConfig()`. No Qwen path
    reads it."""
    if isinstance(model_dir_or_dict, dict):
        d = model_dir_or_dict
    else:
        with open(os.path.join(model_dir_or_dict, "config.json")) as f:
            d = json.load(f)
    t = d.get("text_config", d)
    v = d["vision_config"]
    embed_dim = v.get("embed_dim", v.get("hidden_size", 1280))
    vit = VitConfig(
        hidden_size=embed_dim,
        intermediate_size=int(embed_dim * v.get("mlp_ratio", 4)),
        num_layers=v.get("depth", 32),
        num_heads=v.get("num_heads", 16),
        patch_size=v.get("patch_size", 14),
        image_size=0,
        temporal_patch_size=v.get("temporal_patch_size", 2),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        in_channels=v.get("in_channels", 3),
        use_rope_2d=True,
        merger_out_dim=t["hidden_size"],
        hidden_act="quick_gelu",
    )
    mrope = tuple((t.get("rope_scaling") or {}).get(
        "mrope_section", (16, 24, 24)))
    llm = LLMConfig(
        vocab_size=t["vocab_size"],
        hidden_size=t["hidden_size"],
        intermediate_size=t["intermediate_size"],
        num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"],
        num_kv_heads=t.get("num_key_value_heads", t["num_attention_heads"]),
        max_position_embeddings=t.get("max_position_embeddings", 32768),
        rms_norm_eps=t.get("rms_norm_eps", 1e-6),
        rope_theta=t.get("rope_theta", 1e6),
        attention_bias=True,
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        mrope_sections=mrope,
    )
    fm = (FlashMemoryConfig.from_dict(v["flash_memory_config"])
          if v.get("flash_memory_config") else FlashMemoryConfig())
    return VStreamQwenConfig(
        vit=vit, llm=llm, flash_memory=fm,
        image_token_id=d.get("image_token_id", 151655),
        video_token_id=d.get("video_token_id", 151656),
        vision_start_token_id=d.get("vision_start_token_id", 151652),
    )
