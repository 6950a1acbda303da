"""HF checkpoint -> the port's parameter tree, both families.

Port of flash_vstream_tpu/weights/convert.py: a directory of
`.safetensors` shards (read with the port's own reader,
weights/safetensors_io.py) or an in-memory {name: tensor} state dict
becomes the tree of models/llm.py, models/qwen2_vit.py, models/clip_vit.py,
models/projector.py and the NTM. Linear weights transpose from torch's
[out, in] to the tree's [in, out], the packed qkv of the Qwen vision blocks
splits into q, k and v, and the conv patch embeddings flatten to one matmul
weight.

Each stacked [L, ...] leaf is allocated once on the target device and
filled layer by layer from the mapped shards, so a 7B load holds one copy
of the weights on the device and none on the host beyond one layer's
tensor in flight. `apply_lora_adapter` merges a torch-PEFT adapter into
the stacked decoder tree; `load_pretrained_model` is the reference
builder's three LLaVA branches (full, projector-only, LoRA over a base).
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


def convert_clip_vit(sd: Dict[str, torch.Tensor], cfg: VitConfig,
                     prefix: str = "vision_model.", dtype=torch.float32,
                     device=None) -> dict:
    """HF CLIPVisionModel state dict -> the models/clip_vit.py tree on
    `device` (default: the card); the conv patch embedding [D, C, ps, ps]
    becomes the matmul weight [C*ps*ps, D]."""
    c = _Converter(sd, device, dtype)
    L = cfg.num_layers
    lay = prefix + "encoder.layers.{i}."

    def ln(fmt):
        return {"scale": c.stack(fmt + ".weight", L),
                "bias": c.stack(fmt + ".bias", L)}

    patch = sd[prefix + "embeddings.patch_embedding.weight"]
    patch = patch.reshape(patch.shape[0], -1)          # [D, C*ps*ps]
    # 'pre_layrnorm' is the (misspelled) HF attribute name
    pre = prefix + ("pre_layrnorm" if prefix + "pre_layrnorm.weight" in sd
                    else "pre_layernorm")
    return {
        "patch_embed": {"w": c.one(patch, transpose=True)},
        "class_embed": c.one(
            sd[prefix + "embeddings.class_embedding"].reshape(-1)),
        "pos_embed": c.one(prefix + "embeddings.position_embedding.weight"),
        "pre_ln": {"scale": c.one(pre + ".weight"),
                   "bias": c.one(pre + ".bias")},
        "layers": {
            "ln1": ln(lay + "layer_norm1"),
            "ln2": ln(lay + "layer_norm2"),
            "attn": {
                "wq": c.lin(lay + "self_attn.q_proj", L, True),
                "wk": c.lin(lay + "self_attn.k_proj", L, True),
                "wv": c.lin(lay + "self_attn.v_proj", L, True),
                "wo": c.lin(lay + "self_attn.out_proj", L, True),
            },
            "mlp": {
                "fc1": c.lin(lay + "mlp.fc1", L, True),
                "fc2": c.lin(lay + "mlp.fc2", L, True),
            },
        },
    }


def convert_ntm(sd: Dict[str, torch.Tensor],
                prefix: str = "model.attention_model.", dtype=torch.float32,
                device=None):
    """The reference's NeuralTuringMachine weights (vstream_arch.py:34-45)
    -> NTMParams on `device` (default: the card)."""
    from ..ops.ntm import NTMParams
    c = _Converter(sd, device, dtype)

    def g(k, transpose=False):
        return c.one(prefix + k, transpose=transpose)

    return NTMParams(
        wq=g("q_proj.weight", True), bq=g("q_proj.bias"),
        wk=g("k_proj.weight", True), bk=g("k_proj.bias"),
        wv=g("v_proj.weight", True), bv=g("v_proj.bias"),
        wo=g("out_proj.weight", True), bo=g("out_proj.bias"),
        ln_scale=g("out_ln.weight"), ln_bias=g("out_ln.bias"))


def convert_projector(sd: Dict[str, torch.Tensor],
                      prefix: str = "model.mm_projector.",
                      dtype=torch.float32, device=None) -> dict:
    """The mm_projector Sequential (Linear[, GELU, Linear ...], or one bare
    Linear) -> {"layers": [{"w", "b"}, ...]} on `device`."""
    c = _Converter(sd, device, dtype)
    if prefix + "weight" in sd:                      # a bare Linear
        return {"layers": [{"w": c.one(prefix + "weight", transpose=True),
                            "b": c.one(prefix + "bias")}]}
    layers = []
    i = 0
    while f"{prefix}{i}.weight" in sd:
        layers.append({"w": c.one(f"{prefix}{i}.weight", transpose=True),
                       "b": c.one(f"{prefix}{i}.bias")})
        i += 2                                       # skip the GELU modules
    if not layers:
        raise KeyError(f"no projector weights under {prefix}")
    return {"layers": layers}


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A torch-serialized state dict (.bin) read on the CPU with
    weights_only=True, every tensor in f32 (as JAX's numpy copy)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def _strip_peft_prefixes(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """base_model.model.model.* / model.model.* -> model.* (builder.py:76-78)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("base_model."):
            k = k[len("base_model."):]
        if k.startswith("model.model."):
            k = k[len("model."):]
        out[k] = v
    return out


def load_llava_checkpoint(model_dir: str, cfg, dtype=torch.float32,
                          device=None) -> dict:
    """A Flash-VStream-LLaVA HF checkpoint directory -> {"vit",
    "projector", "ntm", "llm"} on `device` (default: the card) in `dtype`.
    The reference nests CLIPVisionModel twice
    (model.vision_tower.vision_tower.vision_model.*, clip_encoder.py:28-31);
    the tower is read from under the last 'vision_tower.'."""
    sd = load_safetensors_dir(model_dir)
    vit_sd = {k.rsplit("vision_tower.", 1)[1]: v for k, v in sd.items()
              if "vision_tower." in k}
    if not vit_sd:
        raise FileNotFoundError(
            f"no vision tower weights in {model_dir}; the CLIP tower must be "
            f"in the checkpoint (model.vision_tower.vision_tower.*)")
    kw = dict(dtype=dtype, device=device)
    return {
        "vit": convert_clip_vit(vit_sd, cfg.vit, **kw),
        "projector": convert_projector(sd, **kw),
        "ntm": convert_ntm(sd, **kw),
        "llm": convert_llama(sd, cfg.llm, **kw),
    }


def load_pretrained_model(model_path: str, cfg,
                          model_base: Optional[str] = None,
                          model_name: Optional[str] = None,
                          tokenizer_len: Optional[int] = None,
                          dtype=torch.float32, device=None) -> dict:
    """LLaVA-family loading with the reference's three branches
    (model/builder.py:48-98):

    - LoRA ('lora' in the model name, model_base given): the base weights,
      the token embeddings resized, non_lora_trainables.bin laid over them
      (projector, NTM, embedding rows), then the adapter_model deltas
      merged;
    - projector-only (model_base given): the base weights with
      mm_projector.bin laid over them (the stage-1 pretraining artifact);
    - full: everything from model_path.
    """
    name = (model_name or os.path.basename(model_path.rstrip("/"))).lower()
    kw = dict(dtype=dtype, device=device)
    params = load_llava_checkpoint(model_base or model_path, cfg, **kw)
    if tokenizer_len:
        params["llm"] = resize_token_embeddings(params["llm"], tokenizer_len)
    if model_base is None:
        return params

    def overlay(sd):
        sd = _strip_peft_prefixes(sd)
        if any(k.startswith("model.mm_projector.") for k in sd):
            params["projector"] = convert_projector(sd, **kw)
        if any(k.startswith("model.attention_model.") for k in sd):
            params["ntm"] = convert_ntm(sd, **kw)
        if "model.embed_tokens.weight" in sd:
            embed = params["llm"]["embed"]
            rows = sd["model.embed_tokens.weight"].to(embed.device, dtype)
            params["llm"]["embed"] = (torch.cat([rows, embed[rows.shape[0]:]])
                                      if rows.shape[0] < embed.shape[0]
                                      else rows)
        if "lm_head.weight" in sd:
            params["llm"]["lm_head"] = _Converter(sd, device, dtype).one(
                "lm_head.weight", transpose=True)

    if "lora" in name:
        nlt = os.path.join(model_path, "non_lora_trainables.bin")
        if os.path.exists(nlt):
            overlay(load_torch_bin(nlt))
        adapter_st = os.path.join(model_path, "adapter_model.safetensors")
        adapter_bin = os.path.join(model_path, "adapter_model.bin")
        if os.path.exists(adapter_st):
            adapter = load_file(adapter_st)
        elif os.path.exists(adapter_bin):
            adapter = load_torch_bin(adapter_bin)
        else:
            raise FileNotFoundError(f"no adapter_model under {model_path}")
        acfg = {}
        acfg_path = os.path.join(model_path, "adapter_config.json")
        if os.path.exists(acfg_path):
            with open(acfg_path) as f:
                acfg = json.load(f)
        params["llm"] = apply_lora_adapter(
            params["llm"], adapter, alpha=acfg.get("lora_alpha", 16),
            rank=acfg.get("r", 16))
    else:
        proj = os.path.join(model_path, "mm_projector.bin")
        if not os.path.exists(proj):
            raise FileNotFoundError(
                f"{proj} not found (projector-only load, builder.py:88-95)")
        overlay(load_torch_bin(proj))
    return params


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
