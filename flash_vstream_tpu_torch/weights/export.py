"""The port's parameter trees -> HF-format state dicts and checkpoint
directories (the inverse of weights/convert.py), both families.

Port of flash_vstream_tpu/weights/export.py. The state dicts hold views of
the tree's tensors (transposes, layer slices) on their device, so
exporting copies nothing (the Qwen ViT's packed qkv aside);
`save_hf_checkpoint` copies one tensor at a time to the host as it writes.
`hf_qwen_config` writes the config.json that `qwen_config_from_hf` reads
back; `export_llava_checkpoint` lays a LLaVA tree out as the reference's
checkpoint (the CLIP tower under model.vision_tower.vision_tower.).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from ..core.config import LLMConfig, VitConfig, VStreamQwenConfig
from .safetensors_io import save_file


def export_llama(params: dict, cfg: LLMConfig,
                 prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """models/llm.py tree -> HF Llama/Qwen2 state dict."""
    sd: Dict[str, torch.Tensor] = {prefix + "embed_tokens.weight":
                                   params["embed"]}
    lay = params["layers"]
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}."
        sd[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        sd[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        for name, key in (("q_proj", "wq"), ("k_proj", "wk"),
                          ("v_proj", "wv"), ("o_proj", "wo")):
            sd[p + f"self_attn.{name}.weight"] = lay["attn"][key]["w"][i].T
            if "b" in lay["attn"][key]:
                sd[p + f"self_attn.{name}.bias"] = lay["attn"][key]["b"][i]
        for name, key in (("gate_proj", "gate"), ("up_proj", "up"),
                          ("down_proj", "down")):
            sd[p + f"mlp.{name}.weight"] = lay["mlp"][key]["w"][i].T
    sd[prefix + "norm.weight"] = params["final_norm"]
    if "lm_head" in params:
        sd["lm_head.weight"] = params["lm_head"].T
    return sd


def export_qwen_vit(params: dict, cfg: VitConfig,
                    prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """models/qwen2_vit.py tree -> HF Qwen2-VL vision state dict (q, k and
    v packed into one qkv Linear: the only tensors made anew)."""
    D = cfg.hidden_size
    pw = params["patch_embed"]["w"].T               # [D, C*tp*ps*ps]
    sd: Dict[str, torch.Tensor] = {
        prefix + "patch_embed.proj.weight": pw.reshape(
            D, cfg.in_channels, cfg.temporal_patch_size, cfg.patch_size,
            cfg.patch_size)}
    lay = params["layers"]
    for i in range(cfg.num_layers):
        p = f"{prefix}blocks.{i}."
        for ln, key in (("norm1", "ln1"), ("norm2", "ln2")):
            sd[p + f"{ln}.weight"] = lay[key]["scale"][i]
            sd[p + f"{ln}.bias"] = lay[key]["bias"][i]
        a = lay["attn"]
        sd[p + "attn.qkv.weight"] = torch.cat(
            [a[k]["w"][i].T for k in ("wq", "wk", "wv")])
        sd[p + "attn.qkv.bias"] = torch.cat(
            [a[k]["b"][i] for k in ("wq", "wk", "wv")])
        sd[p + "attn.proj.weight"] = a["wo"]["w"][i].T
        sd[p + "attn.proj.bias"] = a["wo"]["b"][i]
        for fc in ("fc1", "fc2"):
            sd[p + f"mlp.{fc}.weight"] = lay["mlp"][fc]["w"][i].T
            sd[p + f"mlp.{fc}.bias"] = lay["mlp"][fc]["b"][i]
    m = params["merger"]
    sd[prefix + "merger.ln_q.weight"] = m["ln_q"]["scale"]
    sd[prefix + "merger.ln_q.bias"] = m["ln_q"]["bias"]
    sd[prefix + "merger.mlp.0.weight"] = m["fc1"]["w"].T
    sd[prefix + "merger.mlp.0.bias"] = m["fc1"]["b"]
    sd[prefix + "merger.mlp.2.weight"] = m["fc2"]["w"].T
    sd[prefix + "merger.mlp.2.bias"] = m["fc2"]["b"]
    return sd


def export_clip_vit(params: dict, cfg: VitConfig,
                    prefix: str = "vision_model."
                    ) -> Dict[str, torch.Tensor]:
    """models/clip_vit.py tree -> HF CLIPVisionModel state dict."""
    D = cfg.hidden_size
    pw = params["patch_embed"]["w"].T                # [D, C*ps*ps]
    sd: Dict[str, torch.Tensor] = {
        prefix + "embeddings.patch_embedding.weight": pw.reshape(
            D, cfg.in_channels, cfg.patch_size, cfg.patch_size),
        prefix + "embeddings.class_embedding": params["class_embed"],
        prefix + "embeddings.position_embedding.weight": params["pos_embed"],
        prefix + "pre_layrnorm.weight": params["pre_ln"]["scale"],
        prefix + "pre_layrnorm.bias": params["pre_ln"]["bias"],
    }
    lay = params["layers"]
    for i in range(cfg.num_layers):
        p = f"{prefix}encoder.layers.{i}."
        for ln, key in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            sd[p + f"{ln}.weight"] = lay[key]["scale"][i]
            sd[p + f"{ln}.bias"] = lay[key]["bias"][i]
        for name, key in (("q_proj", "wq"), ("k_proj", "wk"),
                          ("v_proj", "wv"), ("out_proj", "wo")):
            sd[p + f"self_attn.{name}.weight"] = lay["attn"][key]["w"][i].T
            sd[p + f"self_attn.{name}.bias"] = lay["attn"][key]["b"][i]
        for fc in ("fc1", "fc2"):
            sd[p + f"mlp.{fc}.weight"] = lay["mlp"][fc]["w"][i].T
            sd[p + f"mlp.{fc}.bias"] = lay["mlp"][fc]["b"][i]
    return sd


def export_projector(params: dict, prefix: str = "model.mm_projector."
                     ) -> Dict[str, torch.Tensor]:
    """projector tree -> the mm_projector Sequential's state dict (one bare
    Linear for a single layer; the GELUs hold no weights)."""
    layers = params["layers"]
    if len(layers) == 1:
        return {prefix + "weight": layers[0]["w"].T,
                prefix + "bias": layers[0]["b"]}
    sd: Dict[str, torch.Tensor] = {}
    for j, lp in enumerate(layers):
        sd[f"{prefix}{2 * j}.weight"] = lp["w"].T
        sd[f"{prefix}{2 * j}.bias"] = lp["b"]
    return sd


def export_ntm(ntm, prefix: str = "model.attention_model."
               ) -> Dict[str, torch.Tensor]:
    """NTMParams -> the reference's NeuralTuringMachine state dict
    (vstream_arch.py:34-45)."""
    sd = {}
    for name, w, b in (("q_proj", ntm.wq, ntm.bq), ("k_proj", ntm.wk, ntm.bk),
                       ("v_proj", ntm.wv, ntm.bv),
                       ("out_proj", ntm.wo, ntm.bo)):
        sd[prefix + name + ".weight"] = w.T
        sd[prefix + name + ".bias"] = b
    sd[prefix + "out_ln.weight"] = ntm.ln_scale
    sd[prefix + "out_ln.bias"] = ntm.ln_bias
    return sd


def export_llava_checkpoint(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """A whole Flash-VStream-LLaVA state dict in the reference's layout (the
    CLIP tower under model.vision_tower.vision_tower.vision_model.)."""
    sd = export_llama(params["llm"], cfg.llm)
    sd.update(export_clip_vit(
        params["vit"], cfg.vit,
        prefix="model.vision_tower.vision_tower.vision_model."))
    sd.update(export_projector(params["projector"]))
    sd.update(export_ntm(params["ntm"]))
    return sd


def hf_qwen_config(cfg: VStreamQwenConfig) -> dict:
    """config.json of a Qwen2-VL checkpoint for `cfg`, in the flat layout
    of transformers' Qwen2VLConfig; `qwen_config_from_hf` reads it back to
    `cfg` (all but `max_seq_len`, which no config.json carries). A Flash
    memory other than the default goes under
    `vision_config.flash_memory_config`."""
    v, t = cfg.vit, cfg.llm
    vision = {"depth": v.num_layers, "embed_dim": v.hidden_size,
              "hidden_size": v.merger_out_dim,
              "mlp_ratio": v.intermediate_size / v.hidden_size,
              "num_heads": v.num_heads, "in_channels": v.in_channels,
              "patch_size": v.patch_size,
              "spatial_merge_size": v.spatial_merge_size,
              "temporal_patch_size": v.temporal_patch_size}
    if cfg.flash_memory != type(cfg.flash_memory)():
        vision["flash_memory_config"] = cfg.flash_memory.to_dict()
    return {
        "architectures": ["Qwen2VLForConditionalGeneration"],
        "model_type": "qwen2_vl",
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_layers,
        "num_attention_heads": t.num_heads,
        "num_key_value_heads": t.num_kv_heads,
        "max_position_embeddings": t.max_position_embeddings,
        "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
        "tie_word_embeddings": t.tie_word_embeddings,
        "rope_scaling": {"type": "mrope",
                         "mrope_section": list(t.mrope_sections)},
        "hidden_act": "silu", "torch_dtype": "bfloat16",
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_config": vision,
    }


def save_hf_checkpoint(path: str, sd: Dict[str, torch.Tensor],
                       config: Optional[dict] = None,
                       max_shard_bytes: Optional[int] = None) -> list:
    """Write `sd` into `path` as `model.safetensors`, or, when it exceeds
    `max_shard_bytes`, as `model-0000i-of-0000n.safetensors` shards (in
    key order, none over the limit unless one tensor is) with
    `model.safetensors.index.json`; `config` (a dict) as config.json.
    Returns the shard file names."""
    os.makedirs(path, exist_ok=True)
    shards, cur, size = [], [], 0
    for k in sorted(sd):
        n = sd[k].numel() * sd[k].element_size()
        if max_shard_bytes and cur and size + n > max_shard_bytes:
            shards.append(cur)
            cur, size = [], 0
        cur.append(k)
        size += n
    shards.append(cur)
    names = (["model.safetensors"] if len(shards) == 1 else
             [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
              for i in range(len(shards))])
    weight_map, total = {}, 0
    for name, keys in zip(names, shards):
        # transformers refuses a safetensors shard without this metadata
        save_file({k: sd[k] for k in keys}, os.path.join(path, name),
                  metadata={"format": "pt"})
        total += sum(sd[k].numel() * sd[k].element_size() for k in keys)
        weight_map.update({k: name for k in keys})
    if len(shards) > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
    return names
