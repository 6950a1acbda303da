"""Vision -> LLM projector.

Port of flash_vstream_tpu/models/projector.py, the reference's
build_vision_projector (Flash-VStream-LLaVA/flash_vstream/model/
multimodal_projector/builder.py:35-51): 'linear', 'mlp{N}x_gelu' (the full
config's mlp2x_gelu) or 'identity'.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from ..core.config import ProjectorConfig
from ..core.device import resolve_device
from .layers import dense, init_dense


def _depth(cfg: ProjectorConfig) -> int:
    """Linear layers of the projector (0 for identity)."""
    if cfg.projector_type == "identity":
        return 0
    if cfg.projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", cfg.projector_type)
    if not m:
        raise ValueError(f"unknown projector type {cfg.projector_type}")
    return int(m.group(1))


def init_projector_params(cfg: ProjectorConfig, generator: torch.Generator,
                          device=None, dtype=torch.float32) -> dict:
    """{"layers": [{"w", "b"}, ...]} (empty for identity) with the JAX
    init's distributions, drawn from `generator` on `device`."""
    device = resolve_device(device)
    depth = _depth(cfg)
    if depth == 0:
        return {}
    din, dout = cfg.effective_input_dim, cfg.output_dim
    kw = dict(bias=True, dtype=dtype, device=device)
    return {"layers": [init_dense(generator, din if i == 0 else dout, dout,
                                  **kw) for i in range(depth)]}


def project(params: dict, cfg: ProjectorConfig,
            x: torch.Tensor) -> torch.Tensor:
    """x [..., din] -> [..., dout]: Linear, then (GELU, Linear) per further
    layer, in the first weight's dtype where x is f32 (the STAR memory is
    f32; JAX casts it so its products run at the weights' rate)."""
    _depth(cfg)
    if cfg.projector_type == "identity":
        return x
    layers = params["layers"]
    if x.dtype == torch.float32:
        x = x.to(getattr(layers[0]["w"], "dtype", torch.bfloat16))
    out = dense(x, layers[0]["w"], layers[0]["b"])
    for lp in layers[1:]:
        out = dense(F.gelu(out), lp["w"], lp["b"])
    return out
