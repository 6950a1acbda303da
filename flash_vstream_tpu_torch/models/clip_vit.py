"""CLIP ViT-L/14 vision tower (the LLaVA generation).

Port of flash_vstream_tpu/models/clip_vit.py: the reference's frozen HF
CLIPVisionModel (Flash-VStream-LLaVA/flash_vstream/model/multimodal_encoder/
clip_encoder.py), which returns the hidden state of layer `select_layer`
(default -2) with CLS dropped (clip_encoder.py:31-39). The 14 x 14 patch
conv is one matmul over non-overlapping patches; every frame of a clip goes
through the blocks in one batch, and the attention (non-causal, 257 tokens
of head_dim 64 at full width) goes through the port's `mha`, so on the card
every block launches K1.

Where JAX computes in the images' dtype (f32 from the device preprocess,
whatever the weights' dtype), the images here take the patch embedding's
dtype first, as HF casts pixel values to the tower's dtype: the card's
attention kernel takes bf16 only. For f32 weights the two are the same.
"""
from __future__ import annotations

import torch

from ..core.config import VitConfig
from ..core.device import resolve_device
from .layers import dense, gelu_mlp, init_dense, layer_norm, layer_slice, mha


def init_clip_params(cfg: VitConfig, generator: torch.Generator, device=None,
                     dtype=torch.float32) -> dict:
    """Random parameters with the JAX init's tree, layouts and
    distributions, drawn from `generator` on `device` (default: the card)."""
    device = resolve_device(device)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    P = cfg.patches_per_side ** 2
    pd = cfg.in_channels * cfg.patch_size ** 2
    kw = dict(dtype=dtype, device=device)

    def stacked(din, dout):
        return init_dense(generator, din, dout, bias=True, layers=L, **kw)

    def ln(*shape):
        return {"scale": torch.ones(shape, **kw),
                "bias": torch.zeros(shape, **kw)}

    return {
        "patch_embed": {"w": torch.randn(pd, D, generator=generator,
                                         **kw).mul_(0.02)},
        "class_embed": torch.randn(D, generator=generator, **kw).mul_(0.02),
        "pos_embed": torch.randn(P + 1, D, generator=generator,
                                 **kw).mul_(0.02),
        "pre_ln": ln(D),
        "layers": {
            "ln1": ln(L, D), "ln2": ln(L, D),
            "attn": {"wq": stacked(D, D), "wk": stacked(D, D),
                     "wv": stacked(D, D), "wo": stacked(D, D)},
            "mlp": {"fc1": stacked(D, I), "fc2": stacked(I, D)},
        },
    }


def patchify_images(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, (H/ps)*(W/ps), C*ps*ps], patches in row-major
    order, each flattened as a conv kernel (C, ps, ps) so HF conv weights
    transfer directly."""
    N, C, H, W = images.shape
    ph, pw = H // patch_size, W // patch_size
    x = images.reshape(N, C, ph, patch_size, pw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)          # [N, ph, pw, C, ps, ps]
    return x.reshape(N, ph * pw, C * patch_size * patch_size)


def clip_layers_run(cfg: VitConfig) -> int:
    """Blocks run up to the selected hidden state: num_layers +
    select_layer + 1 for a negative select_layer (23 of ViT-L/14's 24)."""
    return (cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0
            else cfg.select_layer)


def clip_encode(params: dict, cfg: VitConfig,
                images: torch.Tensor) -> torch.Tensor:
    """Images [N, C, H, W] -> patch features [N, P, D] of the select_layer
    hidden state, CLS dropped."""
    N = images.shape[0]
    D = cfg.hidden_size
    wdtype = getattr(params["patch_embed"]["w"], "dtype", torch.bfloat16)
    patches = patchify_images(images.to(wdtype), cfg.patch_size)
    x = dense(patches, params["patch_embed"]["w"])            # [N, P, D]
    cls = params["class_embed"].to(x.dtype).expand(N, 1, D)
    x = torch.cat([cls, x], dim=1)                            # [N, 1+P, D]
    x = x + params["pos_embed"].to(x.dtype)[None]
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                   cfg.layer_norm_eps)
    for i in range(clip_layers_run(cfg)):
        lp = layer_slice(params["layers"], i)
        h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                       cfg.layer_norm_eps)
        x = x + mha(lp["attn"], h, num_heads=cfg.num_heads,
                    num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim)
        h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                       cfg.layer_norm_eps)
        x = x + gelu_mlp(lp["mlp"], h, cfg.hidden_act)
    return x[:, 1:]                                           # drop CLS

