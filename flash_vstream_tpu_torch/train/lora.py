"""LoRA adapters as a separate parameter tree.

Port of flash_vstream_tpu/train/lora.py. Adapters live in their own flat
dict keyed by the adapted weight's path in the base tree ("llm/layers/attn/
wq/w"), each {"a": [..., din, r], "b": [..., r, dout]}. `lora_views` puts a
merge-free `LoRAWeight` at each adapted leaf, which `models.layers.dense`
computes as x @ w + (x @ a) @ b; `merge_lora` materializes w + (alpha/r) a b
for export. The base tree never gets a gradient: its tensors enter the views
detached. The base may be quantized (QLoRA): a `QuantWeight` or
`QuantWeight4` is one leaf, adapted by its logical [din, dout] shape, and
`merge_lora` dequantizes it before merging.

Reference: peft LoRA over all LLM projections + visual.merger.mlp
(Flash-VStream-Qwen/finetune_flash.py:544-578).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterator, NamedTuple, Sequence, Tuple

import torch

# default targets: every attention/MLP projection of the DECODER only,
# anchored so "vit/layers/attn/..." never matches (the reference excludes the
# vision tower from LoRA)
DEFAULT_TARGETS = (
    r"^(llm/)?layers/attn/w[qkvo]/w$",
    r"^(llm/)?layers/mlp/(gate|up|down)/w$",
)
QWEN_TARGETS = DEFAULT_TARGETS + (r"merger/fc[12]/w$",)


def is_lora_target(path: str, targets: Sequence[str]) -> bool:
    return any(re.search(t, path) for t in targets)


def _is_quantized(x) -> bool:
    return hasattr(x, "q") or hasattr(x, "q4")


def tree_leaves_with_path(tree, prefix: str = ""
                          ) -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a parameter tree in `jax.tree_util` order and with
    its path spelling: dict keys sorted, list and tuple items by index,
    NamedTuple fields in order as ".name"; "/" joins the parts. A quantized
    leaf (`QuantWeight`, `QuantWeight4`) is one leaf."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], join(k))
    elif _is_quantized(tree):
        yield prefix, tree
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tree_leaves_with_path(getattr(tree, k), join(f".{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, join(i))
    else:
        yield prefix, tree


def _map_with_path(fn, tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _map_with_path(fn, v, p) if isinstance(v, dict) else fn(p, v)
    return out


def _weight_shape(x) -> tuple:
    """A leaf's logical shape: an int4 leaf packs input pairs into a byte."""
    if hasattr(x, "q4"):
        *lead, half, dout = x.q4.shape
        return (*lead, half * 2, dout)
    return tuple(x.q.shape if hasattr(x, "q") else x.shape)


def _detach(x):
    if hasattr(x, "_fields"):            # a quantized leaf: every field
        return type(x)(*(f.detach() for f in x))
    return x.detach()


def init_lora_params(generator: torch.Generator, params: dict, rank: int,
                     targets: Sequence[str] = DEFAULT_TARGETS,
                     dtype=torch.float32) -> Dict[str, dict]:
    """Adapter tree: for each targeted weight of logical shape [..., din,
    dout] (a tensor or a quantized leaf), a [..., din, r] ~ N(0, 1) /
    sqrt(r) drawn from `generator` on the weight's device, and b [..., r,
    dout] zeros (peft's init; so the adapters start as the identity and `a`
    gets no gradient at step 1)."""
    out = {}
    for path, x in tree_leaves_with_path(params):
        shape = _weight_shape(x)
        if not is_lora_target(path, targets) or len(shape) < 2:
            continue
        *lead, din, dout = shape
        device = x[0].device if hasattr(x, "_fields") else x.device
        a = torch.randn(*lead, din, rank, generator=generator, dtype=dtype,
                        device=device) / math.sqrt(rank)
        b = torch.zeros(*lead, rank, dout, dtype=dtype, device=device)
        out[path] = {"a": a, "b": b}
    return out


class LoRAWeight(NamedTuple):
    """(w, a, b) view that `models.layers.dense` computes as
    x @ w + (x @ a) @ b without materializing w + (alpha/r) a @ b; the
    alpha/r scale is folded into `a`. Every field keeps the stacked [L, ...]
    leading axis, so `layers.layer_slice` slices it like a plain weight. It
    has no `dtype`, as the JAX NamedTuple has none (the patch merger then
    runs in bf16, as in JAX)."""
    w: torch.Tensor
    a: torch.Tensor       # pre-scaled by alpha / rank
    b: torch.Tensor


def lora_views(params: dict, lora: Dict[str, dict], alpha: float,
               rank: int) -> dict:
    """The base tree with a `LoRAWeight` at each adapted leaf. Base tensors
    enter detached (JAX's stop_gradient), so no base gradient is ever built;
    `a` is scaled by alpha / rank in its own dtype (after the trainer's f32 ->
    bf16 cast, as in JAX). A quantized leaf is wrapped as it is: `dense`
    multiplies by it without a gradient to it."""
    scale = alpha / rank

    def one(path, x):
        x = _detach(x)
        ab = lora.get(path)
        if ab is None:
            return x
        return LoRAWeight(x, ab["a"] * scale, ab["b"])

    return _map_with_path(one, params)


def merge_lora(params: dict, lora: Dict[str, dict], alpha: float,
               rank: int) -> dict:
    """Effective parameters w + (alpha / rank) a @ b at each adapted leaf, in
    the base's dtype (materialized: for export; training uses
    `lora_views`). A quantized leaf is dequantized to the adapters' dtype
    first (QLoRA export), so it merges into that dtype."""
    from ..weights.quantize import dequantize_weight, dequantize_weight4
    scale = alpha / rank

    def one(path, x):
        ab = lora.get(path)
        if ab is None:
            return x
        if hasattr(x, "q") or hasattr(x, "q4"):
            # a fresh f32 copy: the delta goes in in place, so a 7B leaf
            # holds one [L, din, dout] copy, not three
            x = (dequantize_weight if hasattr(x, "q") else
                 dequantize_weight4)(x, dtype=ab["a"].dtype)
            mm = x.baddbmm_ if x.dim() == 3 else x.addmm_
            return mm(ab["a"], ab["b"], alpha=scale)
        delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"]) * scale
        return x + delta.to(x.dtype)

    return _map_with_path(one, params)


def merge_lora_into_weights(params: dict, lora: Dict[str, dict],
                            alpha: float, rank: int) -> dict:
    """Merged weights for export (reference merge_lora_weights.py)."""
    with torch.no_grad():
        return merge_lora(params, lora, alpha, rank)
