"""LoRA adapters as a separate parameter tree.

Port of flash_vstream_tpu/train/lora.py. Adapters live in their own flat
dict keyed by the adapted weight's path in the base tree ("llm/layers/attn/
wq/w"), each {"a": [..., din, r], "b": [..., r, dout]}. `lora_views` puts a
merge-free `LoRAWeight` at each adapted leaf, which `models.layers.dense`
computes as x @ w + (x @ a) @ b; `merge_lora` materializes w + (alpha/r) a b
for export. The base tree never gets a gradient: its tensors enter the views
detached.

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


def tree_leaves_with_path(tree: dict, prefix: str = ""
                          ) -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a nested dict, keys sorted at every level as
    `jax.tree_util` orders a dict; paths joined by "/"."""
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from tree_leaves_with_path(v, p)
        else:
            yield p, v


def _map_with_path(fn, tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _map_with_path(fn, v, p) if isinstance(v, dict) else fn(p, v)
    return out


def init_lora_params(generator: torch.Generator, params: dict, rank: int,
                     targets: Sequence[str] = DEFAULT_TARGETS,
                     dtype=torch.float32) -> Dict[str, dict]:
    """Adapter tree: for each targeted weight [..., din, dout],
    a [..., din, r] ~ N(0, 1) / sqrt(r) drawn from `generator` on the
    weight's device, and b [..., r, dout] zeros (peft's init; so the
    adapters start as the identity and `a` gets no gradient at step 1)."""
    out = {}
    for path, x in tree_leaves_with_path(params):
        if not isinstance(x, torch.Tensor):
            raise NotImplementedError(
                f"leaf {path!r} is a {type(x).__name__}; LoRA over quantized "
                f"bases is not ported yet: ROADMAP A10-A12")
        if not is_lora_target(path, targets) or x.dim() < 2:
            continue
        *lead, din, dout = x.shape
        a = torch.randn(*lead, din, rank, generator=generator, dtype=dtype,
                        device=x.device) / math.sqrt(rank)
        b = torch.zeros(*lead, rank, dout, dtype=dtype, device=x.device)
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
    bf16 cast, as in JAX)."""
    scale = alpha / rank

    def one(path, x):
        x = x.detach()
        ab = lora.get(path)
        if ab is None:
            return x
        return LoRAWeight(x, ab["a"] * scale, ab["b"])

    return _map_with_path(one, params)


def merge_lora(params: dict, lora: Dict[str, dict], alpha: float,
               rank: int) -> dict:
    """Effective parameters w + (alpha / rank) a @ b at each adapted leaf, in
    the base's dtype (materialized: for export; training uses
    `lora_views`)."""
    scale = alpha / rank

    def one(path, x):
        ab = lora.get(path)
        if ab is None:
            return x
        delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"]) * scale
        return x + delta.to(x.dtype)

    return _map_with_path(one, params)


def merge_lora_into_weights(params: dict, lora: Dict[str, dict],
                            alpha: float, rank: int) -> dict:
    """Merged weights for export (reference merge_lora_weights.py)."""
    with torch.no_grad():
        return merge_lora(params, lora, alpha, rank)
