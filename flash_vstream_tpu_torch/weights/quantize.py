"""Weight-only int8 and block-scaled int4 quantization of parameter trees.

Port of flash_vstream_tpu/weights/quantize.py:20-131 (the serve-side
analogue of the reference's bitsandbytes load_8bit / load_4bit). Targeted
matmul weights become `QuantWeight` (int8, per-output-channel f32 scales) or
`QuantWeight4` (packed int4, f32 scales per input block and output channel);
`models/layers.dense` dispatches on both.

The int4 layout is the JAX package's, byte for byte, so a tree packed by
JAX loads unchanged: input rows pack split-half (low nibble = row i, high
nibble = row i + din/2) and each nibble stores the biased value q + 8 in
[1, 15]. Both libraries round half to even and divide in f32, so the port
packs the same bytes and scales from the same weights. Stacked [L, din,
dout] leaves are quantized one layer at a time: the f32 intermediates of a
whole 7B MLP leaf would be 7.6 GB each. `enable_w8a8_prefill` (:134) turns
on the int8 x int8 product for prefill-scale int8 matmuls
(`models/layers.dense`).
"""
from __future__ import annotations

import re
from typing import NamedTuple, Sequence

import torch


class QuantWeight(NamedTuple):
    q: torch.Tensor        # int8, the weight's shape
    scale: torch.Tensor    # f32 [..., 1, dout], per output channel


class QuantWeight4(NamedTuple):
    """q4: uint8 [..., din/2, dout], split-half biased nibbles;
    scale: f32 [..., nb, dout], nb input blocks of din/nb rows each."""
    q4: torch.Tensor
    scale: torch.Tensor


DEFAULT_QUANT_TARGETS = (
    r"layers/attn/w[qkvo]/w$",
    r"layers/mlp/(gate|up|down|fc1|fc2)/w$",
    r"^lm_head$", r"/lm_head$",
)


def path_str(path: Sequence) -> str:
    """A key path as the JAX tree names it: keys joined by '/'
    (flash_vstream_tpu/parallel/sharding.py:79)."""
    return "/".join(str(p) for p in path)


def _per_layer(fn, w: torch.Tensor, *args):
    """fn over each [din, dout] matrix of a stacked leaf, results stacked:
    only one layer's f32 intermediates exist at a time."""
    if w.dim() == 2:
        return fn(w, *args)
    parts = [_per_layer(fn, w[i], *args) for i in range(w.shape[0])]
    return type(parts[0])(*(torch.stack(f) for f in zip(*parts)))


def _quantize8(w: torch.Tensor) -> QuantWeight:
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)                 # [1, dout]
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantWeight(q, scale)


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8 over the last (output) axis."""
    return _per_layer(_quantize8, w)


def dequantize_weight(qw: QuantWeight, dtype=torch.float32) -> torch.Tensor:
    """int8 values times their per-channel scales, in f32, cast to dtype."""
    w = qw.q.float()
    return w.mul_(qw.scale).to(dtype)


def _block_size4(din: int, block: int) -> int:
    """Largest EVEN divisor of din <= block (pairs pack within a block)."""
    bs = min(block, din)
    while bs > 2 and (din % bs or bs % 2):
        bs -= 1
    return bs


def _quantize4(w: torch.Tensor, block: int) -> QuantWeight4:
    din, dout = w.shape
    bs = _block_size4(din, block)
    nb = din // bs
    wf = w.float().reshape(nb, bs, dout)
    amax = wf.abs().amax(dim=-2)                                # [nb, dout]
    scale = torch.clamp_min(amax / 7.0, 1e-12)
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7)
    q = (q + 8).reshape(din, dout).to(torch.uint8)              # biased [1, 15]
    half = din // 2
    return QuantWeight4(q[:half] | (q[half:] << 4), scale)


def quantize_weight4(w: torch.Tensor, block: int = 128) -> QuantWeight4:
    """Symmetric int4 ([-7, 7]) over input blocks x output channels."""
    return _per_layer(_quantize4, w, block)


def unpack_weight4(qw: QuantWeight4) -> torch.Tensor:
    """Packed biased nibbles -> int8 [..., din, dout] in [-7, 7] (split-half
    packing makes this a concat, not an interleave)."""
    b = qw.q4
    lo = (b & 0xF).to(torch.int8) - 8
    hi = (b >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-2)


def dequantize_weight4(qw: QuantWeight4, dtype=torch.bfloat16) -> torch.Tensor:
    *lead, nb, dout = qw.scale.shape
    q = unpack_weight4(qw)
    din = q.shape[-2]
    w = q.reshape(*lead, nb, din // nb, dout).float()
    w.mul_(qw.scale[..., :, None, :])          # the f32 copy, scaled in place
    return w.reshape(*lead, din, dout).to(dtype)


def weight_shape(w) -> tuple:
    """A weight's logical [..., din, dout]: a tensor's shape, an int8
    leaf's values', an int4 leaf's with its packed input pairs unpacked."""
    if hasattr(w, "q4"):
        *lead, half, dout = w.q4.shape
        return (*lead, half * 2, dout)
    return tuple(w.q.shape if hasattr(w, "q") else w.shape)


def _map_with_path(tree: dict, fn, prefix=()) -> dict:
    return {k: _map_with_path(v, fn, prefix + (k,)) if isinstance(v, dict)
            else fn(prefix + (k,), v) for k, v in tree.items()}


def _matches(path, targets) -> bool:
    p = path_str(path)
    return any(re.search(t, p) for t in targets)


def quantize_params(params: dict,
                    targets: Sequence[str] = DEFAULT_QUANT_TARGETS) -> dict:
    """Targeted >= 2-D weights of a nested dict become `QuantWeight`; other
    leaves pass through (the same tensors, no copy)."""
    def one(path, x):
        if (isinstance(x, torch.Tensor) and x.dim() >= 2
                and _matches(path, targets)):
            return quantize_weight(x)
        return x
    return _map_with_path(params, one)


def quantize_params4(params: dict,
                     targets: Sequence[str] = DEFAULT_QUANT_TARGETS,
                     block: int = 128) -> dict:
    """4-bit variant of `quantize_params`: targeted >= 2-D weights with an
    even input dim become `QuantWeight4`."""
    def one(path, x):
        if (isinstance(x, torch.Tensor) and x.dim() >= 2
                and x.shape[-2] % 2 == 0 and _matches(path, targets)):
            return quantize_weight4(x, block=block)
        return x
    return _map_with_path(params, one)


def enable_w8a8_prefill(on: bool = True) -> None:
    """Run prefill-scale `QuantWeight` matmuls (>= 128 rows) as int8 x int8
    products with the activations quantized per token on the fly; decode
    rows stay weight-only. Logits drift slightly against weight-only int8,
    so it is off by default. A process-wide switch, read at each call, as
    the JAX flag is read at each trace."""
    from ..models import layers
    layers.W8A8_PREFILL = bool(on)
