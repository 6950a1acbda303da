"""Load a parameter tree, or a LoRA adapter tree, of the JAX package into
the port.

The port keeps the JAX tree's names and layouts (stacked [L, ...] layers,
dense weights [din, dout]), so the conversion is the identity on the
flattened key path: every numpy leaf becomes a tensor at the same place.
The caller converts on its side (`jax.tree.map(np.asarray, params)`), so
this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .quantize import QuantWeight, QuantWeight4


def _tensor(v: np.ndarray, device, dtype) -> torch.Tensor:
    if v.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        t = torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(v))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


_QUANT = {("q", "scale"): QuantWeight, ("q4", "scale"): QuantWeight4}


def params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on `device`
    (default: the card; floating leaves cast to `dtype` when given).
    Quantized leaves (JAX `QuantWeight` / `QuantWeight4`, NamedTuples of
    numpy arrays as `jax.tree.map(np.asarray, ...)` leaves them) become the
    port's types with their dtypes kept: int8 / uint8 values and f32 scales,
    whatever `dtype` is. Anything else that is not an array raises (LoRA
    views: `lora_from_numpy` carries an adapter tree)."""
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device, dtype)
        elif tuple(getattr(v, "_fields", ())) in _QUANT:
            out[k] = _QUANT[tuple(v._fields)](
                *(_tensor(np.asarray(f), device, None) for f in v))
        elif isinstance(v, np.ndarray):
            out[k] = _tensor(v, device, dtype)
        else:
            raise NotImplementedError(
                f"leaf {k!r} is a {type(v).__name__}, not an array or a "
                f"quantized weight")
    return out


def lora_from_numpy(lora: dict, device=None, dtype=None) -> dict:
    """A JAX adapter tree ({path: {"a": [.., din, r], "b": [.., r, dout]}},
    train/lora.init_lora_params) as numpy arrays -> the same tree of
    tensors on `device` (default: the card)."""
    device = resolve_device(device)
    return {path: {k: _tensor(np.asarray(ab[k]), device, dtype)
                   for k in ("a", "b")}
            for path, ab in lora.items()}
