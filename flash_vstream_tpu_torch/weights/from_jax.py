"""Load a parameter tree of the JAX package into the port.

The port keeps the JAX tree's names and layouts (stacked [L, ...] layers,
dense weights [din, dout]), so the conversion is the identity on the
flattened key path: every numpy leaf becomes a tensor at the same place.
The caller converts on its side (`jax.tree.map(np.asarray, params)`), so
this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on `device`
    (floating leaves cast to `dtype` when given). Raises on quantized or
    LoRA leaves (QuantWeight, QuantWeight4, LoRAWeight), which the port does
    not run yet (ROADMAP A10-A12)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device, dtype)
            continue
        if not isinstance(v, np.ndarray):
            raise NotImplementedError(
                f"leaf {k!r} is a {type(v).__name__}; quantized and LoRA "
                f"weights are not ported yet: ROADMAP A10-A12")
        if v.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
            t = torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(v))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out
