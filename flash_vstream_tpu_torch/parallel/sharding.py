"""Meshes and the sharding rules of parameter trees.

Port of flash_vstream_tpu/parallel/sharding.py:1-148. A mesh is a grid of
torch devices with axis names, as JAX's `Mesh` is a grid of its devices;
its entries may repeat (several shards on one card), and with `devices`
None it is the visible cards, `cuda:0..n-1` (no card raises, as
core/device.py does; the CPU is used only when the caller passes CPU
devices). A `PartitionSpec` names, for each dim of a leaf, the mesh axis
that dim is split over (None: whole on every device).

The rules are a regex on the leaf's '/'-joined key path -> a spec, applied
to the stacked parameter trees of models/*: pure functions of paths and
shapes. The serving half of the port applies them (parallel/inference.py:
tensor-parallel decode over the 'tp' axis); the ZeRO and batch specs wait
for the training half (ROADMAP A16).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import default_device
from ..weights.quantize import path_str


class PartitionSpec(tuple):
    """Per-dim mesh axis names (None: that dim is not split); dims past its
    length are not split either."""

    def __new__(cls, *axes: Optional[str]):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _device(d) -> torch.device:
    """`d` as a torch.device, a bare "cuda" as the current card's index (so
    that equal devices compare equal)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> list:
    """The visible cards, cuda:0..n-1; raises without one."""
    default_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A grid of devices (`devices`, an object array shaped by the axes)
    with one name per axis; `shape` maps each name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid takes "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def _grid(devices, rows: int, cols: int) -> np.ndarray:
    arr = np.empty(rows * cols, dtype=object)
    arr[:] = [_device(d) for d in devices[:rows * cols]]
    return arr.reshape(rows, cols)


def create_mesh(dp: Optional[int] = None, tp: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, tp) mesh over the first dp * tp of `devices` (default: the
    visible cards); dp defaults to as many rows as the devices fill."""
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp > n or dp < 1 or tp < 1:
        raise ValueError(f"dp({dp}) * tp({tp}) > devices({n})")
    return Mesh(_grid(devices, dp, tp), ("dp", "tp"))


def create_train_mesh(dp: Optional[int] = None, pp: int = 1, sp: int = 1,
                      devices: Optional[Sequence] = None) -> Mesh:
    """dp x (pp | sp) training mesh: the pp or sp groups are contiguous
    device ranges (the minor axis), dp the outer axis."""
    if pp > 1 and sp > 1:
        raise ValueError("pick one of pp/sp per run")
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    inner = max(pp, sp)
    name = "pp" if pp > 1 else "sp" if sp > 1 else "tp"
    if dp is None:
        dp = n // inner
    if dp * inner > n or dp < 1:
        raise ValueError(f"dp({dp}) x {name}({inner}) > devices({n})")
    return Mesh(_grid(devices, dp, inner), ("dp", name))


# (regex on the '/'-joined path, spec); specs name only the split dims
LLM_RULES: Sequence[Tuple[str, PartitionSpec]] = (
    # stacked layer weights: [L, din, dout]
    (r"layers/attn/w[qkv]/w$", P(None, None, "tp")),
    (r"layers/attn/w[qkv]/b$", P(None, "tp")),
    (r"layers/attn/wo/w$", P(None, "tp", None)),
    (r"layers/mlp/(gate|up)/w$", P(None, None, "tp")),
    (r"layers/mlp/down/w$", P(None, "tp", None)),
    (r"^embed$", P("tp", None)),
    (r"^lm_head$", P(None, "tp")),
    # the ViT (the same block structure under vit/)
    (r"vit/layers/attn/w[qkv]/w$", P(None, None, "tp")),
    (r"vit/layers/attn/w[qkv]/b$", P(None, "tp")),
    (r"vit/layers/attn/wo/w$", P(None, "tp", None)),
    (r"vit/layers/mlp/fc1/w$", P(None, None, "tp")),
    (r"vit/layers/mlp/fc1/b$", P(None, "tp")),
    (r"vit/layers/mlp/fc2/w$", P(None, "tp", None)),
)


def param_pspec(path: str, ndim: int,
                rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES
                ) -> PartitionSpec:
    """The first rule matching `path` whose spec fits `ndim` dims, else
    P() (whole on every device)."""
    for pat, spec in rules:
        if re.search(pat, path) and len(spec) <= ndim:
            return spec
    return P()


def _fit_mesh(spec: PartitionSpec, mesh: Mesh) -> PartitionSpec:
    """Drop spec axes the mesh does not have (the 'tp' rules on a dp x pp
    training mesh): a missing axis means that dim is not split."""
    return P(*(a if a in mesh.axis_names else None for a in spec))


def map_with_path(fn, tree, prefix=()):
    """fn(path, leaf) over a parameter tree with JAX's key paths: dict keys,
    list items by index and NamedTuple fields (a quantized weight's too) as
    ".name", so `path_str` spells a quantized leaf's field
    ".../wq/w/.q4", as `jax.tree_util` does."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, k),
                                          prefix + (f".{k}",))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def param_shardings(mesh: Mesh, params,
                    rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES):
    """The spec of every leaf, fitted to the mesh, in the tree's shape."""
    return map_with_path(
        lambda path, x: _fit_mesh(param_pspec(path_str(path), x.dim(), rules),
                                  mesh), params)


def zero_shardings(mesh: Mesh, params,
                   rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES):
    """ZeRO specs: the param spec plus the largest free dim (not split, and
    divisible by dp) split over 'dp'. The optimizer moments' layout at
    ZeRO stage 1/2, and the parameters' own at stage 3."""
    dp = mesh.shape["dp"]

    def one(path, x):
        spec = list(_fit_mesh(param_pspec(path_str(path), x.dim(), rules),
                              mesh))
        spec += [None] * (x.dim() - len(spec))
        if dp > 1:
            free = [(d, x.shape[d]) for d in range(x.dim())
                    if spec[d] is None and x.shape[d] % dp == 0
                    and x.shape[d] >= dp]
            if free:
                spec[max(free, key=lambda t: t[1])[0]] = "dp"
        return P(*spec)
    return map_with_path(one, params)


def batch_sharding(mesh: Mesh) -> PartitionSpec:
    """A batch split over 'dp' on its leading dim."""
    return P("dp")


def replicated(mesh: Mesh) -> PartitionSpec:
    """Whole on every device of the mesh."""
    return P()
