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
tensor-parallel decode over the 'tp' axis), the training half the ZeRO
specs (train/trainer.py).

Training runs one process a rank (parallel/collectives.py): `RankMesh` is
this rank's place in the dp x (tp | pp | sp) grid, laid out as JAX's
`devices.reshape(dp, inner)`, rank = d * inner + i, so the tp, pp or sp
groups are contiguous ranks and the dp groups strided. A tensor-parallel
leaf rests as a `parallel.tensor.TPShard`, this rank's part of it along
its 'tp' dim. A ZeRO-3 leaf rests as a `ZeroShard`, this rank's part of it
(of its tp part, where it has one: dp takes the largest free dim not split
over tp, as JAX's rule); under a stacked "layers" subtree it is gathered a
layer at a time where `models.layers.layer_slice` takes the layer out
(`zero_index`), the rest of a tree at a loss's start (`zero_use`).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import default_device
from ..weights.quantize import path_str
from .collectives import DistInfo, Group, gather_on_use, init_distributed


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


def _zero_spec(path, x, mesh, rules) -> PartitionSpec:
    """`zero_shardings`'s spec of one leaf (a tensor, or anything with the
    whole leaf's `shape`)."""
    dp, ndim = mesh.shape["dp"], len(x.shape)
    spec = list(_fit_mesh(param_pspec(path_str(path), ndim, rules), mesh))
    spec += [None] * (ndim - len(spec))
    if dp > 1:
        free = [(d, x.shape[d]) for d in range(ndim)
                if spec[d] is None and x.shape[d] % dp == 0
                and x.shape[d] >= dp]
        if free:
            spec[max(free, key=lambda t: t[1])[0]] = "dp"
    return P(*spec)


def zero_shardings(mesh: Mesh, params,
                   rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES):
    """ZeRO specs: the param spec plus the largest free dim (not split, and
    divisible by dp) split over 'dp'. The optimizer moments' layout at
    ZeRO stage 1/2, and the parameters' own at stage 3."""
    return map_with_path(lambda path, x: _zero_spec(path, x, mesh, rules),
                         params)


def batch_sharding(mesh: Mesh) -> PartitionSpec:
    """A batch split over 'dp' on its leading dim."""
    return P("dp")


def replicated(mesh: Mesh) -> PartitionSpec:
    """Whole on every device of the mesh."""
    return P()


# -- training across ranks ---------------------------------------------------

class RankMesh:
    """This rank's place in a dp x inner grid of ranks (inner: the tp, pp
    or sp width; 1 for data parallelism alone): `dp` and `inner` are its
    groups, `kind` "pp", "sp" or None (the inner axis is 'tp'), `shape`
    {"dp": dp, kind or "tp": inner} as `create_mesh` and
    `create_train_mesh` name the axes; `tp` the tp group (this rank alone
    beside pp or sp)."""

    def __init__(self, info: DistInfo, dp: Group, inner: Group,
                 kind: Optional[str]):
        self.info, self.dp, self.inner, self.kind = info, dp, inner, kind
        self.axis_names = ("dp", kind or "tp")
        self.tp = inner if kind is None else inner.part(1)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp.size, self.axis_names[1]: self.inner.size}

    def __repr__(self) -> str:
        return (f"RankMesh({self.shape}, rank {self.info.rank}: dp "
                f"{self.dp.ranks}, {self.axis_names[1]} {self.inner.ranks})")


def create_rank_mesh(pp: int = 1, sp: int = 1, info: Optional[DistInfo] = None,
                     device=None, tp: int = 1) -> RankMesh:
    """The dp x (tp | pp | sp) grid over the world of ranks (joined
    through `init_distributed(device)` unless `info` is given): dp = world
    / inner. A tp group also makes, for each divisor n of tp between 1 and
    tp, its blocks of n consecutive ranks (`Group.part`: the ranks that
    share a kv head when tp exceeds the kv heads). Every rank makes every
    group, in one order, as torch.distributed requires. tp beside pp or sp
    raises: JAX's `create_train_mesh` has no such mesh."""
    import torch.distributed as dist
    if sum(w > 1 for w in (tp, pp, sp)) > 1:
        raise ValueError(f"pick one of tp/pp/sp per run, got tp {tp}, "
                         f"pp {pp}, sp {sp}")
    info = info or init_distributed(device)
    inner = max(tp, pp, sp)
    kind = "pp" if pp > 1 else "sp" if sp > 1 else None
    if info.world % inner:
        raise ValueError(f"world({info.world}) is not a multiple of "
                         f"{kind or 'tp'}({inner})")
    dp = info.world // inner
    grid = np.arange(info.world).reshape(dp, inner)
    if info.world == 1:
        return RankMesh(info, Group([0]), Group([0]), kind)

    def group(ranks):
        ranks = [int(r) for r in ranks]
        pg = dist.new_group(ranks)
        return Group(ranks, pg, info.backend) if info.rank in ranks else None

    rows = [group(r) for r in grid]
    cols = [group(c) for c in grid.T]
    row = next(g for g in rows if g is not None)
    col = next(g for g in cols if g is not None)
    if kind is None:
        for n in range(2, inner):
            if inner % n:
                continue
            for r in grid:
                for b in range(0, inner, n):
                    g = group(r[b:b + n])
                    if g is not None:
                        row.parts[n] = g
    # this rank's row is its inner group, its column the dp group
    return RankMesh(info, col, row, kind)


def _stacked(path: tuple) -> bool:
    """A leaf of a stacked "layers" subtree (key path `path`), which
    models.layers.layer_slice takes layers out of; "projector/layers/0/w"
    is a list item, and an adapter tree's flat key ("llm/layers/attn/wq/w")
    no "layers" key."""
    return any(k == "layers" and i + 1 < len(path)
               and isinstance(path[i + 1], str)
               for i, k in enumerate(path))


class ZeroShard:
    """A ZeRO-3 leaf at rest: `shard`, this rank's part of a tensor of
    `shape` split along `dim` over the dp `group`. It is no tensor: a model
    function reaches it only through `layer_slice` (`zero_index`: a layer
    gathered on use, or a run of layers kept sharded) or after `zero_use`
    gathered it; the gather's backward reduce-scatters the gradient to
    `shard`, the leaf the optimizer updates."""

    def __init__(self, shard: torch.Tensor, dim: int, group: Group,
                 shape: Sequence[int]):
        self.shard, self.dim, self.group = shard, dim, group
        self.shape = torch.Size(shape)

    @classmethod
    def split(cls, x: torch.Tensor, dim: int, group: Group) -> "ZeroShard":
        n = x.shape[dim] // group.size
        shard = x.detach().narrow(dim, group.rank * n, n).clone(
            memory_format=torch.contiguous_format)
        return cls(shard.requires_grad_(x.requires_grad), dim, group,
                   x.shape)

    @property
    def dtype(self):
        return self.shard.dtype

    @property
    def device(self):
        return self.shard.device

    @property
    def requires_grad(self) -> bool:
        return self.shard.requires_grad

    def whole(self) -> torch.Tensor:
        """The whole tensor, gathered on use (differentiable)."""
        return gather_on_use(self.shard, self.group, self.dim)

    def zero_index(self, i):
        """Layer `i` (an int: gathered) or a run of layers (a slice: still
        sharded) of a stacked [L, ...] leaf."""
        if self.dim == 0:
            return self.whole()[i]
        part = self.shard[i]
        if isinstance(i, slice):
            shape = (part.shape[0], *self.shape[1:])
            return ZeroShard(part, self.dim, self.group, shape)
        return gather_on_use(part, self.group, self.dim - 1)

    def detach(self) -> "ZeroShard":
        return ZeroShard(self.shard.detach(), self.dim, self.group,
                         self.shape)

    def __repr__(self) -> str:
        return (f"ZeroShard({tuple(self.shape)}, dim={self.dim}, "
                f"shard={tuple(self.shard.shape)})")


def _on_zero(x, fn):
    """fn of a `ZeroShard` leaf, or of a `TPShard`'s `ZeroShard` (a TPShard
    of the result); other leaves as they are."""
    from .tensor import TPShard
    if isinstance(x, TPShard) and isinstance(x.shard, ZeroShard):
        return x.with_shard(fn(x.shard))
    return fn(x) if isinstance(x, ZeroShard) else x


def zero_use(tree):
    """The tree a loss computes with: every `ZeroShard` gathered whole
    (differentiably; a `TPShard`'s to its tp part), except those of stacked
    "layers" subtrees, which `layer_slice` gathers a layer at a time."""
    return map_with_path(
        lambda p, x: x if _stacked(p) else _on_zero(x, ZeroShard.whole),
        tree)


def zero_shard_tree(tree, mesh: RankMesh,
                    rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES):
    """`tree` with every leaf that `zero_shardings` splits over 'dp'
    replaced by this rank's `ZeroShard` of it (ZeRO stage 3); a `TPShard`'s
    tp part is what splits, on the dim the whole leaf's spec names."""
    from .tensor import TPShard

    def one(path, x):
        if not isinstance(x, (torch.Tensor, TPShard)):
            return x
        spec = _zero_spec(path, x, mesh, rules)
        if "dp" not in spec:
            return x
        d = list(spec).index("dp")
        if isinstance(x, TPShard):
            return x.with_shard(ZeroShard.split(x.shard, d, mesh.dp))
        return ZeroShard.split(x, d, mesh.dp)
    return map_with_path(one, tree)


def zero_gather_tree(tree):
    """A tree of `ZeroShard`s gathered whole (a `TPShard`'s to its tp
    part), without a graph (for a checkpoint or a caller); every rank of
    the dp group calls it."""
    with torch.no_grad():
        return map_with_path(lambda p, x: _on_zero(x, ZeroShard.whole),
                             tree)

