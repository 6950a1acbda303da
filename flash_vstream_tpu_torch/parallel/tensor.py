"""Tensor-parallel training: the parameter leaves split over a 'tp' group of
ranks, and the regions that stand in for what GSPMD inserts.

There is no JAX module to mirror: JAX lays the leaves out by `LLM_RULES`
(flash_vstream_tpu/parallel/sharding.py:60-76) on a ("dp", "tp") mesh and
GSPMD partitions the unchanged program. Here each rank runs its own graph
(parallel/collectives.py) on its part of each split leaf, a `TPShard`, and
the model functions take the explicit collectives where Megatron puts
them (models/layers.py `dense`, `mha`; models/llm.py `embed_tokens`,
`lm_head`):

- a column split (wq/wk/wv, gate/up, the ViT's fc1, a bare LLM's lm_head:
  the output dim) takes its input through `copy_to` and gives this rank's
  output columns (its local heads);
- a row split (wo, down, fc2: the input dim) multiplies its part of the
  input and sums the ranks' products with `reduce_from`; its bias (whole)
  is added once, after the sum;
- a vocab split (a bare LLM's embed) gathers this rank's rows, zeroes the
  ids outside them and sums with `reduce_from`; a split lm_head's logits
  are gathered whole (`gather_from`), so the cross entropy is unchanged,
  and the chunked cross entropy runs vocab-parallel (models/llm.py
  `nll_sum_chunked`: the max and the sum over tp, the target's logit from
  the rank that holds it).

The regexes are matched as they are: in the LLaVA tree the paths are
"llm/embed" and "llm/lm_head", which `^embed$` and `^lm_head$` do not
match, so there both stay whole. A split rests as JAX's layout: rank r of
tp holds the r-th of tp equal parts of the split dim, even where that cuts
a kv head (tp above the kv heads); `mha` then gathers the head on use over
the ranks that share it, and the gather's backward sums their gradients.

Leaves the rules do not name rest whole on every rank, as in JAX: a LoRA
factor (its path ends in "/a" or "/b") and a quantized base (`QuantWeight`,
`QuantWeight4`: JAX's paths end in ".q", ".q4" and ".scale", which `w$`
does not match). A layer whose bases are all whole runs whole on every
rank. In a layer with a split base (models/layers.py `tp_group`), a whole
quantized base is cut on use to the part its split neighbours would hold
(q's and the scale's columns, or q's rows; an int4 base's whole input
blocks), and a LoRA view's factors are too (b's columns beside a column
base, a's rows beside a row base), each through a copy-to region whose
backward sums the ranks' partial gradients.

Every leaf left whole gets equal gradients on every tp rank (the copy-to
regions all-reduce the gradient of each replicated input), so the Trainer
reduces no whole leaf over tp; a split leaf's gradient is its own part's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..weights.quantize import path_str
from .collectives import Group
from .sharding import (LLM_RULES, PartitionSpec, _fit_mesh, map_with_path,
                       param_pspec)

class TPShard:
    """A tensor-parallel leaf at rest: `shard`, this rank's part of a leaf
    of `shape` split along `dim` over the tp `group`, and its `kind`
    ("column", "row" or "vocab"). `shard` is a tensor, or a `ZeroShard` of
    it at ZeRO stage 3. It is no tensor: the model functions reach it
    through `layer_slice` (`tp_index`) and `dense`, `mha`, the MLPs,
    `embed_tokens` and `lm_head`, which call `local()`."""

    def __init__(self, shard, dim: int, group: Group, shape: Sequence[int],
                 kind: str):
        self.shard, self.dim, self.group, self.kind = shard, dim, group, kind
        self.shape = torch.Size(shape)

    @classmethod
    def split(cls, x: torch.Tensor, dim: int, group: Group,
              kind: str) -> "TPShard":
        n = x.shape[dim] // group.size
        part = x.detach().narrow(dim, group.rank * n, n).clone(
            memory_format=torch.contiguous_format)
        return cls(part.requires_grad_(x.requires_grad), dim, group,
                   x.shape, kind)

    def with_shard(self, shard) -> "TPShard":
        return TPShard(shard, self.dim, self.group, self.shape, self.kind)

    def detach(self) -> "TPShard":
        """The same part, out of any graph (a LoRA view's base)."""
        return self.with_shard(self.shard.detach())

    @property
    def dtype(self):
        return self.shard.dtype

    @property
    def device(self):
        return self.shard.device

    def local(self) -> torch.Tensor:
        """This rank's part as a tensor (a ZeRO-3 shard must have been
        gathered: `zero_use`, or `layer_slice` for a stacked leaf)."""
        if not isinstance(self.shard, torch.Tensor):
            raise TypeError(f"{self!r}: its ZeRO-3 shard is not gathered")
        return self.shard

    def tp_index(self, i) -> "TPShard":
        """Layer `i` (an int) or a run of layers (a slice) of a stacked
        [L, ...] leaf, still split (a ZeRO-3 shard gathered on use, as
        `layer_slice` does)."""
        part = (self.shard.zero_index(i) if hasattr(self.shard, "zero_index")
                else self.shard[i])
        if isinstance(i, slice):
            n = len(range(*i.indices(self.shape[0])))
            return TPShard(part, self.dim, self.group,
                           (n, *self.shape[1:]), self.kind)
        return TPShard(part, self.dim - 1, self.group, self.shape[1:],
                       self.kind)

    def __repr__(self) -> str:
        return (f"TPShard({self.kind}, {tuple(self.shape)}, dim={self.dim}, "
                f"tp={self.group.size})")


def _is_quantized(x) -> bool:
    return hasattr(x, "q") or hasattr(x, "q4")


def _kind(path: str, dim: int, ndim: int) -> str:
    if path.endswith("embed"):
        return "vocab"
    return "column" if dim == ndim - 1 else "row"


def tp_spec(path: str, shape: Sequence[int], mesh,
            rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES
            ) -> Optional[int]:
    """The dim of a leaf that `rules` split over 'tp' on `mesh`, or None."""
    spec = _fit_mesh(param_pspec(path, len(shape), rules), mesh)
    return list(spec).index("tp") if "tp" in spec else None


def tp_shard_tree(tree, mesh,
                  rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES):
    """`tree` with every tensor leaf that `rules` split over 'tp' replaced
    by this rank's `TPShard` of it (`mesh.tp`'s rank). A quantized leaf
    stays whole, as JAX's rules leave it (its paths end in `.q`/`.scale`);
    a dim the tp width does not divide raises ValueError."""
    group = mesh.tp

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        path = path_str(prefix)
        if _is_quantized(tree):
            return tree
        if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
            return type(tree)(walk(v, prefix + (i,))
                              for i, v in enumerate(tree))
        if not isinstance(tree, torch.Tensor):
            return tree
        d = tp_spec(path, tree.shape, mesh, rules)
        if d is None or group.size == 1:
            return tree
        if tree.shape[d] % group.size:
            raise ValueError(f"{path}: dim {d} of {tuple(tree.shape)} does "
                             f"not split over tp {group.size}")
        return TPShard.split(tree, d, group, _kind(path, d, tree.dim()))
    return walk(tree, ())


def tp_gather_tree(tree):
    """A tree of `TPShard`s gathered whole, without a graph (a ZeRO-3
    tree after `zero_gather_tree`); every rank of the tp group calls it."""
    with torch.no_grad():
        return map_with_path(lambda _, x: x.group.all_gather(
            x.local(), x.dim) if isinstance(x, TPShard) else x, tree)


def tp_part(x: torch.Tensor, path: str, mesh,
            rules: Sequence[Tuple[str, PartitionSpec]] = LLM_RULES
            ) -> torch.Tensor:
    """This rank's tp part of a whole leaf (a view; the leaf itself where
    it is not split)."""
    d = tp_spec(path, x.shape, mesh, rules)
    if d is None or mesh.tp.size == 1:
        return x
    n = x.shape[d] // mesh.tp.size
    return x.narrow(d, mesh.tp.rank * n, n)
