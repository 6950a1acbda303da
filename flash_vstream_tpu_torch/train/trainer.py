"""Trainer: gradient accumulation, global-norm clipping, AdamW with warmup
+ cosine decay, parameter groups, checkpointable state, and data
parallelism with ZeRO stages 1, 2 and 3 and Adam moments offloaded to the
host.

Port of flash_vstream_tpu/train/trainer.py. The optimizer is written out
rather than taken from torch.optim, because the JAX trainer's optax chain
has semantics the stock classes do not share:

- the learning rate of optimizer step n is the schedule at n, the count
  before the increment, so the first step runs at lr 0 (reporting.lr_at);
- clip_by_global_norm scales by max_norm / norm only when norm >= max_norm,
  with no epsilon (clip_grad_norm_ adds 1e-6);
- Adam's bias correction uses the incremented count, eps sits outside the
  square root, and weight decay is added to the update before the learning
  rate scales it (optax.adamw);
- each label group ("train", "projector", "frozen") has its own chain, so the
  global norm is taken over a group's leaves; "frozen" leaves never move;
- a bf16 tree rounds as optax's does: a Python constant (b1, b2, eps, the
  step size) takes the array's dtype before the op (JAX's weak typing), and
  the global norm sums each leaf's squares in f32, rounds that sum to the
  leaf's dtype and adds the leaves' sums in it (a leaf split over ranks
  sums its parts in f32 first).

Gradient accumulation takes the mean of the micro-batch gradients, each
divided by accum and summed in place, as the JAX scan adds g / accum to its
accumulator. Only leaves that train get gradients: optax's set_to_zero never
reads a frozen leaf's, and the JAX step's dead gradient work is dropped by
XLA, where autograd would run it (the dW of every frozen matrix). The
update runs in place, a slice of at most 2**26 elements at a time along
the leading axis (a stacked [L, ...] leaf one or more layers at a time), so
its temporaries stay small beside a 7B model's parameters, gradients and
moments; the arithmetic is elementwise, so slicing changes no value but
the order of a leaf's f32 sum of squares. A
parameter tree may hold dicts, lists and NamedTuples (the LLaVA tree's
projector layers and NTM parameters), walked in JAX's order; quantized
leaves are frozen.

Across ranks (one process a rank, `parallel.sharding.RankMesh`): each rank
runs its share of the step's global batch, and the gradients are averaged
over dp, which is JAX's mean over the global batch of bsz x dp. A leaf's
ZeRO dim is the one `zero_shardings` picks (none: the leaf and its moments
stay whole on every rank, its gradient all-reduced). Stages 1 and 2 keep
the parameters whole and the Adam moments only for this rank's shard: the
gradient is all-reduced (1) or reduce-scattered (2) to the shard, the rank
updates its shard and the parameters are all-gathered. Stage 3 rests the
parameters and the `frozen` tree sharded too (`ZeroShard`): a layer's
weights are gathered on use and freed after, their gradients
reduce-scattered in the backward. With a pp or sp group, every gradient is
first summed over it (a pipeline stage's gradients are zero outside what
it ran). `offload_moments` rests mu and nu in pinned host memory between
steps (on the CPU they stay put, as JAX's host kind equals its device
kind there); the sliced update streams a slice's moments to the device and
back, so they are never whole on the card. A checkpoint holds the whole,
gathered state (`gathered_state`), and `load_state` takes a whole state at
any world size.

With a tp group (a dp x tp `RankMesh`), `params` and `frozen` split by
`LLM_RULES` over it (`parallel.tensor.TPShard`; the model functions run
this rank's part, parallel/tensor.py) before ZeRO splits each tp part over
dp, so at stage 3 a rank holds 1/(dp x tp) of a split leaf, and the
moments of stages 1-2 take dp's part of the tp part. A split leaf's
gradient is its own part's; a whole leaf's is equal on every tp rank (the
copy-to regions all-reduce what flows into a replicated input), so no
gradient is reduced over tp. The global norm sums a split leaf's squares
in f32 over tp (and over dp where ZeRO splits it) before the rounding; a
whole leaf is counted once. A checkpoint gathers over dp, then over tp,
and `load_state` splits a whole state at any dp x tp. LoRA factors and
quantized bases rest whole, as JAX's rules leave them; a factor of a split
base is cut on use through a copy-to region, so its gradient is summed
over tp there and is whole and equal on every rank like any whole leaf's
(parallel/tensor.py).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Sequence

import torch

from .lora import tree_leaves_with_path
from .reporting import lr_at


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 2e-5
    projector_lr: Optional[float] = None      # mm_projector_lr analog
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    grad_accum: int = 1
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # regexes of parameter paths to train; None = train everything
    trainable: Optional[Sequence[str]] = None
    # regexes of parameter paths to freeze (applied after trainable)
    frozen: Sequence[str] = ()
    # dtype of Adam's first moments (None = the parameter's); nu stays f32
    mu_dtype: Optional[str] = None
    # ZeRO stage across ranks: 1/2 shard the Adam moments over dp (2 also
    # reduce-scatters the gradients), 3 the parameters and the frozen tree
    zero_stage: int = 2
    # rest the Adam moments in pinned host memory between steps
    offload_moments: bool = False


UPDATE_SLICE = 1 << 26      # elements an update step touches at a time


def _slices(x: torch.Tensor):
    """Index tuples covering x in runs of its leading axis of at most
    UPDATE_SLICE elements (one slice for a small leaf)."""
    if x.dim() == 0 or x.numel() <= UPDATE_SLICE:
        return [(...,)]
    rows = max(1, UPDATE_SLICE // (x.numel() // x.shape[0]))
    return [(slice(r, r + rows),) for r in range(0, x.shape[0], rows)]


def _weak(v: float, x: torch.Tensor) -> float:
    """The Python constant `v` as JAX applies it to an array like `x`: a
    weakly typed scalar takes the array's dtype, so against bf16 it is
    rounded to bf16 first (0.999 acts as 0.99853515625). A torch op would
    keep it in f32 against a bf16 tensor."""
    return torch.tensor(v, dtype=x.dtype).item()


def label_params(params: dict, cfg: TrainConfig) -> Dict[str, str]:
    """path -> "projector" / "train" / "frozen" for every leaf; a quantized
    leaf (`QuantWeight`, `QuantWeight4`: integer values, no gradient) is
    always "frozen"."""
    out = {}
    for p, x in tree_leaves_with_path(params):
        if not isinstance(x, torch.Tensor):
            out[p] = "frozen"
        elif any(re.search(f, p) for f in cfg.frozen):
            out[p] = "frozen"
        elif cfg.trainable is not None and not any(
                re.search(t, p) for t in cfg.trainable):
            out[p] = "frozen"
        elif cfg.projector_lr is not None and p.startswith("projector"):
            out[p] = "projector"
        else:
            out[p] = "train"
    return out


class AdamW:
    """optax.multi_transform of chain(clip_by_global_norm, adamw(schedule))
    per label group, and set_to_zero for "frozen" (see the module note).
    `split` (set by a Trainer across ranks): path -> the groups (dp, tp)
    over which that leaf's gradient and parameter are this rank's part,
    its squares summed over each for the norm."""

    def __init__(self, cfg: TrainConfig, params: dict):
        self.cfg = cfg
        self.labels = label_params(params, cfg)
        self.lr = {"train": cfg.learning_rate,
                   "projector": cfg.projector_lr or cfg.learning_rate}
        self.mu_dtype = (getattr(torch, cfg.mu_dtype) if cfg.mu_dtype
                         else None)
        self.split = {}

    def _zeros(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """A moment for `x`: in pinned host memory when offloaded from a
        card, else beside x."""
        if self.cfg.offload_moments and x.is_cuda:
            return torch.zeros(x.shape, dtype=dtype, pin_memory=True)
        return torch.zeros(x.shape, dtype=dtype, device=x.device)

    def init(self, params: dict) -> dict:
        mu, nu = {}, {}
        for p, x in tree_leaves_with_path(params):
            if self.labels[p] != "frozen":
                mu[p] = self._zeros(x, self.mu_dtype or x.dtype)
                nu[p] = self._zeros(x, x.dtype)
        return {"count": 0, "mu": mu, "nu": nu}

    def _sq(self, p: str, g: torch.Tensor) -> torch.Tensor:
        """optax.global_norm's term of leaf p: its squares summed in f32
        (over the ranks' parts of a split leaf), rounded to its dtype."""
        sq = sum((g[sl] * g[sl]).float().sum() for sl in _slices(g))
        for group in self.split.get(p, ()):
            sq = group.all_reduce(sq)
        return sq.to(g.dtype)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: dict) -> dict:
        """Apply one step to `params` (a tree, or {path: tensor}) in place,
        the moments updated in place too (an offloaded moment a slice at a
        time through the device); returns the state."""
        cfg = self.cfg
        leaves = dict(tree_leaves_with_path(params))
        count = state["count"]
        t = count + 1
        bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32) ** t
        for group, lr in self.lr.items():
            paths = [p for p, lab in self.labels.items() if lab == group]
            if not paths:
                continue
            g_norm = None                  # optax.global_norm, leaf by leaf
            for p in paths:
                sq = self._sq(p, grads[p])
                g_norm = sq if g_norm is None else g_norm + sq
            g_norm = torch.sqrt(g_norm)
            keep = g_norm < cfg.max_grad_norm
            step_size = -lr_at(cfg, count, lr)
            for p in paths:
                for sl in _slices(leaves[p]):
                    x, gp = leaves[p][sl], grads[p][sl]
                    mu_s, nu_s = state["mu"][p][sl], state["nu"][p][sl]
                    mu_d = mu_s.to(x.device, non_blocking=True)
                    nu_d = nu_s.to(x.device, non_blocking=True)
                    g = torch.where(keep, gp, gp / g_norm.to(gp.dtype)
                                    * _weak(cfg.max_grad_norm, gp))
                    mu = _weak(1 - cfg.b1, g) * g + _weak(cfg.b1, mu_d) * mu_d
                    nu = (_weak(1 - cfg.b2, g) * (g * g)
                          + _weak(cfg.b2, nu_d) * nu_d)
                    u = (mu / bc1.to(mu.dtype)) / (
                        torch.sqrt(nu / bc2.to(nu.dtype))
                        + _weak(cfg.eps, nu))
                    if cfg.weight_decay:
                        u = u + _weak(cfg.weight_decay, x) * x
                    x.add_((_weak(step_size, u) * u).to(x.dtype))
                    mu_s.copy_(mu)
                    nu_s.copy_(nu)
        state["count"] = count + 1
        return state


def make_optimizer(cfg: TrainConfig, params: dict) -> AdamW:
    return AdamW(cfg, params)


def _tensor_leaves(tree: dict):
    """(path, tensor) of every tensor leaf; quantized leaves are frozen."""
    return [(p, x) for p, x in tree_leaves_with_path(tree)
            if isinstance(x, torch.Tensor)]


def _micro(batch, i: int):
    if isinstance(batch, dict):
        return {k: _micro(v, i) for k, v in batch.items()}
    return batch[i]


def _part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part of x along dim (a view)."""
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n)


def _tensor(x):
    """The tensor under a leaf's TPShard and ZeroShard wrappers."""
    while hasattr(x, "shard"):
        x = x.shard
    return x


class Trainer:
    """`loss_fn(params, micro_batch, key) -> scalar loss`, or
    `loss_fn(params, micro_batch, key, frozen)` when a `frozen` tree (the
    base under LoRA) is given. Batch leaves are [grad_accum, micro_batch,
    ...], the micro-batch this rank's share of the step's; the key handed to
    loss_fn for micro-batch i is (key, i), which a loss may use to seed its
    draws. `mesh` (a `parallel.sharding.RankMesh`) trains across ranks;
    None: this process alone. With a tp group the trees a loss gets hold
    `TPShard`s where `LLM_RULES` split a leaf. At ZeRO stage 3 they hold
    `ZeroShard`s under their stacked "layers" subtrees (gathered a layer at
    a time by `layer_slice`), the rest gathered whole."""

    def __init__(self, loss_fn: Callable, params: dict, cfg: TrainConfig,
                 frozen: Optional[dict] = None, mesh=None):
        from ..parallel.collectives import single_group
        from ..parallel.sharding import (LLM_RULES, RankMesh, _zero_spec,
                                         zero_shard_tree)
        from ..parallel.tensor import tp_shard_tree, tp_spec
        self.cfg = cfg
        self.mesh = mesh or RankMesh(None, single_group(), single_group(),
                                     None)
        dp, tp = self.mesh.dp, self.mesh.tp
        self.optimizer = make_optimizer(cfg, params)
        labels = self.optimizer.labels
        # each leaf's ZeRO dim (None: whole on every rank) and tp dim (None:
        # not split), from the whole leaf's spec
        self.zero_dim = {
            p: _dp_dim(_zero_spec((p,), x, self.mesh, LLM_RULES))
            if dp.size > 1 else None
            for p, x in _tensor_leaves(params)}
        self.tp_dim = {p: tp_spec(p, x.shape, self.mesh) if tp.size > 1
                       else None for p, x in _tensor_leaves(params)}
        if tp.size > 1:
            params = tp_shard_tree(params, self.mesh)
            frozen = (tp_shard_tree(frozen, self.mesh)
                      if frozen is not None else None)
        self.stage3 = cfg.zero_stage >= 3 and dp.size > 1
        if self.stage3:
            params = zero_shard_tree(params, self.mesh)
            frozen = (zero_shard_tree(frozen, self.mesh)
                      if frozen is not None else None)
        self.params, self.frozen = params, frozen
        # gradients only where the update reads them
        self._leaf = {}
        for p, x in tree_leaves_with_path(params):
            x = _tensor(x)
            if isinstance(x, torch.Tensor):
                x.requires_grad_(labels[p] != "frozen")
                if labels[p] != "frozen":
                    self._leaf[p] = x
        self.sharded = frozenset(p for p in self._leaf
                                 if self.zero_dim[p] is not None)
        self.optimizer.split = {
            p: [g for g, d in ((dp, self.zero_dim[p]), (tp, self.tp_dim[p]))
                if d is not None] for p in self._leaf}
        self.opt_state = self.optimizer.init(self._views())
        self.step = 0
        self._train_step = self.compile_step(loss_fn)

    def _views(self) -> Dict[str, torch.Tensor]:
        """What the optimizer updates of each trained leaf: the leaf, its
        shard (stage 3), or this rank's part of the whole leaf (stages 1
        and 2, a view)."""
        return {p: _part(x, self.zero_dim[p], self.mesh.dp)
                if p in self.sharded and not self.stage3 else x
                for p, x in self._leaf.items()}

    def _reduce(self, p: str, g: torch.Tensor) -> torch.Tensor:
        """Leaf p's accumulated gradient summed over the pp/sp group (not
        over tp: see the module note), then averaged over dp, as the
        optimizer takes it."""
        dp, dim = self.mesh.dp, self.zero_dim[p]
        if self.mesh.kind is not None:
            self.mesh.inner.all_reduce(g)
        if p not in self.sharded:
            return dp.all_reduce(g, "mean")
        if self.stage3:                  # the gather's backward summed it
            return g.div_(dp.size)
        if self.cfg.zero_stage == 1:
            return _part(dp.all_reduce(g, "mean"), dim, dp)
        return dp.reduce_scatter(g, dim).div_(dp.size)

    def compile_step(self, loss_fn: Callable) -> Callable:
        """The step for `loss_fn` on this trainer's state (the JAX trainer
        compiles one per shape bucket; eager PyTorch has nothing to
        compile)."""
        from ..parallel.sharding import zero_use
        accum = self.cfg.grad_accum

        def step(batch, key):
            paths = list(self._leaf)
            acc, losses = [None] * len(paths), []
            span = torch.profiler.record_function  # named spans for a trace
            for i in range(accum):
                params = zero_use(self.params) if self.stage3 else self.params
                args = (params, _micro(batch, i), (key, i))
                if self.frozen is not None:
                    args += (zero_use(self.frozen) if self.stage3
                             else self.frozen,)
                with span("train/forward"):
                    loss = loss_fn(*args)
                del args, params
                with span("train/backward"):
                    # a loss that reaches no trained leaf (a text step of
                    # the pretrain stage) has zero gradients, as in JAX;
                    # backward() (not autograd.grad) so that a pipeline
                    # stage's receive, which leads to no trained leaf,
                    # still sends its gradient back
                    if loss.requires_grad:
                        loss.backward()
                losses.append(loss.detach().float())
                del loss
                for j, p in enumerate(paths):
                    leaf = self._leaf[p]
                    g, leaf.grad = leaf.grad, None
                    if g is None:
                        g = torch.zeros_like(leaf)
                    if accum == 1:
                        acc[j] = g
                    elif acc[j] is None:
                        acc[j] = g / accum
                    else:
                        acc[j].add_(g / accum)
            with span("train/reduce"):
                for j, p in enumerate(paths):
                    acc[j] = self._reduce(p, acc[j])
            with span("train/optimizer"):
                views = self._views()
                self.opt_state = self.optimizer.update(
                    dict(zip(paths, acc)), self.opt_state, views)
                del acc
                if not self.stage3:
                    for p in paths:              # stages 1/2: regather
                        if p not in self.sharded:
                            continue
                        whole = self._leaf[p]
                        with torch.no_grad():
                            whole.copy_(self.mesh.dp.all_gather(
                                views[p], self.zero_dim[p]))
            loss = torch.stack(losses).mean()
            return self.mesh.dp.all_reduce(loss, "mean")

        return step

    def gathered_params(self) -> dict:
        """The parameters whole (stage 3 gathers them over dp, tp over tp:
        every rank calls this)."""
        from ..parallel.sharding import zero_gather_tree
        from ..parallel.tensor import tp_gather_tree
        params = zero_gather_tree(self.params) if self.stage3 else self.params
        return tp_gather_tree(params) if self.mesh.tp.size > 1 else params

    def gathered_state(self):
        """(params, opt_state) whole, as a checkpoint holds them: every rank
        calls this, rank 0 writes it."""
        dp, tp = self.mesh.dp, self.mesh.tp
        moments = {}
        for k in ("mu", "nu"):
            moments[k] = {}
            for p, m in self.opt_state[k].items():
                if p in self.sharded:
                    m = dp.all_gather(m.to(self._leaf[p].device),
                                      self.zero_dim[p])
                if self.tp_dim[p] is not None:
                    m = tp.all_gather(m.to(self._leaf[p].device),
                                      self.tp_dim[p])
                moments[k][p] = m
        return self.gathered_params(), {"count": self.opt_state["count"],
                                        **moments}

    def load_state(self, params: dict, opt_state: dict) -> None:
        """Install a restored whole state (from any world size), each leaf
        and moment copied into this rank's tensors (its tp part, then its
        dp part where they are split), on their devices."""
        from ..parallel.sharding import ZeroShard
        from ..parallel.tensor import TPShard, tp_part
        dp = self.mesh.dp
        mine = dict(tree_leaves_with_path(self.params))
        with torch.no_grad():
            for p, x in _tensor_leaves(params):
                dst = mine[p]
                if isinstance(dst, TPShard):
                    dst = dst.shard
                x = tp_part(x, p, self.mesh)
                if isinstance(dst, ZeroShard):
                    dst.shard.copy_(_part(x, dst.dim, dp))
                else:
                    dst.copy_(x)
            for k in ("mu", "nu"):
                for p, x in opt_state[k].items():
                    x = tp_part(x, p, self.mesh)
                    if p in self.sharded:
                        x = _part(x, self.zero_dim[p], dp)
                    self.opt_state[k][p].copy_(x)
        self.opt_state["count"] = int(opt_state["count"])

    def run_step(self, batch, key, step_fn: Optional[Callable] = None
                 ) -> float:
        loss = (step_fn or self._train_step)(batch, key)
        self.step += 1
        return float(loss)


def _dp_dim(spec) -> Optional[int]:
    return list(spec).index("dp") if "dp" in spec else None
