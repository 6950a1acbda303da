"""Single-device trainer: gradient accumulation, global-norm clipping, AdamW
with warmup + cosine decay, parameter groups, checkpointable state.

Port of flash_vstream_tpu/train/trainer.py for one device (dp = 1). The
optimizer is written out rather than taken from torch.optim, because the
JAX trainer's optax chain has semantics the stock classes do not share:

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
  leaf's dtype and adds the leaves' sums in it.

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
leaves are frozen. ZeRO stages other than the default, moment offload and
data parallelism raise (ROADMAP A16).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Sequence

import torch

from .lora import tree_leaves_with_path
from .reporting import lr_at

DP_TODO = ("ZeRO stages other than 2, moment offload and data parallelism "
           "are not ported yet: ROADMAP A16")


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
    # ZeRO stage of the JAX trainer; one device runs the default (2) only
    zero_stage: int = 2
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
    per label group, and set_to_zero for "frozen" (see the module note)."""

    def __init__(self, cfg: TrainConfig, params: dict):
        self.cfg = cfg
        self.labels = label_params(params, cfg)
        self.lr = {"train": cfg.learning_rate,
                   "projector": cfg.projector_lr or cfg.learning_rate}
        self.mu_dtype = (getattr(torch, cfg.mu_dtype) if cfg.mu_dtype
                         else None)

    def init(self, params: dict) -> dict:
        mu, nu = {}, {}
        for p, x in tree_leaves_with_path(params):
            if self.labels[p] != "frozen":
                mu[p] = torch.zeros_like(x, dtype=self.mu_dtype or x.dtype)
                nu[p] = torch.zeros_like(x)
        return {"count": 0, "mu": mu, "nu": nu}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: dict) -> dict:
        """Apply one step to `params` in place, the moments updated in
        place too; returns the state."""
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
                sq = sum((grads[p][sl] * grads[p][sl]).float().sum()
                         for sl in _slices(grads[p])).to(grads[p].dtype)
                g_norm = sq if g_norm is None else g_norm + sq
            g_norm = torch.sqrt(g_norm)
            keep = g_norm < cfg.max_grad_norm
            step_size = -lr_at(cfg, count, lr)
            for p in paths:
                for sl in _slices(leaves[p]):
                    x, gp = leaves[p][sl], grads[p][sl]
                    mu_s, nu_s = state["mu"][p][sl], state["nu"][p][sl]
                    g = torch.where(keep, gp, gp / g_norm.to(gp.dtype)
                                    * _weak(cfg.max_grad_norm, gp))
                    mu = _weak(1 - cfg.b1, g) * g + _weak(cfg.b1, mu_s) * mu_s
                    nu = (_weak(1 - cfg.b2, g) * (g * g)
                          + _weak(cfg.b2, nu_s) * nu_s)
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


class Trainer:
    """`loss_fn(params, micro_batch, key) -> scalar loss`, or
    `loss_fn(params, micro_batch, key, frozen)` when a `frozen` tree (the
    base under LoRA) is given. Batch leaves are [grad_accum, micro_batch,
    ...]; the key handed to loss_fn for micro-batch i is (key, i), which a
    loss may use to seed its draws."""

    def __init__(self, loss_fn: Callable, params: dict, cfg: TrainConfig,
                 frozen: Optional[dict] = None):
        if cfg.zero_stage != 2 or cfg.offload_moments:
            raise NotImplementedError(DP_TODO)
        self.cfg = cfg
        self.frozen = frozen
        self.params = params
        self.optimizer = make_optimizer(cfg, params)
        # gradients only where the update reads them
        for p, x in _tensor_leaves(params):
            x.requires_grad_(self.optimizer.labels[p] != "frozen")
        self.opt_state = self.optimizer.init(params)
        self.step = 0
        self._train_step = self.compile_step(loss_fn)

    def compile_step(self, loss_fn: Callable) -> Callable:
        """The step for `loss_fn` on this trainer's state (the JAX trainer
        compiles one per shape bucket; eager PyTorch has nothing to
        compile)."""
        accum = self.cfg.grad_accum

        def step(batch, key):
            paths = [p for p, lab in self.optimizer.labels.items()
                     if lab != "frozen"]
            leaves = dict(_tensor_leaves(self.params))
            acc, losses = [None] * len(paths), []
            span = torch.profiler.record_function  # named spans for a trace
            for i in range(accum):
                args = (self.params, _micro(batch, i), (key, i))
                if self.frozen is not None:
                    args += (self.frozen,)
                with span("train/forward"):
                    loss = loss_fn(*args)
                with span("train/backward"):
                    # a loss that reaches no trained leaf (a text step of
                    # the pretrain stage) has zero gradients, as in JAX
                    grads = (list(torch.autograd.grad(
                        loss, [leaves[p] for p in paths], allow_unused=True))
                        if loss.requires_grad else [None] * len(paths))
                losses.append(loss.detach().float())
                del loss
                for j, p in enumerate(paths):
                    g = grads[j]
                    grads[j] = None              # one leaf's temporaries
                    if g is None:
                        g = torch.zeros_like(leaves[p])
                    if accum == 1:
                        acc[j] = g
                    elif acc[j] is None:
                        acc[j] = g / accum
                    else:
                        acc[j].add_(g / accum)
            with span("train/optimizer"):
                self.opt_state = self.optimizer.update(
                    dict(zip(paths, acc)), self.opt_state, self.params)
            return torch.stack(losses).mean()

        return step

    def load_state(self, params: dict, opt_state: dict) -> None:
        """Install restored state (copied into this trainer's tensors, on
        their devices)."""
        mine = dict(_tensor_leaves(self.params))
        with torch.no_grad():
            for p, x in _tensor_leaves(params):
                mine[p].copy_(x)
        dev = {p: x.device for p, x in mine.items()}
        self.opt_state = {
            "count": int(opt_state["count"]),
            "mu": {p: x.to(dev[p]) for p, x in opt_state["mu"].items()},
            "nu": {p: x.to(dev[p]) for p, x in opt_state["nu"].items()},
        }

    def run_step(self, batch, key, step_fn: Optional[Callable] = None
                 ) -> float:
        loss = (step_fn or self._train_step)(batch, key)
        self.step += 1
        return float(loss)
