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
  global norm is taken over a group's leaves; "frozen" leaves never move.

Gradient accumulation takes the mean of the micro-batch gradients, summed in
f32 as g / accum per micro-batch, as the JAX scan does. Parameters and
moments are updated in place. ZeRO stages other than the default, moment
offload and data parallelism raise (ROADMAP A16).
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
        """Apply one step to `params` in place; returns the new state."""
        cfg = self.cfg
        leaves = dict(tree_leaves_with_path(params))
        count = state["count"]
        for group, lr in self.lr.items():
            paths = [p for p, lab in self.labels.items() if lab == group]
            if not paths:
                continue
            g_norm = torch.sqrt(sum((grads[p].float() ** 2).sum()
                                    for p in paths))
            keep = g_norm < cfg.max_grad_norm
            step_size = -lr_at(cfg, count, lr)
            for p in paths:
                x = leaves[p]
                g = torch.where(keep, grads[p],
                                grads[p] / g_norm.to(grads[p].dtype)
                                * cfg.max_grad_norm)
                mu = (1 - cfg.b1) * g + cfg.b1 * state["mu"][p]
                nu = (1 - cfg.b2) * g * g + cfg.b2 * state["nu"][p]
                t = count + 1
                bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32) ** t
                bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32) ** t
                u = (mu / bc1.to(mu.dtype)) / (
                    torch.sqrt(nu / bc2.to(nu.dtype)) + cfg.eps)
                if cfg.weight_decay:
                    u = u + cfg.weight_decay * x
                x.add_((u * step_size).to(x.dtype))
                state["mu"][p] = mu.to(state["mu"][p].dtype)
                state["nu"][p] = nu
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
        for _, x in _tensor_leaves(params):
            x.requires_grad_(True)
        self.params = params
        self.optimizer = make_optimizer(cfg, params)
        self.opt_state = self.optimizer.init(params)
        self.step = 0
        self._train_step = self.compile_step(loss_fn)

    def compile_step(self, loss_fn: Callable) -> Callable:
        """The step for `loss_fn` on this trainer's state (the JAX trainer
        compiles one per shape bucket; eager PyTorch has nothing to
        compile)."""
        accum = self.cfg.grad_accum

        def step(batch, key):
            paths = [p for p, _ in _tensor_leaves(self.params)]
            leaves = [x for _, x in _tensor_leaves(self.params)]
            acc, losses = None, []
            span = torch.profiler.record_function  # named spans for a trace
            for i in range(accum):
                args = (self.params, _micro(batch, i), (key, i))
                if self.frozen is not None:
                    args += (self.frozen,)
                with span("train/forward"):
                    loss = loss_fn(*args)
                with span("train/backward"):
                    grads = torch.autograd.grad(loss, leaves,
                                                allow_unused=True)
                grads = [torch.zeros_like(x) if g is None else g
                         for g, x in zip(grads, leaves)]
                if accum == 1:
                    acc = grads
                elif acc is None:
                    acc = [g / accum for g in grads]
                else:
                    acc = [a + g / accum for a, g in zip(acc, grads)]
                losses.append(loss.detach().float())
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
