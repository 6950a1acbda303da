"""Process groups and collectives of training across ranks, one process a
rank over `torch.distributed`.

The port's own module: JAX leaves its collectives to XLA (the psum of a
shard_map transpose, `ppermute`, the all-gathers and reduce-scatters of a
ZeRO-sharded jit). Here each rank runs its own autograd graph, as
`torchrun` starts them:

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m flash_vstream_tpu_torch.train.finetune_flash --pp 2 ...

`init_distributed` reads RANK, WORLD_SIZE and LOCAL_RANK as `torchrun` sets
them; with none set the world is one rank and no group is made. The
backend is chosen from the caller's arguments, never by catching an error:
gloo on the CPU, NCCL when each rank has a card of its own (`cuda:
LOCAL_RANK`), gloo when the ranks share one card (`shared_card`: NCCL
refuses two ranks on one GPU). gloo runs all_reduce and broadcast on CUDA
tensors itself (`GLOO_CUDA_OPS`); for every other op a group over gloo
copies a CUDA tensor through pinned host memory, decided by the backend's
name and the op. Compute stays on the card.

A failed collective raises, so the rank exits non-zero; `spawn` (the
tests' launcher) and torch.distributed.run (chip_smoke.py's and a user's)
check every rank's exit code. The process group's timeout bounds a rank left waiting
on a peer that died.

The differentiable pieces: `ring_shift` (JAX's `ppermute` on a ring; its
backward is the reverse shift), `gather_on_use` (a ZeRO-3 shard's
all-gather; its backward reduce-scatters the gradient), Megatron's
tensor-parallel regions `copy_to`, `reduce_from` and `gather_from` (what
GSPMD inserts around a split product in JAX), `send_forward` /
`recv_forward` (a pipeline stage's activations; their backward carries the
gradient the other way).
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the ops gloo runs on CUDA tensors itself; it takes no CUDA tensor for
# the others (reduce-scatter, all-gather, point-to-point)
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})
INIT_ENV = "FVT_DIST_INIT"      # an init_method URL; default env://
TIMEOUT_S = 600

_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor", None)


@dataclasses.dataclass
class DistInfo:
    """This process's rank, the world's size, its local rank, its device
    and the backend (None at world 1)."""
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: Optional[str]


def init_distributed(device=None, shared_card: bool = False) -> DistInfo:
    """Join the process group torchrun's variables describe (RANK,
    WORLD_SIZE, LOCAL_RANK; init from `FVT_DIST_INIT`, else env://).
    `device` None or "cuda" means the card `cuda:LOCAL_RANK` (`cuda:0` for
    every rank with `shared_card`; at world 1 the current card); "cpu" the
    CPU. Idempotent: a second call returns the group already joined."""
    from ..core.device import resolve_device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = resolve_device(device)
    if world == 1:
        return DistInfo(0, 1, 0, dev, None)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0 if shared_card else local)
        torch.cuda.set_device(dev)
    # gloo on the CPU and for ranks sharing one card (NCCL refuses two
    # ranks on one GPU), NCCL for a card a rank
    backend = "gloo" if dev.type == "cpu" or shared_card else "nccl"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=os.environ.get(INIT_ENV, "env://"),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return DistInfo(rank, world, local, dev, dist.get_backend())


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of `t` (pinned buffers come from torch's caching
    host allocator, so a staged op allocates no new host memory)."""
    return _pinned_empty(t.shape, t.dtype).copy_(t)


def _pinned_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class Group:
    """The collectives of a group of ranks (`ranks`, global; this rank is
    `rank` within it). A group of one rank (`pg` None) returns its inputs.
    The sum over a group is in the tensor's dtype, as JAX's psum.
    `parts` maps n to the group of the n consecutive ranks of this one
    that hold this rank (a tp group's kv-head blocks), where made."""

    def __init__(self, ranks: Sequence[int], pg=None,
                 backend: Optional[str] = None):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.pg = pg
        self.backend = backend
        me = dist.get_rank() if dist.is_initialized() else self.ranks[0]
        self.rank = self.ranks.index(me)
        self.parts = {}

    def part(self, n: int) -> "Group":
        """The group of the n consecutive ranks of this group that hold
        this rank (`create_rank_mesh` makes them for a tp group)."""
        if n == self.size:
            return self
        if n == 1:
            return Group([self.ranks[self.rank]])
        return self.parts[n]

    def __repr__(self) -> str:
        return f"Group(ranks={self.ranks}, rank={self.rank})"

    def staged(self, op: str, t: torch.Tensor) -> bool:
        """Whether `op` on `t` goes through pinned host memory: a CUDA
        tensor over gloo, for an op gloo takes no CUDA tensor for."""
        return (t.is_cuda and self.backend == "gloo"
                and op not in GLOO_CUDA_OPS)

    def global_rank(self, i: int) -> int:
        return self.ranks[i % self.size]

    # -- collectives ------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (op "sum") or mean ("mean") of `t` over the group, in
        place; returns `t`."""
        if self.size == 1:
            return t
        buf = _pinned(t) if self.staged("all_reduce", t) else t
        dist.all_reduce(buf, group=self.pg)
        if buf is not t:
            t.copy_(buf)
        if op == "mean":
            t.div_(self.size)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank `src`'s `t` on every rank, in place; returns `t`."""
        if self.size == 1:
            return t
        buf = _pinned(t) if self.staged("broadcast", t) else t
        dist.broadcast(buf, self.global_rank(src), group=self.pg)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' `t` concatenated along `dim` in rank order."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        staged = self.staged("all_gather", x)
        if staged:
            x = _pinned(x)
        shape = (self.size * x.shape[0], *x.shape[1:])
        out = (_pinned_empty(shape, x.dtype) if staged
               else x.new_empty(shape))
        _all_gather(out, x, group=self.pg)
        if staged:
            out = out.to(t.device)
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's part along `dim` of the sum of the ranks' `t`
        (`dim`'s size divides by the group's)."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        staged = self.staged("reduce_scatter", x)
        if staged:
            x = _pinned(x)
        shape = (x.shape[0] // self.size, *x.shape[1:])
        out = (_pinned_empty(shape, x.dtype) if staged
               else x.new_empty(shape))
        _reduce_scatter(out, x, group=self.pg)
        if staged:
            out = out.to(t.device)
        return out.movedim(0, dim)

    def shift(self, tensors: Sequence[torch.Tensor], offset: int = 1
              ) -> List[torch.Tensor]:
        """Ring shift: each rank sends `tensors` to group rank + offset and
        returns those of rank - offset (one batch of point-to-point ops)."""
        if self.size == 1 or offset % self.size == 0:
            return list(tensors)
        dst = self.global_rank(self.rank + offset)
        src = self.global_rank(self.rank - offset)
        ops, outs = [], []
        for t in tensors:
            x = t.contiguous()
            staged = self.staged("shift", x)
            if staged:
                x = _pinned(x)
            r = (_pinned_empty(x.shape, x.dtype) if staged
                 else torch.empty_like(x))
            ops += [dist.P2POp(dist.isend, x, dst, group=self.pg),
                    dist.P2POp(dist.irecv, r, src, group=self.pg)]
            outs.append((r, staged, t.device))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return [r.to(d) if s else r for r, s, d in outs]

    def isend(self, t: torch.Tensor, dst: int, tag: int):
        """Start sending `t` to group rank `dst`; returns (work, buffer):
        keep the buffer until `work.wait()`."""
        x = t.contiguous()
        if self.staged("send", x):
            x = _pinned(x)
        return dist.isend(x, self.global_rank(dst), group=self.pg,
                          tag=tag), x

    def recv(self, like: torch.Tensor, src: int, tag: int) -> torch.Tensor:
        """A tensor shaped like `like` from group rank `src`."""
        staged = self.staged("recv", like)
        out = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device,
                          pin_memory=staged)
        dist.recv(out, self.global_rank(src), group=self.pg, tag=tag)
        return out.to(like.device) if staged else out


def single_group() -> Group:
    """The group of this rank alone."""
    return Group([dist.get_rank() if dist.is_initialized() else 0])


# -- differentiable collectives -------------------------------------------

class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, offset, *tensors):
        ctx.group, ctx.offset = group, offset
        outs = group.shift(tensors, offset)
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        float_grads = [g for g in grads if g is not None]
        back = iter(ctx.group.shift(float_grads, -ctx.offset))
        return (None, None) + tuple(next(back) if g is not None else None
                                    for g in grads)


def ring_shift(group: Group, *tensors: torch.Tensor, offset: int = 1):
    """JAX's `ppermute` over the ring i -> i + offset, for several tensors
    in one batch of sends (so the forward and the backward keep one order
    on every rank); integer tensors (segment ids) shift without a
    gradient. The backward is the reverse shift of the gradients."""
    outs = _RingShift.apply(group, offset, *tensors)
    return outs if len(tensors) > 1 else outs[0]


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


def gather_on_use(shard: torch.Tensor, group: Group, dim: int
                  ) -> torch.Tensor:
    """A ZeRO-3 shard gathered whole along `dim`; the backward
    reduce-scatters the gradient (the sum of the ranks' gradients to the
    whole, this rank's part of it)."""
    return _GatherOnUse.apply(shard, group, dim)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of `x` over the group, differentiated as this rank's own
    term (Megatron's reduce-from region): the gradient reaches this rank's
    `x` once, where a differentiable all-reduce would sum it again. The
    forward is the all-reduce's own result, equal on every rank."""
    return _ReduceFrom.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.clone()), None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """`x` as it is (Megatron's copy-to region, the counterpart of
    `reduce_from`): a replicated input entering this rank's part of a
    split product, whose gradient is the sum of the ranks' parts, so the
    backward all-reduces it over the group."""
    return _CopyTo.apply(x, group)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return group.all_gather(x, -1)

    @staticmethod
    def backward(ctx, grad):
        r = ctx.group.rank
        return grad[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def gather_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' `x` concatenated on the last dim in rank order (a split
    product's columns made whole); the backward keeps this rank's slice of
    the gradient, which every rank computed whole and alike."""
    return _GatherFrom.apply(x, group)


def token_mean(total: torch.Tensor, count: torch.Tensor, group: Group
               ) -> torch.Tensor:
    """A token-weighted mean over the ranks of the dp `group` as this
    rank's loss: its nll `total` x dp / the group's `count`, so the
    trainer's mean over dp of the ranks' losses and gradients is the sum
    of the nll over the global batch / its count, JAX's cross entropy over
    the global batch (a mean of the ranks' means would weigh a rank's
    tokens by its own count)."""
    if group.size == 1:
        return total / torch.clamp_min(count, 1)
    n = group.all_reduce(count.clone())
    return total * group.size / torch.clamp_min(n, 1)


class _SendForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dst, tag, pending):
        ctx.group, ctx.dst, ctx.tag = group, dst, tag
        ctx.like = torch.empty_like(x, device="meta")
        ctx.device = x.device
        pending.append(group.isend(x.detach(), dst, tag))
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        like = torch.empty(ctx.like.shape, dtype=ctx.like.dtype,
                           device=ctx.device)
        return ctx.group.recv(like, ctx.dst, ctx.tag), None, None, None, None


class _RecvForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, like, group, src, tag):
        ctx.group, ctx.src, ctx.tag = group, src, tag
        return group.recv(like, src, tag)

    @staticmethod
    def backward(ctx, grad):
        work, buf = ctx.group.isend(grad, ctx.src, ctx.tag)
        # the engine's end-of-backward callback keeps the buffer until sent
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: (work.wait(), buf))
        return None, None, None, None, None


def send_forward(x: torch.Tensor, group: Group, dst: int, tag: int,
                 pending: list) -> torch.Tensor:
    """Send a stage's output `x` to group rank `dst` (asynchronously; the
    caller waits on `pending` before returning). Returns a 0-d tie: a loss
    that adds it (times zero) runs this send's backward, which receives the
    gradient of `x` from `dst`."""
    return _SendForward.apply(x, group, dst, tag, pending)


def recv_forward(like: torch.Tensor, group: Group, src: int, tag: int
                 ) -> torch.Tensor:
    """Receive a stage's input (shaped like `like`) from group rank `src`;
    its gradient goes back to `src` in the backward. A fresh anchor leaf
    makes the received tensor part of the graph, so the backward reaches
    this node under `loss.backward()`."""
    anchor = torch.zeros((), requires_grad=True)
    return _RecvForward.apply(anchor, like, group, src, tag)


# -- launching ranks -------------------------------------------------------

def _rank_main(fn, rank, world, init_method, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    os.environ[INIT_ENV] = init_method
    torch.set_num_threads(1)
    fn(*args)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, init_file: str) -> None:
    """Run fn(*args) in `world` fresh processes of one thread each, ranks
    0..world-1 (RANK, WORLD_SIZE, LOCAL_RANK set as torchrun sets them;
    init from the file `init_file`, which must not exist yet). `fn` must
    be importable (a module-level function); each rank returns its results
    through files. Raises if any rank exits non-zero or the ranks outlast
    the group's timeout; the others are then stopped."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, f"file://{init_file}", args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks exited with codes {codes} "
                           f"(0 is success; None or negative: stopped)")
