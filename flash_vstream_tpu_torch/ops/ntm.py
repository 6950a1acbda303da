"""Neural-Turing-Machine abstract memory (the STAR Turing memory).

Port of flash_vstream_tpu/ops/ntm.py: the update rule of the reference's
VStreamMetaForCausalLM.attention (vstream_arch.py:174-183),

    weight = softmax(q(mem) @ k(new)^T / sqrt(h)) * update_ratio
    decay  = weight.sum(-1, keepdims=True)
    mem    = mem * (1 - decay) + weight @ new

with a key validity mask, and its chunked form attention_feature
(compress_functions.py:263-277), which folds incoming frames into a fixed
[t0 * P, D] memory t0 frames at a time. JAX scans every chunk up to a
static frame count; here a host loop skips the chunks with no valid frame,
which JAX's scan passes through unchanged. Everything runs in f32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class NTMParams(NamedTuple):
    """The NTM cross-attention's parameters. The update rule reads q and k
    only; v, out and ln keep the reference module's checkpoint format
    (vstream_arch.py:39-45)."""
    wq: torch.Tensor   # [D, H]
    bq: torch.Tensor   # [H]
    wk: torch.Tensor   # [D, H]
    bk: torch.Tensor   # [H]
    wv: torch.Tensor   # [D, H]
    bv: torch.Tensor   # [H]
    wo: torch.Tensor   # [H, D]
    bo: torch.Tensor   # [D]
    ln_scale: torch.Tensor  # [D]
    ln_bias: torch.Tensor   # [D]


def init_ntm_params(generator: torch.Generator, input_dim: int,
                    hidden_dim: int, device=None,
                    dtype=torch.float32) -> NTMParams:
    """U(-1/sqrt(din), 1/sqrt(din)) weights and zero biases (the JAX init's
    distributions), drawn from `generator` on `device`."""
    kw = dict(dtype=dtype, device=device)

    def lin(din, dout):
        bound = 1.0 / math.sqrt(din)
        w = torch.rand(din, dout, generator=generator, **kw)
        return w.mul_(2 * bound).sub_(bound), torch.zeros(dout, **kw)

    wq, bq = lin(input_dim, hidden_dim)
    wk, bk = lin(input_dim, hidden_dim)
    wv, bv = lin(input_dim, hidden_dim)
    wo, bo = lin(hidden_dim, input_dim)
    return NTMParams(wq, bq, wk, bk, wv, bv, wo, bo,
                     torch.ones(input_dim, **kw), torch.zeros(input_dim, **kw))


def ntm_update(params: NTMParams, memory: torch.Tensor, new: torch.Tensor,
               new_valid: Optional[torch.Tensor] = None,
               update_ratio: float = 0.2) -> torch.Tensor:
    """One NTM write: `new` [N, D] (masked by new_valid [N]) blended into
    `memory` [M, D]; returns the new memory in f32. With no valid key the
    weights are 0 and the memory comes back unchanged."""
    h = params.wq.shape[1]
    mem = memory.float()
    newf = new.float()
    q = mem @ params.wq.float() + params.bq.float()
    k = newf @ params.wk.float() + params.bk.float()
    scores = (q @ k.T) / torch.sqrt(torch.tensor(float(h), device=q.device))
    if new_valid is not None:
        scores = torch.where(new_valid[None, :], scores, float("-inf"))
    weight = torch.softmax(scores, dim=-1)
    if new_valid is not None:
        # fully masked rows are NaN after softmax(-inf): zero them
        weight = torch.where(new_valid.any(), weight, 0.0)
    weight = weight * update_ratio
    decay = weight.sum(dim=-1, keepdim=True)
    return mem * (1.0 - decay) + weight @ newf


def ntm_compress(params: NTMParams, x: torch.Tensor, n_valid: int, t0: int,
                 tokens_per_frame: int,
                 update_ratio: float = 0.2) -> torch.Tensor:
    """Chunked NTM compression of x [Tmax, P, D] to [t0, P, D] (f32): the
    memory starts as the first t0 frames and later frames arrive in chunks
    of t0, frames at index >= n_valid masked. With n_valid <= t0 the
    (masked) input passes through."""
    Tmax, P, D = x.shape
    if P != tokens_per_frame:
        raise ValueError(f"x has {P} tokens a frame, want {tokens_per_frame}")
    mem = x[:t0].reshape(t0 * P, D).float()
    if Tmax <= t0:
        return mem.reshape(t0, P, D)
    for c0 in range(t0, Tmax, t0):
        chunk = x[c0:c0 + t0].float()
        n = chunk.shape[0]
        if n < t0:                       # the scan's zero-padded last chunk
            chunk = torch.cat([chunk, chunk.new_zeros(t0 - n, P, D)])
        if not c0 < n_valid:             # no valid frame: the state holds
            continue
        # the padded frames carry index Tmax, as in JAX
        fidx = torch.clamp_max(torch.arange(c0, c0 + t0, device=x.device),
                               Tmax)
        mem = ntm_update(params, mem, chunk.reshape(t0 * P, D),
                         (fidx < n_valid).repeat_interleave(P), update_ratio)
    return mem.reshape(t0, P, D)
