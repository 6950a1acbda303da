"""Flash attention forward: the CUDA kernel K1 and its plain PyTorch version.

Replaces the Pallas TPU kernel `_flash_kernel`
(flash_vstream_tpu/kernels/flash_attention.py:90) and keeps the signature and
semantics of that module's public `flash_attention` (:503): segment ids with
-1 as padding that is never attended, causal masking, GQA with
kv head = q head // (Hq // Hkv), and zeros for a row that sees no key.

Dispatch is by the tensor's device alone:
- a CPU tensor takes `flash_attention_reference`, the port of `xla_attention`;
- a CUDA tensor with `q_offset == 0` launches the kernel (`flash_attention_cuda`),
  which raises on a dtype, shape or stride it does not take;
- `q_offset != 0` (single-token decode against a cache) takes the plain
  version on any device, as in JAX, where decode never reached Pallas.

The kernel (csrc/flash_attention.cu) keeps the online-softmax state in
registers and runs both products as `mma.sync` bf16 tensor-core fragments;
its source note says what bounds it on Hopper and what the design does about
that. The TPU version's crossover (`Sq >= 512` before fusing) was tuned on a
v5e and is not carried over: every q_offset-0 call on the card runs K1.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (64, 80, 128)


def flash_attention_reference(
    q: torch.Tensor,                   # [B, Hq, Sq, D]
    k: torch.Tensor,                   # [B, Hkv, Skv, D]
    v: torch.Tensor,                   # [B, Hkv, Skv, D]
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,   # [B, Sq] int
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, Skv] int
    q_offset=0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention, a port of `xla_attention`: scores and softmax in f32
    from the (exactly widened) inputs, masked scores at DEFAULT_MASK_VALUE,
    p rounded to v's dtype before the P V product, output in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    mask = torch.ones((B, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=q.device)[None, :]
        mask = mask & (qi >= ki)
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        seg = seg & (kv_segment_ids[:, None, :] >= 0)
        mask = mask & seg[:, None, None]
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    # rows with no visible key: zero them (softmax of all-masked is uniform)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _check_operand(name: str, x: torch.Tensor, dev: torch.device) -> None:
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_cuda takes bfloat16, {name} is "
                         f"{x.dtype}")
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(f"{name} must be [B, H, S, D] with a contiguous "
                         f"last dim, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if (any(s % 8 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)
            or x.data_ptr() % 16):
        raise ValueError(f"{name}: strides {x.stride()} must be multiples of "
                         f"8 elements and the data 16-byte aligned (the "
                         f"kernel loads 16 bytes at a time)")


def _check_segments(name: str, seg: torch.Tensor, B: int, S: int,
                    dev: torch.device) -> None:
    if (seg.device != dev or seg.dtype != torch.int32
            or tuple(seg.shape) != (B, S) or not seg.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{B}, {S}] "
                         f"tensor on {dev}, got {seg.dtype} "
                         f"{tuple(seg.shape)} on {seg.device}")


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch K1 on CUDA tensors (q_offset 0). Inputs are bf16 [B, H, S, D]
    with any strides that are multiples of 8 (so the ViT's [T, P, H, D] ->
    [T, H, P, D] transposes need no copy). The output is [B, Hq, Sq, D]
    stored as [B, Sq, Hq, D], so the caller's transpose back to tokens is
    free. Raises on what the kernel does not take."""
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, dev)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if (tuple(k.shape) != (B, Hkv, Skv, D) or v.shape != k.shape
            or Hq % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form GQA attention")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("give both q and kv segment ids, or neither")
    if q_segment_ids is not None:
        _check_segments("q_segment_ids", q_segment_ids, B, Sq, dev)
        _check_segments("kv_segment_ids", kv_segment_ids, B, Skv, dev)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    if Skv == 0:
        return out.zero_()
    lib = _build.library()
    seg_q = q_segment_ids.data_ptr() if q_segment_ids is not None else None
    seg_kv = kv_segment_ids.data_ptr() if kv_segment_ids is not None else None
    rc = lib.fvt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        seg_q, seg_kv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, Hq, Sq, Skv, Hkv, D, int(causal), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention_cuda")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_offset=0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention with the signature of the JAX `flash_attention`.
    Segment id -1 marks padding (never attended); `q_offset` shifts query
    positions for causal decode against a cache prefix."""
    prefill = isinstance(q_offset, int) and q_offset == 0
    if q.device.type == "cpu" or not prefill:
        return flash_attention_reference(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_offset=q_offset, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal,
                                q_segment_ids=q_segment_ids,
                                kv_segment_ids=kv_segment_ids, scale=scale)
