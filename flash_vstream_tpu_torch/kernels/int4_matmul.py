"""int4 weight matvec for decode: the CUDA kernel K6 and its plain version.

Replaces the Pallas TPU kernel `_int4_matvec_kernel`
(flash_vstream_tpu/kernels/int4_matmul.py:45, wrapper `int4_matmul` :127,
gate `int4_matmul_supported` :115). x [B <= 32, din] bf16 times a packed
int4 weight (weights/quantize.QuantWeight4: q4 [din/2, dout] uint8,
split-half biased nibbles; scale [nb, dout] f32) -> [B, dout]. Each decode
matvec of a 4-bit decoder runs it: 7 projections per layer and the lm_head.
At B = 1 the bias and the block scales apply to the partial sums; at B > 1
each weight is dequantized to bf16 first (`int4_matmul_reference` spells out
both). JAX's wrapper is split in two: `int4_matmul_cuda` launches the kernel
on CUDA tensors and raises on what it does not take, and
`int4_matmul_reference` is its plain version. `models/layers.dense` is the
one place that picks between K6 and the dequantize path: K6 for a CUDA
activation at a shape the gate takes, as JAX picks its kernel on the TPU.
"""
from __future__ import annotations

import functools

import torch

from . import _build


def _pick_block(dout: int) -> int:
    for blk in (512, 384, 256, 128):
        if dout % blk == 0:
            return blk
    return 0


@functools.lru_cache(maxsize=None)
def int4_matmul_supported(x_rows: int, dh: int, nb: int, dout: int) -> bool:
    """The shapes the JAX kernel takes (int4_matmul.py:115-124), kept so the
    port runs its kernel for exactly the same shapes: a small row count, a
    packed half of whole scale blocks of a multiple of 8 rows, and a dout
    that is a multiple of 128. Cached: `dense` asks at every matvec."""
    return (x_rows <= 32
            and nb % 2 == 0
            and dh % (nb // 2) == 0
            and (dh // (nb // 2)) % 8 == 0
            and dh % 32 == 0
            and _pick_block(dout) > 0)


def int4_matmul_reference(x: torch.Tensor, q4: torch.Tensor,
                          scale: torch.Tensor,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch. x is rounded to bf16
    and sums run in f32. B == 1: per input block b, (x_b . n_b - 8 sum x_b)
    * s_b over the biased nibbles n, summed over blocks. B > 1: weights
    (n - 8) * bf16(s) rounded to bf16, then x @ w."""
    B, din = x.shape
    dh, dout = q4.shape
    nb = scale.shape[0]
    if din != 2 * dh:
        raise ValueError(f"x {tuple(x.shape)} does not match q4 "
                         f"{tuple(q4.shape)}")
    xf = x.to(torch.bfloat16).float()
    n = torch.cat([q4 & 0xF, q4 >> 4]).float()                # [din, dout]
    bs = din // nb
    scale = scale.float()
    if B == 1:
        xb = xf.reshape(nb, bs)
        part = torch.einsum("bk,bkd->bd", xb, n.reshape(nb, bs, dout))
        part = part - 8.0 * xb.sum(dim=1, keepdim=True)
        acc = (part * scale).sum(dim=0, keepdim=True)
    else:
        s = scale.to(torch.bfloat16).repeat_interleave(bs, dim=0)
        w = (n - 8.0).to(torch.bfloat16) * s                     # bf16
        acc = torch.matmul(xf, w.float())
    return acc.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _plan(B: int, dh: int, nb: int, dout: int, device_index: int) -> tuple:
    """(splits, packed rows per split) for a shape the gate takes: enough
    blocks for two per SM, in whole 64-row passes. Cached, since a decode
    step asks for the same five shapes 197 times."""
    if not int4_matmul_supported(B, dh, nb, dout):
        raise ValueError(f"int4_matmul_cuda does not take B={B}, "
                         f"dh={dh}, nb={nb}, dout={dout}")
    rows_per_block = 1 if B == 1 else min(8, 1 << (B - 1).bit_length())
    blocks = (dout // 128) * -(-B // rows_per_block)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    want = max(1, min(-(-2 * sms // blocks), -(-dh // 64)))
    rows = -(-dh // (want * 64)) * 64
    return -(-dh // rows), rows


def int4_matmul_cuda(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch K6. x [B, din] on the card (cast to bf16), q4 [din/2, dout]
    uint8 and scale [nb, dout] f32 contiguous on the same card, at a shape
    `int4_matmul_supported` takes; out_dtype bf16 or f32."""
    if x.dim() != 2 or q4.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"int4_matmul_cuda takes x [B, din], q4 [dh, dout], "
                         f"scale [nb, dout]; got {tuple(x.shape)}, "
                         f"{tuple(q4.shape)}, {tuple(scale.shape)}")
    B, din = x.shape
    dh, dout = q4.shape
    nb = scale.shape[0]
    if din != 2 * dh or scale.shape[1] != dout:
        raise ValueError(f"int4_matmul_cuda does not take x {tuple(x.shape)}, "
                         f"q4 {tuple(q4.shape)}, scale {tuple(scale.shape)}")
    if q4.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError(f"q4 must be uint8 and scale f32, got {q4.dtype} and "
                         f"{scale.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    dev = x.device
    for name, t in (("q4", q4), ("scale", scale)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"int4_matmul_cuda takes CUDA tensors, not {dev}")
    out = torch.empty((B, dout), dtype=out_dtype, device=dev)
    if B == 0:
        return out
    splits, rows = _plan(B, dh, nb, dout, dev.index)
    xb = x.to(torch.bfloat16).contiguous()
    partial = (torch.empty((splits, B, dout), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    rc = _build.library().fvt_int4_matmul(
        xb.data_ptr(), q4.data_ptr(), scale.data_ptr(),
        partial.data_ptr() if partial is not None else None, out.data_ptr(),
        int(out_dtype == torch.float32), B, dh, dout, nb, splits, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "int4_matmul_cuda")
    int4_matmul_cuda.launches += 1
    return out


int4_matmul_cuda.launches = 0
