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
At B = 1 the kernel is one launch on the tensor cores (csrc/int4_matmul.cu
`int4_fold_kernel`; `_plan` sizes its cluster and blocks), and
`fragment_map`, `fragment_k_rows`, `magic_nibbles` and `warp_rows` mirror
its fragment map, conversion and split of the rows for the CPU tests.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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


# K6's B = 1 kernel (csrc/int4_matmul.cu `int4_fold_kernel`): 128 output
# columns a warp and a block, 16 packed rows a step, 4 or 8 warps a block,
# a cluster of at most 8 blocks along the packed rows. Its launch bounds cap
# the registers at 128, so 16 warps fit an SM (four 4-warp or two 8-warp
# blocks).
WARP_COLS = 16 * 8
STEP_ROWS = 16
MIN_WARPS, MAX_WARPS = 4, 8
MAX_CLUSTER = 8
WARPS_PER_SM = 16


class Int4Plan(NamedTuple):
    """K6's launch. B = 1: `split` blocks of one thread-block cluster along
    the packed rows, `warps` warps a block, `rows` packed rows a block (a
    multiple of 16; the last block takes what is left). B > 1: `split`
    blocks of `rows` packed rows (a multiple of 64) with f32 partials summed
    by a second kernel, 8 warps a block. The C entry refuses any plan that
    does not cover dh, leaves a block empty, or exceeds these sizes."""
    split: int
    warps: int
    rows: int


@functools.lru_cache(maxsize=None)
def _plan(B: int, dh: int, nb: int, dout: int, sms: int) -> Int4Plan:
    """K6's launch for a shape the gate takes, on a card of `sms` SMs.
    Cached, since a decode step asks for the same five shapes 197 times.
    B = 1: `_b1_plan`. B > 1: enough blocks for two per
    SM, in whole 64-row passes."""
    if not int4_matmul_supported(B, dh, nb, dout):
        raise ValueError(f"int4_matmul_cuda does not take B={B}, "
                         f"dh={dh}, nb={nb}, dout={dout}")
    tiles = dout // WARP_COLS
    if B == 1:
        return _b1_plan(dh, tiles, sms)
    rows_per_block = min(8, 1 << (B - 1).bit_length())
    blocks = tiles * -(-B // rows_per_block)
    want = max(1, min(-(-2 * sms // blocks), -(-dh // 64)))
    rows = -(-dh // (want * 64)) * 64
    return Int4Plan(-(-dh // rows), 8, rows)


def _b1_plans(dh: int, tiles: int, warps: int = MIN_WARPS) -> list:
    """Every B = 1 plan of `warps` warps a block with a cluster of 1..8
    blocks, none of them empty."""
    plans = []
    for split in range(1, min(MAX_CLUSTER, dh // STEP_ROWS) + 1):
        rows = -(-dh // (split * STEP_ROWS)) * STEP_ROWS
        if -(-dh // rows) == split:
            plans.append(Int4Plan(split, warps, rows))
    return plans


def _b1_plan(dh: int, tiles: int, sms: int) -> Int4Plan:
    """The B = 1 plan. Where the whole grid fits the card at once (its
    warps within WARPS_PER_SM an SM), the one with the most warps: a
    matvec of one partial wave runs faster the more loads it has in flight
    (on an H100, wq/wo, wk/wv and down ran fastest at 8 x 8 warps, gate/up
    at 3 x 4; PERF.md). Else (lm_head: 1,188 column tiles) 4-warp blocks
    and the smallest cluster whose grid fills 85% of its waves of block
    slots (lm_head ran 0.119-0.125 ms at 1-2 blocks a cluster, 0.138-0.142
    at 4), or the one that fills the most."""
    cap = WARPS_PER_SM * sms
    fits = [p for w in (MIN_WARPS, MAX_WARPS) for p in _b1_plans(dh, tiles, w)
            if tiles * p.split * p.warps <= cap]
    if fits:
        return max(fits, key=lambda p: (p.split * p.warps, p.warps))
    plans = _b1_plans(dh, tiles)
    full = [p for p in plans if wave_share(p, tiles, sms) >= 0.85]
    return full[0] if full else max(
        plans, key=lambda p: wave_share(p, tiles, sms))


def wave_share(plan: Int4Plan, tiles: int, sms: int) -> float:
    """The share of the card's block slots (WARPS_PER_SM warps an SM) that
    the plan's blocks fill over its waves: the last wave of a grid that is
    not a whole number of waves runs with slots idle."""
    blocks = tiles * plan.split
    slots = WARPS_PER_SM // plan.warps * sms
    return blocks / (slots * -(-blocks // slots))


def warp_rows(plan: Int4Plan, dh: int, rank: int, warp: int) -> range:
    """The packed rows warp `warp` of block `rank` covers at B = 1, as the
    kernel reckons them: each warp a run of whole steps of its block's
    rows."""
    per_warp = -(-plan.rows // (plan.warps * STEP_ROWS)) * STEP_ROWS
    begin = rank * plan.rows + warp * per_warp
    end = min(begin + per_warp, (rank + 1) * plan.rows, dh)
    return range(begin, max(begin, end))


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte n of the result is byte (s >> 4n) & 7 of the
    eight bytes of (y << 32) | x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _sel(j: int) -> int:
    """The source's byte_perm selector of byte j % 4 of two words into
    bytes 0 and 2 (csrc/int4_matmul.cu `sel`)."""
    return 0x4400 + 0x1111 * (j & 3)


def magic_nibbles(v: int) -> int:
    """The source's conversion of the low nibbles of bytes 0 and 2 of v:
    bf16x2 bits of 128 + n (csrc/int4_matmul.cu `magic`)."""
    return (v & 0x000F000F) | 0x43004300


def fragment_map(w: "np.ndarray", j: int, lane: int) -> tuple:
    """The A fragment (a0..a3, 32-bit words of two bf16 each) that lane
    `lane` builds for tile j from a step's packed bytes w [16, 128] uint8
    (rows of the step, the warp's columns), as csrc/int4_matmul.cu does:
    the lane's four 16-byte words are rows 4t4..4t4+3 at columns
    16g..16g+15, byte j % 4 of word j / 4 is column 16g + j."""
    g, t4 = lane // 4, lane % 4
    rows = [int.from_bytes(bytes(w[4 * t4 + r, 16 * g:16 * g + 16]),
                           "little") for r in range(4)]
    word = lambda r: (rows[r] >> (32 * (j >> 2))) & 0xFFFFFFFF  # noqa: E731
    v01 = _byte_perm(word(0), word(1), _sel(j))
    v23 = _byte_perm(word(2), word(3), _sel(j))
    return (magic_nibbles(v01), magic_nibbles(v01 >> 4), magic_nibbles(v23),
            magic_nibbles(v23 >> 4))


def fragment_k_rows(lane: int) -> tuple:
    """The step rows of lane (g, t4)'s k slots 2t4, 2t4 + 1, 2t4 + 8,
    2t4 + 9: packed rows 4t4..4t4+3 (the B fragment b0 holds x at the first
    two, b1 at the last two)."""
    t4 = lane % 4
    return (4 * t4, 4 * t4 + 1, 4 * t4 + 2, 4 * t4 + 3)


def int4_matmul_cuda(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                     out_dtype=torch.bfloat16,
                     plan: Optional[Int4Plan] = None) -> torch.Tensor:
    """Launch K6. x [B, din] on the card (cast to bf16), q4 [din/2, dout]
    uint8 and scale [nb, dout] f32 contiguous on the same card, at a shape
    `int4_matmul_supported` takes; out_dtype bf16 or f32. One launch at
    B = 1. `plan` overrides `_plan`'s (the tests hold every choice to the
    same result)."""
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
    if plan is None:
        plan = _plan(B, dh, nb, dout, _sms(dev.index))
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    partial = (torch.empty((plan.split, B, dout), dtype=torch.float32,
                           device=dev) if B > 1 and plan.split > 1 else None)
    rc = _build.library().fvt_int4_matmul(
        xb.data_ptr(), q4.data_ptr(), scale.data_ptr(),
        partial.data_ptr() if partial is not None else None, out.data_ptr(),
        int(out_dtype == torch.float32), B, dh, dout, nb, *plan,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "int4_matmul_cuda")
    int4_matmul_cuda.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


int4_matmul_cuda.launches = 0
