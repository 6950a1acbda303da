"""The int4 decode-matvec probe's variants: the CUDA kernels P3 (v1-v5, v7)
and P4 (v6), each with its plain version.

Replace the Pallas TPU kernels of scripts/probe_int4_variants.py: `k_v1`
(:35), `k_v2` (:58), `k_v3` (:83), `k_v4` (:97), `k_v5` (:124) and
`k_v7_unpackonly` (:273), launched by `make_call` (:150), and
`k_v6_bf16dot` (:266), launched inside `bench_bf16` (:289). Each takes
apart one piece of K6's arithmetic (kernels/int4_matmul.py) at B = 1:

  v1_current     y = sum_b s_b * (x_b . (n_b - 8)), the unbias per element
  v2_biasfold    y = sum_b s_b * (x_b . n_b - 8 sum x_b), the bias folded
                 per block (K6's B = 1 arithmetic)
  v3_floor       y = x_lo . n_lo + x_hi . n_hi on the biased nibbles, no
                 scales: unpack plus dot (wrong math by design)
  v4_int8dot     y = xs * sum_b s_b * (xq_b . n_b - 8 sum xq_b): int8 x,
                 int32 dot products
  v5_u8mask      v2's function, the nibbles converted in the packed domain
  v6_bf16dot     y = x @ w with a bf16 weight [din, dout], f32 sums
  v7_unpackonly  y = x[0, 0] * bf16(sum over packed rows of (n_lo + n_hi)):
                 unpack alone

x [1, din] bf16 (v4: xq [1, din] int8 and xs, a bf16 scalar), q4 [din/2,
dout] uint8 in the split-half layout of weights/quantize.QuantWeight4 with
any nibble 0..15, scale [nb, dout] f32 (one scale per din/nb input rows;
v3 and v7 do not read it), out [1, dout] bf16. `<variant>_reference` is the
TPU body's arithmetic in plain PyTorch; `<variant>_cuda` launches the
kernel (csrc/int4_variants.cu) on CUDA tensors and raises ValueError on
what it does not take; `<variant>` takes the plain version for a CPU
tensor and the kernel for a CUDA one. `blk` is the columns per block of
the kernel's grid, as the TPU grid's (dout / blk blocks); `group` (4, 8 or
16; 4 by default) the consecutive packed rows a thread loads before the
arithmetic that uses them, which sets the loads in flight.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from .int4_matmul import _pick_block

MAX_STAGE_BYTES = 32 * 1024    # x staged in shared memory per block
_UNSCALED_UNIT = 64            # packed rows per split unit without scales
GROUPS = (4, 8, 16)            # packed rows per thread per step


# ---------------- plain versions ----------------

def _blocked(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
             dtype=torch.float32):
    """x as [2, nbh, bs] (halves, scale blocks, rows), the biased nibbles as
    [2, nbh, bs, dout] and the scales as [2, nbh, dout], in `dtype`."""
    dh, dout = q4.shape
    nb = scale.shape[0]
    if x.shape != (1, 2 * dh) or nb % 2 or dh % (nb // 2) or (
            scale.shape[1] != dout):
        raise ValueError(f"x {tuple(x.shape)}, q4 {tuple(q4.shape)} and scale "
                         f"{tuple(scale.shape)} do not fit together")
    nbh = nb // 2
    bs = dh // nbh
    n = torch.stack([q4 & 0xF, q4 >> 4]).to(dtype).reshape(2, nbh, bs, dout)
    return (x.to(dtype).reshape(2, nbh, bs), n,
            scale.float().reshape(2, nbh, dout))


def v1_current_reference(x, q4, scale):
    """Per block b and half: (x_b . (n_b - 8)) * s_b in f32, summed."""
    xf, n, s = _blocked(x.to(torch.bfloat16), q4, scale)
    part = torch.einsum("hbk,hbkd->hbd", xf, n - 8.0) * s
    return (part[0] + part[1]).sum(0, keepdim=True).to(torch.bfloat16)


def v2_biasfold_reference(x, q4, scale):
    """Per block b and half: (x_b . n_b - 8 sum x_b) * s_b in f32, summed."""
    xf, n, s = _blocked(x.to(torch.bfloat16), q4, scale)
    part = (torch.einsum("hbk,hbkd->hbd", xf, n)
            - 8.0 * xf.sum(-1, keepdim=True)) * s
    return (part[0] + part[1]).sum(0, keepdim=True).to(torch.bfloat16)


def v3_floor_reference(x, q4, scale=None):
    """x_lo @ n_lo + x_hi @ n_hi on the biased nibbles in f32; no scales."""
    dh = q4.shape[0]
    if x.shape != (1, 2 * dh):
        raise ValueError(f"x {tuple(x.shape)} does not fit q4 {tuple(q4.shape)}")
    xf = x.to(torch.bfloat16).float()
    return (xf[:, :dh] @ (q4 & 0xF).float()
            + xf[:, dh:] @ (q4 >> 4).float()).to(torch.bfloat16)


def v4_int8dot_reference(xq, xs, q4, scale):
    """Per block b and half: the int32 dot (xq_b . n_b - 8 sum xq_b), exact
    (here in f64), times s_b in f32, summed, times xs."""
    if xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8, got {xq.dtype}")
    xd, n, s = _blocked(xq, q4, scale, torch.float64)
    dot = (torch.einsum("hbk,hbkd->hbd", xd, n)
           - 8.0 * xd.sum(-1, keepdim=True))
    part = dot.float() * s
    y = (part[0] + part[1]).sum(0, keepdim=True)
    return (y * xs.to(torch.bfloat16).float().reshape(())).to(torch.bfloat16)


def v5_u8mask_reference(x, q4, scale):
    """v2's function: the TPU body differs only in how it converts."""
    return v2_biasfold_reference(x, q4, scale)


def v6_bf16dot_reference(x, w):
    """x @ w in f32 from bf16 operands, rounded to bf16."""
    if x.dim() != 2 or x.shape[0] != 1 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not fit w {tuple(w.shape)}")
    return (x.to(torch.bfloat16).float()
            @ w.to(torch.bfloat16).float()).to(torch.bfloat16)


def v7_unpackonly_reference(x, q4, scale=None):
    """The column sums of n_lo + n_hi rounded to bf16, times x[0, 0],
    rounded again (the TPU body sums and multiplies in bf16; the integer
    sums are exact in f32, so only the two roundings matter)."""
    acc = ((q4 & 0xF).float() + (q4 >> 4).float()).sum(0, keepdim=True)
    x00 = x.reshape(-1)[0].to(torch.bfloat16).float()
    return (acc.to(torch.bfloat16).float() * x00).to(torch.bfloat16)


# ---------------- kernels ----------------

@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(rows: int, unit: int, stage_per_row: int, blocks_x: int,
          device_index: int) -> tuple:
    """(splits, rows per split): whole units (a scale block, or 64 rows) per
    split, enough splits for two blocks per SM, the staged x under
    MAX_STAGE_BYTES."""
    if unit * stage_per_row > MAX_STAGE_BYTES:
        raise ValueError(f"a split of {unit} rows stages {unit * stage_per_row}"
                         f" bytes of x, more than {MAX_STAGE_BYTES}")
    units = -(-rows // unit)
    want = -(-2 * _sm_count(device_index) // blocks_x)
    per = max(1, -(-units // want))
    if stage_per_row:
        per = min(per, MAX_STAGE_BYTES // (unit * stage_per_row))
    rows_per_split = per * unit
    return -(-rows // rows_per_split), rows_per_split


def _check_blk(name: str, dout: int, blk: Optional[int]) -> int:
    """blk, by default K6's: 512, 384, 256 or 128, whichever divides dout
    first (0, refused, if none does)."""
    blk = _pick_block(dout) if blk is None else blk
    if blk < 8 or blk > 2048 or blk % 8 or dout % blk:
        raise ValueError(f"{name}: blk {blk} must be a multiple of 8 up to "
                         f"2048 that divides dout {dout}")
    return blk


def _check_group(name: str, group: int, *rows: int) -> None:
    if group not in GROUPS or any(r % group for r in rows):
        raise ValueError(f"{name}: group {group} must be one of {GROUPS} and "
                         f"divide the rows per scale block and per half "
                         f"{rows}")


def _on_card(name: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name} takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    return dev


def _launch_int4(fn, x, q4, scale, aux, blk, group, x_dtype, scaled,
                 stage_per_row):
    name = fn.__name__
    dev = _on_card(name, x, q4, scale, *([aux] if aux is not None else []))
    if q4.dim() != 2 or scale.dim() != 2 or x.dim() != 2:
        raise ValueError(f"{name} takes x [1, din], q4 [dh, dout], scale "
                         f"[nb, dout]; got {tuple(x.shape)}, {tuple(q4.shape)}"
                         f", {tuple(scale.shape)}")
    dh, dout = q4.shape
    nb = scale.shape[0]
    if x.shape != (1, 2 * dh) or scale.shape[1] != dout:
        raise ValueError(f"{name}: x {tuple(x.shape)}, q4 {tuple(q4.shape)} "
                         f"and scale {tuple(scale.shape)} do not fit together")
    if x.dtype != x_dtype or q4.dtype != torch.uint8 or (
            scale.dtype != torch.float32):
        raise ValueError(f"{name} takes x {x_dtype}, q4 uint8 and scale f32, "
                         f"got {x.dtype}, {q4.dtype}, {scale.dtype}")
    if not (x.is_contiguous() and q4.is_contiguous()
            and scale.is_contiguous()) or q4.data_ptr() % 8 or (
                scale.data_ptr() % 16):
        raise ValueError(f"{name}: x, q4 and scale must be contiguous, q4 "
                         f"8-byte and scale 16-byte aligned")
    if nb < 2 or nb % 2 or dh % (nb // 2) or (dh // (nb // 2)) % 4 or dh % 4:
        raise ValueError(f"{name}: dh {dh} must split into nb/2 = {nb // 2} "
                         f"scale blocks of a multiple of 4 rows")
    blk = _check_blk(name, dout, blk)
    unit = dh // (nb // 2) if scaled else _UNSCALED_UNIT
    _check_group(name, group, dh, unit)
    splits, rows = _plan(dh, unit, stage_per_row, dout // blk, dev.index)
    partial = torch.empty((splits, dout), dtype=torch.float32, device=dev)
    out = torch.empty((1, dout), dtype=torch.bfloat16, device=dev)
    rc = getattr(_build.library(), f"fvt_int4_{name[:-5]}")(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(),
        aux.data_ptr() if aux is not None else None, partial.data_ptr(),
        out.data_ptr(), dh, dout, nb, blk, splits, rows, group,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    fn.launches += 1
    return out


def v1_current_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v1."""
    return _launch_int4(v1_current_cuda, x, q4, scale, None, blk, group,
                        torch.bfloat16, True, 8)


def v2_biasfold_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v2."""
    return _launch_int4(v2_biasfold_cuda, x, q4, scale, None, blk, group,
                        torch.bfloat16, True, 8)


def v3_floor_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v3 (scale is checked, not read)."""
    return _launch_int4(v3_floor_cuda, x, q4, scale, None, blk, group,
                        torch.bfloat16, False, 8)


def v4_int8dot_cuda(xq, xs, q4, scale, *, blk=None, group=4):
    """Launch P3 v4: xq [1, din] int8, xs a bf16 scalar ([] or [1, 1])."""
    if xs.numel() != 1 or xs.dtype != torch.bfloat16:
        raise ValueError(f"v4_int8dot_cuda takes xs as one bf16 value, got "
                         f"{xs.dtype} {tuple(xs.shape)}")
    return _launch_int4(v4_int8dot_cuda, xq, q4, scale, xs.contiguous(), blk,
                        group, torch.int8, True, 2)


def v5_u8mask_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v5."""
    return _launch_int4(v5_u8mask_cuda, x, q4, scale, None, blk, group,
                        torch.bfloat16, True, 8)


def v7_unpackonly_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v7 (scale is checked, not read)."""
    return _launch_int4(v7_unpackonly_cuda, x, q4, scale, x, blk, group,
                        torch.bfloat16, False, 0)


def v6_bf16dot_cuda(x, w, *, blk=None, group=4):
    """Launch P4: x [1, din] bf16 @ w [din, dout] bf16, din a multiple of
    group, w 16-byte aligned."""
    dev = _on_card("v6_bf16dot_cuda", x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape != (1, w.shape[0]):
        raise ValueError(f"v6_bf16dot_cuda takes x [1, din] and w [din, "
                         f"dout]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"v6_bf16dot_cuda takes bf16, got {x.dtype}, "
                         f"{w.dtype}")
    din, dout = w.shape
    if not (x.is_contiguous() and w.is_contiguous()) or w.data_ptr() % 16:
        raise ValueError("v6_bf16dot_cuda: x and w must be contiguous, w "
                         "16-byte aligned")
    blk = _check_blk("v6_bf16dot_cuda", dout, blk)
    _check_group("v6_bf16dot_cuda", group, din)
    splits, rows = _plan(din, _UNSCALED_UNIT, 4, dout // blk, dev.index)
    partial = torch.empty((splits, dout), dtype=torch.float32, device=dev)
    out = torch.empty((1, dout), dtype=torch.bfloat16, device=dev)
    rc = _build.library().fvt_bf16_v6_bf16dot(
        x.data_ptr(), w.data_ptr(), partial.data_ptr(), out.data_ptr(), din,
        dout, blk, splits, rows, group,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "v6_bf16dot_cuda")
    v6_bf16dot_cuda.launches += 1
    return out


KERNELS = (v1_current_cuda, v2_biasfold_cuda, v3_floor_cuda, v4_int8dot_cuda,
           v5_u8mask_cuda, v6_bf16dot_cuda, v7_unpackonly_cuda)
for _fn in KERNELS:
    _fn.launches = 0


# ---------------- dispatch by device ----------------

def v1_current(x, q4, scale, *, blk=None):
    if x.device.type == "cpu":
        return v1_current_reference(x, q4, scale)
    return v1_current_cuda(x, q4, scale, blk=blk)


def v2_biasfold(x, q4, scale, *, blk=None):
    if x.device.type == "cpu":
        return v2_biasfold_reference(x, q4, scale)
    return v2_biasfold_cuda(x, q4, scale, blk=blk)


def v3_floor(x, q4, scale, *, blk=None):
    if x.device.type == "cpu":
        return v3_floor_reference(x, q4, scale)
    return v3_floor_cuda(x, q4, scale, blk=blk)


def v4_int8dot(xq, xs, q4, scale, *, blk=None):
    if xq.device.type == "cpu":
        return v4_int8dot_reference(xq, xs, q4, scale)
    return v4_int8dot_cuda(xq, xs, q4, scale, blk=blk)


def v5_u8mask(x, q4, scale, *, blk=None):
    if x.device.type == "cpu":
        return v5_u8mask_reference(x, q4, scale)
    return v5_u8mask_cuda(x, q4, scale, blk=blk)


def v6_bf16dot(x, w, *, blk=None):
    if x.device.type == "cpu":
        return v6_bf16dot_reference(x, w)
    return v6_bf16dot_cuda(x, w, blk=blk)


def v7_unpackonly(x, q4, scale, *, blk=None):
    if x.device.type == "cpu":
        return v7_unpackonly_reference(x, q4, scale)
    return v7_unpackonly_cuda(x, q4, scale, blk=blk)
