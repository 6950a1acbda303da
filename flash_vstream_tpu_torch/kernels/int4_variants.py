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
tensor and the kernel for a CUDA one. `group` (4, 8 or 16; 4 by default)
is the packed rows a thread loads before the arithmetic that uses them,
which sets the loads in flight.

v1, v2, v3 and v5 run K6's B = 1 kernel (csrc/int4_b1.cuh) with the
Unbiased, PerElement, Floor and Packed conversions: one launch a matvec at
the shapes K6's gate takes, a grid of K6's 128-column warp tiles (dout /
128 of them, so dout must be a multiple of 128) and K6's plan of the packed
rows (int4_matmul.py `_plan`); `blk` is checked as for the others and not
used; `group` sets the steps of loads in flight (`load_depth`: a lane
loads 4 packed rows a step). A shape outside K6's gate raises ValueError.
`per_element_pair` and `per_element_fragment` mirror the per-element
conversion for the CPU tests, `unbias_pair` and `unbiased_fragment` the
unbiased one, as int4_matmul.py's `magic_nibbles` and `fragment_map` mirror
the packed one (Floor's fragments are Packed's). v6 runs a B = 1 kernel
of its own (csrc/bf16_b1.cuh) on the same one-launch cluster form: bf16
fragments paired from the loaded rows by byte_perm, 64-column warp tiles
(dout a multiple of 64, din of 16), its plan `bf16_plan`, `group` as for
v1-v3 and v5; `bf16_fragment` mirrors its fragment map. v4 and v7 run one
skeleton: `blk` columns per block, as the TPU grid's (dout / blk blocks),
f32 partials over splits of the packed rows summed by a second launch.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from .int4_matmul import (STEP_ROWS, WARP_COLS, WARPS_PER_SM, Int4Plan,
                          _b1_plans, _byte_perm, _pick_block,
                          _plan as _k6_plan, _sms, fragment_map,
                          int4_matmul_supported)

MAX_STAGE_BYTES = 32 * 1024    # x staged in shared memory per block
_UNSCALED_UNIT = 64            # packed rows per split unit without scales
GROUPS = (4, 8, 16)            # packed rows per thread per step
# P4's B = 1 kernel (csrc/bf16_b1.cuh): 64 output columns a warp and a
# block, 16 rows a step, 1, 2, 4 or 8 warps a block
P4_WARP_COLS = 64
P4_WARPS = (1, 2, 4, 8)
_INVALID_VALUE = 1             # cudaErrorInvalidValue


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


def v1_current_reference(x, q4, scale, out_dtype=torch.bfloat16):
    """Per block b and half: (x_b . (n_b - 8)) * s_b in f32, summed, in
    `out_dtype` (the TPU body's bf16 by default)."""
    xf, n, s = _blocked(x.to(torch.bfloat16), q4, scale)
    part = torch.einsum("hbk,hbkd->hbd", xf, n - 8.0) * s
    return (part[0] + part[1]).sum(0, keepdim=True).to(out_dtype)


def v2_biasfold_reference(x, q4, scale, out_dtype=torch.bfloat16):
    """Per block b and half: (x_b . n_b - 8 sum x_b) * s_b in f32, summed,
    in `out_dtype` (the TPU body's bf16 by default)."""
    xf, n, s = _blocked(x.to(torch.bfloat16), q4, scale)
    part = (torch.einsum("hbk,hbkd->hbd", xf, n)
            - 8.0 * xf.sum(-1, keepdim=True)) * s
    return (part[0] + part[1]).sum(0, keepdim=True).to(out_dtype)


def v3_floor_reference(x, q4, scale=None, out_dtype=torch.bfloat16):
    """x_lo @ n_lo + x_hi @ n_hi on the biased nibbles in f32; no scales;
    in `out_dtype` (the TPU body's bf16 by default)."""
    dh = q4.shape[0]
    if x.shape != (1, 2 * dh):
        raise ValueError(f"x {tuple(x.shape)} does not fit q4 {tuple(q4.shape)}")
    xf = x.to(torch.bfloat16).float()
    return (xf[:, :dh] @ (q4 & 0xF).float()
            + xf[:, dh:] @ (q4 >> 4).float()).to(out_dtype)


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


def v5_u8mask_reference(x, q4, scale, out_dtype=torch.bfloat16):
    """v2's function: the TPU body differs only in how it converts."""
    return v2_biasfold_reference(x, q4, scale, out_dtype)


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


# ---------- v2's and v1's conversions, mirrored for the CPU tests ----------

def per_element_pair(n0: int, n1: int) -> int:
    """The bf16x2 bits csrc/int4_b1.cuh `PerElement::pair` makes of two
    nibbles: each converted to f32 on its own, the pair rounded to bf16
    (`__floats2bfloat162_rn`), n0 in the low half."""
    bits = torch.tensor([float(n0), float(n1)]).to(torch.bfloat16).view(
        torch.int16).tolist()
    return (bits[0] & 0xFFFF) | ((bits[1] & 0xFFFF) << 16)


def per_element_fragment(w, j: int, lane: int) -> tuple:
    """The A fragment (a0..a3) that lane `lane` builds for tile j from a
    step's packed bytes w [16, 128] uint8 in P3 v2, as csrc/int4_b1.cuh
    `PerElement::tile` does: byte j % 4 of word j / 4 of the lane's rows
    4t4..4t4+3 at columns 16g..16g+15 (column 16g + j), each nibble masked
    out of it; a0 the low nibbles of rows 0 and 1, a1 their high nibbles,
    a2 and a3 the same of rows 2 and 3."""
    g, t4 = lane // 4, lane % 4
    rows = [int.from_bytes(bytes(w[4 * t4 + r, 16 * g:16 * g + 16]),
                           "little") for r in range(4)]
    b = [(rows[r] >> (32 * (j >> 2) + 8 * (j & 3))) & 0xFF for r in range(4)]
    return (per_element_pair(b[0] & 15, b[1] & 15),
            per_element_pair(b[0] >> 4, b[1] >> 4),
            per_element_pair(b[2] & 15, b[3] & 15),
            per_element_pair(b[2] >> 4, b[3] >> 4))


def unbias_pair(bits: int) -> int:
    """The bf16x2 bits csrc/int4_b1.cuh `Unbiased::tile` makes of a Packed
    word (bf16 128 + n in each half): each half less 136 in f32, rounded to
    bf16 (`__hsub2`: the difference of two bf16 rounded once)."""
    signed = [h - 0x10000 if h & 0x8000 else h
              for h in (bits & 0xFFFF, bits >> 16)]
    halves = torch.tensor(signed, dtype=torch.int16).view(
        torch.bfloat16).float()
    out = (halves - 136.0).to(torch.bfloat16).view(torch.int16).tolist()
    return (out[0] & 0xFFFF) | ((out[1] & 0xFFFF) << 16)


def unbiased_fragment(w, j: int, lane: int) -> tuple:
    """The A fragment (a0..a3) that lane `lane` builds for tile j from a
    step's packed bytes w [16, 128] uint8 in P3 v1: Packed's
    (int4_matmul.py `fragment_map`), each word less bf16x2 (136, 136)."""
    return tuple(unbias_pair(a) for a in fragment_map(w, j, lane))


# ---------- P4's fragment map and plan, mirrored for the CPU tests ----------

def bf16_fragment(w, j: int, lane: int) -> tuple:
    """The A fragment (a0..a3, 32-bit words of two bf16 each) that lane
    `lane` builds for tile j from a step's weights w [16, 64] (the bf16 bits
    as uint16: rows of the step, the warp's columns), as csrc/bf16_b1.cuh
    does: the lane's four 16-byte words are rows 4t4..4t4+3 at columns
    8g..8g+7; word j of a row holds columns 8g + 2j (low half) and
    8g + 2j + 1; a0 pairs rows 0 and 1 of the low column (byte_perm
    0x5410), a1 of the high one (0x7632), a2 and a3 the same of rows 2 and
    3. A row g of the tile is column `bf16_fragment_cols(lane, j)[0]`, A
    row g + 8 column [1]; the k slots are int4_matmul.py
    `fragment_k_rows`."""
    g, t4 = lane // 4, lane % 4
    rows = [int.from_bytes(bytes(w[4 * t4 + r, 8 * g:8 * g + 8]
                                 .astype("<u2").tobytes()), "little")
            for r in range(4)]
    word = lambda r: (rows[r] >> (32 * j)) & 0xFFFFFFFF  # noqa: E731
    return (_byte_perm(word(0), word(1), 0x5410),
            _byte_perm(word(0), word(1), 0x7632),
            _byte_perm(word(2), word(3), 0x5410),
            _byte_perm(word(2), word(3), 0x7632))


def bf16_fragment_cols(lane: int, j: int) -> tuple:
    """The warp's columns of A rows g and g + 8 in tile j: 8g + 2j and
    8g + 2j + 1 (lane (g, 0)'s c0 and c2 sum them)."""
    g = lane // 4
    return 8 * g + 2 * j, 8 * g + 2 * j + 1


def bf16_plan(din: int, dout: int, sms: int, clusters=None) -> Int4Plan:
    """P4's launch: `split` ranks of one cluster along the rows (1..8),
    `warps` warps a block (1, 2, 4 or 8), `rows` rows a rank (a multiple of
    16). `clusters(split, warps)` is how many such clusters the card holds
    at once; on the card it is CUDA's occupancy of the kernel's instance
    (`cudaOccupancyMaxActiveClusters`), by default the arithmetic of its
    cap of 128 registers,
    WARPS_PER_SM // warps * sms // split.

    The arithmetic. A warp streams 64 columns of 16 rows a step, 2 KB, the
    bytes of a K6 step; K6 streams fastest at 16 warps an SM, 32 KB of
    loads in flight. At the probe's [3584, 18944] there are 296 column
    tiles and 224 steps a tile. One 4-warp block a tile (K6's rule at one
    rank) is 1,184 warps, 56% of the 2,112 of 16 an SM on 132 SMs;
    128-column warps (K6's 148 tiles) at 3 ranks x 4 warps are 1,776, 84%,
    with twice the load registers; 64-column tiles in 7 ranks of one warp
    are 2,072, 98%, and at 54 registers (group 4) the card holds more: one
    rank of 8 warps is 2,368, 18 an SM. Every rank a tile adds a cluster
    barrier and a DSMEM sum (about 1 us, K6's probe). The sweep on an H100
    at group 4 (PERF.md, scripts/probe_bf16_b1.py --sweep) ran 1 x 8
    fastest (0.0457-0.0458 ms), 2 x 4 at 0.0463-0.0466 (as many warps, two
    ranks), 3 x 4 at 0.0474-0.0476 (3,552 warps), 1 x 4 at 0.0529-0.0534
    and 7 x 1 at 0.0772-0.0775 (not resident: 139 clusters); at group 16
    (108 registers) 3 x 2 fastest. So: of the plans whose whole grid is
    resident at once
    (tiles <= clusters(split, warps)) and whose warps have a step each at
    least, those that reach WARPS_PER_SM warps an SM with the fewest
    ranks, then the fewest warps, then the most warps a block; where none
    reaches it, the most warps, then the most warps a block; where none is
    resident, one cluster-free 4-warp block a tile in waves."""
    tiles = dout // P4_WARP_COLS
    if dout % P4_WARP_COLS or din % STEP_ROWS or not tiles or not din:
        raise ValueError(f"bf16_plan takes din a multiple of {STEP_ROWS} and "
                         f"dout of {P4_WARP_COLS}, got {din}, {dout}")
    if clusters is None:
        clusters = lambda split, warps: (  # noqa: E731
            WARPS_PER_SM // warps * sms // split)
    fits = [p for w in P4_WARPS for p in _b1_plans(din, tiles, w)
            if p.split * p.warps * STEP_ROWS <= din
            and tiles <= clusters(p.split, p.warps)]
    full = [p for p in fits
            if tiles * p.split * p.warps >= WARPS_PER_SM * sms]
    if full:
        return min(full, key=lambda p: (p.split, p.split * p.warps,
                                        -p.warps))
    if fits:
        return max(fits, key=lambda p: (p.split * p.warps, p.warps))
    return Int4Plan(1, 4, din)


def _card_clusters(split: int, warps: int, depth: int = 1) -> int:
    """The clusters of P4's kernel at `depth` steps of loads in flight that
    the current card holds at once."""
    n = _build.library().fvt_bf16_v6_clusters(split, warps, depth)
    if n < 0:
        _build.check(-n, "fvt_bf16_v6_clusters")
    return n


@functools.lru_cache(maxsize=None)
def _p4_plan(din: int, dout: int, device_index: int, depth: int = 1
             ) -> Int4Plan:
    with torch.cuda.device(device_index):
        return bf16_plan(din, dout, _sms(device_index), functools.partial(
            _card_clusters, depth=depth))


# ---------------- kernels ----------------

def load_depth(group: int) -> int:
    """The steps of loads in flight of v2 and v5 for the probe's `group`:
    a lane of K6's B = 1 kernel loads 4 packed rows a 16-row step, so group
    4 is one step (K6's own depth), 8 two and 16 four."""
    if group not in GROUPS:
        raise ValueError(f"group {group} must be one of {GROUPS}")
    return group // 4


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
    want = -(-2 * _sms(device_index) // blocks_x)
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


def _check_operands(name, x, q4, scale, aux, x_dtype, align):
    """The operands' device, shapes, types and layout (contiguous, q4
    `align`-byte and scale 16-byte aligned); returns (device, dh, dout,
    nb)."""
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
            and scale.is_contiguous()) or q4.data_ptr() % align or (
                scale.data_ptr() % 16):
        raise ValueError(f"{name}: x, q4 and scale must be contiguous, q4 "
                         f"{align}-byte and scale 16-byte aligned")
    return dev, dh, dout, nb


def _launch_int4(fn, x, q4, scale, aux, blk, group, x_dtype, scaled,
                 stage_per_row):
    name = fn.__name__
    dev, dh, dout, nb = _check_operands(name, x, q4, scale, aux, x_dtype, 8)
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


def _launch_fold(fn, x, q4, scale, blk, group, plan=None):
    """v1, v2, v3 or v5 (by `fn`) as one launch of K6's B = 1 kernel, at the
    shapes K6's gate takes and with K6's plan; `plan` overrides it (the card
    tests hold every plan to the same result). v3's scale is checked as the
    others' and not read."""
    name = fn.__name__
    dev, dh, dout, nb = _check_operands(name, x, q4, scale, None,
                                        torch.bfloat16, 16)
    if x.data_ptr() % 8:
        raise ValueError(f"{name}: x must be 8-byte aligned")
    _check_blk(name, dout, blk)
    if dout % WARP_COLS:
        raise ValueError(f"{name}: dout {dout} must be a multiple of the "
                         f"kernel's {WARP_COLS}-column warp tiles")
    if not int4_matmul_supported(1, dh, nb, dout):
        raise ValueError(f"{name}: dh {dh} must be a multiple of 32 and "
                         f"split into nb/2 = {nb // 2} scale blocks of a "
                         f"multiple of 8 rows (K6's gate)")
    depth = load_depth(group)
    if plan is None:
        plan = _k6_plan(1, dh, nb, dout, _sms(dev.index))
    out = torch.empty((1, dout), dtype=torch.bfloat16, device=dev)
    rc = getattr(_build.library(), f"fvt_int4_{name[:-5]}")(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(), dh,
        dout, nb, *plan, depth, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    fn.launches += 1
    return out


def v1_current_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v1: K6's B = 1 kernel, each pair unbiased by a bf16x2
    subtract."""
    return _launch_fold(v1_current_cuda, x, q4, scale, blk, group)


def v2_biasfold_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v2: K6's B = 1 kernel, each nibble converted on its own."""
    return _launch_fold(v2_biasfold_cuda, x, q4, scale, blk, group)


def v3_floor_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v3: K6's B = 1 kernel without scales (scale is checked,
    not read)."""
    return _launch_fold(v3_floor_cuda, x, q4, scale, blk, group)


def v4_int8dot_cuda(xq, xs, q4, scale, *, blk=None, group=4):
    """Launch P3 v4: xq [1, din] int8, xs a bf16 scalar ([] or [1, 1])."""
    if xs.numel() != 1 or xs.dtype != torch.bfloat16:
        raise ValueError(f"v4_int8dot_cuda takes xs as one bf16 value, got "
                         f"{xs.dtype} {tuple(xs.shape)}")
    return _launch_int4(v4_int8dot_cuda, xq, q4, scale, xs.contiguous(), blk,
                        group, torch.int8, True, 2)


def v5_u8mask_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v5: K6's B = 1 kernel, two nibbles converted at a time."""
    return _launch_fold(v5_u8mask_cuda, x, q4, scale, blk, group)


def v7_unpackonly_cuda(x, q4, scale, *, blk=None, group=4):
    """Launch P3 v7 (scale is checked, not read)."""
    return _launch_int4(v7_unpackonly_cuda, x, q4, scale, x, blk, group,
                        torch.bfloat16, False, 0)


def v6_bf16dot_cuda(x, w, *, blk=None, group=4, plan=None):
    """Launch P4: x [1, din] bf16 @ w [din, dout] bf16 as one launch of its
    B = 1 kernel (csrc/bf16_b1.cuh), din a multiple of 16 (and of group),
    dout of 64, w 16-byte and x 8-byte aligned; `blk` is checked as for the
    others and not used; `plan` overrides `bf16_plan`'s (the card tests
    hold every plan to the same result)."""
    name = "v6_bf16dot_cuda"
    dev = _on_card(name, x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape != (1, w.shape[0]):
        raise ValueError(f"{name} takes x [1, din] and w [din, dout]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16, got {x.dtype}, {w.dtype}")
    din, dout = w.shape
    if not (x.is_contiguous() and w.is_contiguous()) or w.data_ptr() % 16 \
            or x.data_ptr() % 8:
        raise ValueError(f"{name}: x and w must be contiguous, w 16-byte and "
                         "x 8-byte aligned")
    _check_blk(name, dout, blk)
    _check_group(name, group, din)
    if din % STEP_ROWS or dout % P4_WARP_COLS:
        raise ValueError(f"{name}: din {din} must be a multiple of "
                         f"{STEP_ROWS} and dout {dout} of the kernel's "
                         f"{P4_WARP_COLS}-column warp tiles")
    depth = load_depth(group)
    if plan is None:
        plan = _p4_plan(din, dout, dev.index, depth)
    out = torch.empty((1, dout), dtype=torch.bfloat16, device=dev)
    rc = _build.library().fvt_bf16_v6_bf16dot(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), din, dout, *plan, depth,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc == _INVALID_VALUE:
        raise ValueError(f"{name}: the kernel does not take din {din}, dout "
                         f"{dout}, plan {tuple(plan)}, depth {depth}")
    _build.check(rc, name)
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
