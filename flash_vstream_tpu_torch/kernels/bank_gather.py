"""Bank gather out[i] = bank[idx[i]] through the bulk-copy engine: the CUDA
kernel P1 and its plain version.

Replaces the Pallas TPU kernel `gather_kernel`
(scripts/probe_bank_gather.py:81), the DAM-gather probe's scalar-prefetch
grid with one DMA per bank row. It computes what K2 (kernels/gather_rows.py)
computes, by the TPU kernel's route: the rows stream through shared memory
by `cp.async.bulk` loads and stores (csrc/bank_gather.cu), where K2 copies
through the threads' registers. The kernel's grid is one wave:
`bank_gather_plan` cuts each row into equal shares for at most the blocks
the card holds at once, and `block_copies` lists the bulk copies a block
makes, as the kernel does (the CPU tests hold both). The probe
(`flash_vstream_tpu_torch.scripts.probe_bank_gather`) times the two routes
side by side and sweeps the kernel's ring. Dispatch is by device: a CPU
tensor takes `bank_gather_reference` (`index_select`), a CUDA tensor
launches the kernel (`bank_gather_cuda`), which raises on what it does not
take.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from . import _build

UNIT = 16                 # bytes: the bulk copy's size and address unit
# the shares' unit: the largest power of two up to ALIGN bytes that
# divides the rows. A cut inside a 32-byte DRAM sector, two blocks storing
# into it, cost about 3 us at the probe's shape on an H100 (PERF.md, PR 15)
ALIGN = 128


class BankGatherPlan(NamedTuple):
    """P1's grid (splits, rows): block (c, y) copies share c of rows y,
    y + rows, ...; share c of a row takes share + unit bytes for c <
    extra, else share, from c * share + unit * min(c, extra)."""
    splits: int
    rows: int
    share: int
    extra: int
    unit: int

    @property
    def blocks(self) -> int:
        return self.splits * self.rows


def bank_gather_plan(n_idx: int, row_bytes: int, resident: int,
                     stage_bytes: int) -> BankGatherPlan:
    """One wave for `resident` blocks (those the card holds at once): each
    row cut into resident // n_idx shares (at least 1) of units of
    gcd(row_bytes, ALIGN) bytes, no more than the row has stages of
    `stage_bytes` (a block of less adds no bytes in flight, only a block
    to start) or units; where the rows outnumber the blocks, each of
    `resident` blocks takes whole rows."""
    if n_idx < 1 or row_bytes < UNIT or row_bytes % UNIT or resident < 1:
        raise ValueError(f"bank_gather_plan takes K >= 1, rows a multiple of "
                         f"{UNIT} bytes and resident >= 1; got {n_idx}, "
                         f"{row_bytes}, {resident}")
    unit = math.gcd(row_bytes, ALIGN)
    units = row_bytes // unit
    splits = max(1, min(resident // n_idx, -(-row_bytes // stage_bytes),
                        units))
    return BankGatherPlan(splits, min(n_idx, resident),
                          unit * (units // splits), units % splits, unit)


def block_copies(plan: BankGatherPlan, n_idx: int, row_bytes: int,
                 stage_bytes: int, block: int) -> List[Tuple[int, int, int]]:
    """The bulk copies (output row, offset into the row, bytes) block
    `block` (share block % splits of rows block // splits, + plan.rows,
    ...) makes, in order, as csrc/bank_gather.cu cuts its share: pieces of
    at most a stage, each loaded and stored by one copy."""
    y, c = divmod(block, plan.splits)
    begin = c * plan.share + plan.unit * min(c, plan.extra)
    length = plan.share + (plan.unit if c < plan.extra else 0)
    return [(row, begin + lo, min(stage_bytes, length - lo))
            for row in range(y, n_idx, plan.rows)
            for lo in range(0, length, stage_bytes)]


def bank_gather_reference(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [T, P, D], idx [K] -> [K, P, D]."""
    return bank.index_select(0, idx)


@functools.lru_cache(maxsize=None)
def card_ring(device_index: int) -> Tuple[int, int, int]:
    """(the blocks of P1's kernel the card holds at once, asked of the
    driver: its occupancy times the SMs; the kernel's stage bytes; its
    stages), once per device."""
    ring = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        n = _build.library().fvt_bank_gather_resident(ring)
    if n < 0:
        _build.check(-n, "fvt_bank_gather_resident")
    if n == 0:
        raise ValueError(f"P1's kernel does not fit an SM with {ring[1]} "
                         f"stages of {ring[0]} bytes")
    return n, ring[0], ring[1]


def card_plan(n_idx: int, row_bytes: int,
              device_index: int) -> BankGatherPlan:
    """The plan the wrapper launches on this card."""
    resident, stage_bytes, _ = card_ring(device_index)
    return bank_gather_plan(n_idx, row_bytes, resident, stage_bytes)


def bank_gather_cuda(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch P1. bank: contiguous [T, P, D] bf16 or f32 on the card, 16-byte
    aligned, rows a multiple of 16 bytes (the bulk copy's unit); idx:
    contiguous int32 [K] on the same card, in range (callers clamp, as in
    JAX). Repeated indices are fine. The grid the kernel launched is kept
    as `bank_gather_cuda.grid` (x, y)."""
    if not bank.is_cuda:
        raise ValueError(f"bank_gather_cuda takes a CUDA bank, got one on "
                         f"{bank.device}")
    if bank.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bank_gather_cuda takes bf16 or f32 banks, got "
                         f"{bank.dtype}")
    if bank.dim() != 3 or not bank.is_contiguous() or bank.data_ptr() % 16:
        raise ValueError(f"bank must be a contiguous, 16-byte aligned "
                         f"[T, P, D] tensor, got shape {tuple(bank.shape)} "
                         f"strides {bank.stride()}")
    row_bytes = bank.shape[1] * bank.shape[2] * bank.element_size()
    if row_bytes % UNIT:
        raise ValueError(f"bank rows are {row_bytes} bytes, not a multiple "
                         f"of {UNIT} (the bulk copy's unit)")
    if (idx.device != bank.device or idx.dtype != torch.int32
            or idx.dim() != 1 or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous int32 [K] tensor on "
                         f"{bank.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    out = torch.empty((idx.shape[0], *bank.shape[1:]), dtype=bank.dtype,
                      device=bank.device)
    if out.numel() == 0:
        return out
    plan = card_plan(idx.shape[0], row_bytes, bank.device.index)
    grid = (ctypes.c_int * 2)()
    rc = _build.library().fvt_bank_gather(
        bank.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        row_bytes, plan.splits, plan.rows, plan.share, plan.extra, plan.unit,
        grid,
        torch.cuda.current_stream(bank.device).cuda_stream)
    _build.check(rc, "bank_gather_cuda")
    bank_gather_cuda.launches += 1
    bank_gather_cuda.grid = (grid[0], grid[1])
    return out


bank_gather_cuda.launches = 0
bank_gather_cuda.grid = None


def bank_gather(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [T, P, D], idx [K] int32 -> [K, P, D]. idx must be in range."""
    if bank.device.type == "cpu":
        return bank_gather_reference(bank, idx)
    return bank_gather_cuda(bank, idx)
