"""Bank gather out[i] = bank[idx[i]] through the bulk-copy engine: the CUDA
kernel P1 and its plain version.

Replaces the Pallas TPU kernel `gather_kernel`
(scripts/probe_bank_gather.py:81), the DAM-gather probe's scalar-prefetch
grid with one DMA per bank row. It computes what K2 (kernels/gather_rows.py)
computes, by the TPU kernel's route: each row streams through shared memory
by `cp.async.bulk` loads and stores (csrc/bank_gather.cu), where K2 copies
through the threads' registers. The probe
(`flash_vstream_tpu_torch.scripts.probe_bank_gather`) times the two side by
side. Dispatch is by device: a CPU tensor takes `bank_gather_reference`
(`index_select`), a CUDA tensor launches the kernel (`bank_gather_cuda`),
which raises on what it does not take.
"""
from __future__ import annotations

import torch

from . import _build


def bank_gather_reference(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [T, P, D], idx [K] -> [K, P, D]."""
    return bank.index_select(0, idx)


def bank_gather_cuda(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch P1. bank: contiguous [T, P, D] bf16 or f32 on the card, 16-byte
    aligned, rows a multiple of 16 bytes (the bulk copy's unit); idx:
    contiguous int32 [K] on the same card, K <= 65535, in range (callers
    clamp, as in JAX). Repeated indices are fine."""
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
    if row_bytes % 16:
        raise ValueError(f"bank rows are {row_bytes} bytes, not a multiple "
                         f"of 16 (the bulk copy's unit)")
    if (idx.device != bank.device or idx.dtype != torch.int32
            or idx.dim() != 1 or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous int32 [K] tensor on "
                         f"{bank.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    if idx.shape[0] > 65535:
        raise ValueError(f"at most 65535 rows per launch (the grid's y "
                         f"limit), got {idx.shape[0]}")
    out = torch.empty((idx.shape[0], *bank.shape[1:]), dtype=bank.dtype,
                      device=bank.device)
    if out.numel() == 0:
        return out
    rc = _build.library().fvt_bank_gather(
        bank.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        row_bytes, torch.cuda.current_stream(bank.device).cuda_stream)
    _build.check(rc, "bank_gather_cuda")
    bank_gather_cuda.launches += 1
    return out


bank_gather_cuda.launches = 0


def bank_gather(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [T, P, D], idx [K] int32 -> [K, P, D]. idx must be in range."""
    if bank.device.type == "cpu":
        return bank_gather_reference(bank, idx)
    return bank_gather_cuda(bank, idx)
