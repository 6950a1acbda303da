"""Row gather out[i] = bank[idx[i]]: the CUDA kernel K2 and its plain version.

Replaces the Pallas TPU kernel `_copy_kernel`
(flash_vstream_tpu/kernels/gather_rows.py:23). The DAM retrieval gathers 30
full-resolution frames ([P, D] rows of 640 KB in bf16) out of the streaming
ring bank on every ingest. Dispatch is by device: a CPU tensor takes
`gather_rows_reference` (`index_select`), a CUDA tensor launches the kernel
(`gather_rows_cuda`), which raises on what it does not take.

`gather_rows_batched` is the multi-stream form (the JAX module's
`custom_vmap` rule, gather_rows.py:44-68): N streams' banks [N, T, P, D]
and indices [N, K] in one K2 launch over the contiguous bank viewed as
[N * T, P, D], each stream's indices offset by s * T.
"""
from __future__ import annotations

import torch

from . import _build


def gather_rows_reference(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [T, P, D], idx [K] -> [K, P, D]."""
    return bank.index_select(0, idx)


def gather_rows_cuda(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K2. bank: contiguous [T, P, D] bf16 or f32 on the card, rows a
    multiple of 16 bytes; idx: contiguous int32 [K] on the same card, in range
    (callers clamp, as in JAX)."""
    if bank.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_rows_cuda takes bf16 or f32 banks, got "
                         f"{bank.dtype}")
    if bank.dim() != 3 or not bank.is_contiguous() or bank.data_ptr() % 16:
        raise ValueError(f"bank must be a contiguous, 16-byte aligned "
                         f"[T, P, D] tensor, got shape {tuple(bank.shape)} "
                         f"strides {bank.stride()}")
    row_bytes = bank.shape[1] * bank.shape[2] * bank.element_size()
    if row_bytes % 16:
        raise ValueError(f"bank rows are {row_bytes} bytes, not a multiple "
                         f"of 16")
    if (idx.device != bank.device or idx.dtype != torch.int32
            or idx.dim() != 1 or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous int32 [K] tensor on "
                         f"{bank.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    if idx.shape[0] > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {idx.shape[0]}")
    out = torch.empty((idx.shape[0], *bank.shape[1:]), dtype=bank.dtype,
                      device=bank.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    rc = lib.fvt_gather_rows(
        bank.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        row_bytes, torch.cuda.current_stream(bank.device).cuda_stream)
    _build.check(rc, "gather_rows_cuda")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def gather_rows(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [T, P, D], idx [K] int32 -> [K, P, D]. idx must be in range."""
    if bank.device.type == "cpu":
        return gather_rows_reference(bank, idx)
    return gather_rows_cuda(bank, idx)


def gather_rows_batched_reference(bank: torch.Tensor,
                                  idx: torch.Tensor) -> torch.Tensor:
    """bank [N, T, P, D] (or one [T, P, D] bank for every stream), idx
    [N, K] -> [N, K, P, D]: out[s, i] = bank[s, idx[s, i]]."""
    if bank.dim() == 3:
        return bank[idx.long()]
    rows = torch.arange(bank.shape[0], device=bank.device)[:, None]
    return bank[rows, idx.long()]


def gather_rows_batched_cuda(bank: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """One K2 launch for N streams. bank: contiguous [N, T, P, D] (or one
    [T, P, D] bank shared by every stream) on the card; idx: [N, K] int
    indices into each stream's T rows, in range."""
    if idx.dim() != 2:
        raise ValueError(f"idx must be [N, K], got shape {tuple(idx.shape)}")
    n, k = idx.shape
    if bank.dim() == 3:                   # one bank, batched indices
        return gather_rows_cuda(bank, idx.reshape(-1).to(torch.int32)
                                .contiguous()).reshape(n, k, *bank.shape[1:])
    if bank.dim() != 4 or bank.shape[0] != n:
        raise ValueError(f"bank must be [N, T, P, D] with N = {n}, got "
                         f"shape {tuple(bank.shape)}")
    if not bank.is_contiguous():
        raise ValueError(f"bank must be contiguous, got strides "
                         f"{bank.stride()}")
    t = bank.shape[1]
    if n * t > 2 ** 31 - 1:
        raise ValueError(f"{n} x {t} bank rows exceed int32 indices")
    offs = torch.arange(n, device=idx.device, dtype=torch.int32)[:, None] * t
    flat = (idx.to(torch.int32) + offs).reshape(-1).contiguous()
    out = gather_rows_cuda(bank.view(n * t, *bank.shape[2:]), flat)
    return out.view(n, k, *bank.shape[2:])


def gather_rows_batched(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank [N, T, P, D] or [T, P, D], idx [N, K] -> [N, K, P, D]. idx must
    be in range."""
    if bank.device.type == "cpu":
        return gather_rows_batched_reference(bank, idx)
    return gather_rows_batched_cuda(bank, idx)
