"""Where the port's entry points put their tensors.

The port runs on the card: an entry point given no device takes CUDA and
raises when there is none. Callers that want the CPU (the parity tests, the
CPU half of chip_smoke.py, `--device cpu`) say so.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def default_device() -> torch.device:
    """torch.device("cuda"), or a clear error when this torch has no card."""
    _require_cuda()
    return torch.device("cuda")


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flash_vstream_tpu_torch runs on an NVIDIA card by default and "
            "torch.cuda.is_available() is False here; pass device='cpu' (or "
            "--device cpu) to run the plain PyTorch versions on the CPU")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """`device` as a torch.device; None means `default_device()`. A CUDA
    device without a card raises the same clear error."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        _require_cuda()
    return dev
