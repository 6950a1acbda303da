"""Frame-local attention with a whole-row softmax: the CUDA kernel P2 and its
plain version.

Replaces the Pallas TPU kernel `kern` (scripts/probe_vit_variants.py:219),
the ViT probe's `framekernel` mode: unmasked, non-causal attention inside
each frame, q, k, v [B, H, S, Dh] (B frames), scale 1/sqrt(Dh), with the TPU
body's arithmetic: f32 scores, the row max over all S keys, p = exp(s - m),
p / l in f32 rounded to q's dtype before the P V product, f32 sums, the
output in q's dtype. K1 (kernels/flash_attention.py) computes the same
function with an online softmax; this kernel keeps each row whole
(csrc/frame_attention.cu).

Dispatch is by device: a CPU tensor takes `frame_attention_reference`, a
CUDA tensor launches the kernel (`frame_attention_cuda`), which raises on
what it does not take. `_launch_plan` shapes the grid: one block per (q
tile, head, frame), whatever the TPU program's `head_block`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from . import _build

HEAD_DIMS = (64, 80, 128)
MAX_LEN = 1024          # tokens per frame: a 448 px frame's 32 x 32 patches
N_SM = 132              # an H100 SXM's SMs: a plan puts at least this many
                        # blocks on the card where the shape allows
MAX_SMEM = 232_448      # shared bytes a block can opt into on Hopper
BLOCK_N = 64            # keys per tile
PAD = 8                 # shared-memory row padding, elements (kPad)
STAGES = 3              # the two-pass ring's slots (kStages)
# the C entry's variant codes: one pass over 1, 2 or 4 tiles of 64 keys, or
# two passes through the ring
VARIANTS = {"whole1": 1, "whole2": 2, "whole4": 4, "tiled": 0}
# the ViT's per-frame shapes: (name, frames, tokens per frame), 16 heads of
# 80; chip_smoke.py holds P2 at each
P2_CASES = (("224px_full", 4, 256), ("224px_small", 4, 64),
            ("448px_full", 4, 1024), ("448px_small", 4, 256))


class LaunchPlan(NamedTuple):
    """grid (q tiles, heads, frames); query rows per block (16 a warp);
    dynamic shared bytes (the C entry refuses any other number); variant (a
    key of VARIANTS)."""
    grid: Tuple[int, int, int]
    rows_per_block: int
    smem_bytes: int
    variant: str

    @property
    def threads(self) -> int:
        """32 a warp."""
        return 2 * self.rows_per_block


def _launch_plan(B: int, H: int, S: int, D: int,
                 head_block: int = 8) -> LaunchPlan:
    """P2's launch for q [B, H, S, D]. `head_block` is checked (H must be a
    multiple of min(head_block, H), the TPU program's contract) and shapes
    nothing. One pass where a head's K and V fit (S <= 256 at Dh 64/80,
    S <= 128 at Dh 128), else two passes. Rows per block start at 64 (one
    pass) or 128 (two passes), no more than S needs, and halve down to 16
    while the grid has fewer than N_SM blocks."""
    hb = min(head_block, H)
    if hb < 1 or H % hb:
        raise ValueError(f"{H} heads are not a multiple of head_block {hb}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if S > MAX_LEN:
        raise ValueError(f"at most {MAX_LEN} tokens per frame (a 448 px "
                         f"frame), got {S}")
    ld, nt = D + PAD, -(-S // BLOCK_N)
    whole = next((n for n in (1, 2, 4) if nt <= n <= (4 if D <= 80 else 2)),
                 None)
    rows = 64 if whole else 128
    while rows > 16 and rows // 2 >= S:
        rows //= 2
    while rows > 16 and B * H * -(-S // rows) < N_SM:
        rows //= 2
    grid = (-(-S // rows), H, B)
    if whole:
        return LaunchPlan(grid, rows, 2 * ld * (rows + 2 * whole * BLOCK_N),
                          f"whole{whole}")
    return LaunchPlan(grid, rows, 2 * ld * (rows + 2 * STAGES * BLOCK_N),
                      "tiled")


def frame_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """The TPU body in plain PyTorch: q, k, v [B, H, S, Dh] -> [B, H, S, Dh]
    in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)


def _check_operand(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device != like.device or x.shape != like.shape:
        raise ValueError(f"{name} must have q's shape {tuple(like.shape)} on "
                         f"{like.device}, got {tuple(x.shape)} on {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"frame_attention_cuda takes bfloat16, {name} is "
                         f"{x.dtype}")
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            s % 8 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1):
        raise ValueError(f"{name}: the last dim must be contiguous, the other "
                         f"strides {x.stride()} multiples of 8 elements and "
                         f"the data 16-byte aligned (16-byte loads)")


def frame_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, head_block: int = 8) -> torch.Tensor:
    """Launch P2 on CUDA tensors [B, H, S, Dh], bf16, any strides that are
    multiples of 8 (the ViT's [T, P, H, Dh] -> [T, H, P, Dh] views need no
    copy). H must be a multiple of min(head_block, H), as in the TPU probe;
    the output does not depend on it. Dh 64, 80 or 128; S <= 1024. The
    output is [B, H, S, Dh] stored as [B, S, H, Dh], so the caller's
    transpose back to tokens is free. Raises on what the kernel does not
    take."""
    if not q.is_cuda:
        raise ValueError(f"frame_attention_cuda takes CUDA tensors, q is on "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, Dh], got {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q)
    B, H, S, D = q.shape
    plan = _launch_plan(B, H, S, D, head_block)
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    rc = _build.library().fvt_frame_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, H, S, D, plan.grid[0], plan.threads, VARIANTS[plan.variant],
        plan.smem_bytes, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "frame_attention_cuda")
    frame_attention_cuda.launches += 1
    return out


frame_attention_cuda.launches = 0


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    head_block: int = 8) -> torch.Tensor:
    """Unmasked frame-local attention, q, k, v [B, H, S, Dh] -> [B, H, S, Dh]
    in q's dtype. `head_block` is the TPU program's heads per program: H
    must be a multiple of it; it changes nothing in the result."""
    if q.device.type == "cpu":
        return frame_attention_reference(q, k, v)
    return frame_attention_cuda(q, k, v, head_block=head_block)
