"""Flash attention, forward and backward: the CUDA kernels K1, K3, K4 and K5
and their plain PyTorch versions.

Replaces the Pallas TPU kernels of flash_vstream_tpu/kernels/flash_attention.py:
- K1 `_flash_kernel` (:90): the forward;
- K3 `_flash_kernel_stats` (:158): the forward that also writes each row's
  logsumexp (lse), for the backward;
- K4 `_flash_bwd_dq_kernel` (:285): dq, recomputing p from lse;
- K5 `_flash_bwd_dkv_kernel` (:332): dk and dv, summed over the GQA group.
It keeps the signature and semantics of that module's public
`flash_attention` (:503): segment ids with -1 as padding that is never
attended, causal masking, GQA with kv head = q head // (Hq // Hkv), and zeros
for a row that sees no key.

Dispatch:
- `q_offset != 0` (new tokens against a cache prefix: a decode step, a
  speculative verify, a later prefill chunk) takes the plain version on
  any device, as in JAX, where decode never reached Pallas;
- with grad enabled and any of q/k/v requiring grad, `FlashAttentionFunction`
  (the `custom_vjp` of :480-500): on a CUDA tensor its forward is K3 and its
  backward K4 + K5; on a CPU tensor the same Function runs the plain versions
  (`flash_attention_fwd_lse_reference`, `flash_attention_bwd_reference`);
- otherwise a CPU tensor takes `flash_attention_reference`, the port of
  `xla_attention`, and a CUDA tensor launches K1 (`flash_attention_cuda`).
Every kernel wrapper raises on a dtype, shape or stride its kernel does not
take; nothing on the card falls back to a plain version.

The kernels (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) keep their
sums in registers and run every product as `mma.sync` bf16 tensor-core
fragments; their source notes say what bounds them on Hopper and what the
design does about it. K1/K3 take one block per (q tile, head, batch);
`_launch_plan` picks the q rows per block (16 to 128, 16 a warp): no more
than Sq needs, and fewer where a long call would put under 132 blocks on
the card; the output and lse are the same bit for bit whatever that choice.
K4 takes one block per (q tile, q head, batch) and K5 one per (kv tile,
q head, batch), 64 or 128 rows a block by `_bwd_launch_plan`; where a kv
head serves several q heads, K5 sums their partial dk/dv in a second,
fixed-order pass from an f32 scratch the wrapper allocates. dq, dk and dv
are the same bit for bit from run to run and at either rows per block.
The TPU version's crossover (`Sq >= 512` before fusing) was tuned on a v5e
and is not carried over: every q_offset-0 call on the card runs a kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (64, 80, 128)
N_SM = 132              # an H100 SXM's SMs: a plan puts at least this many
                        # blocks on the card where the shape allows
ROWS_PER_BLOCK = (16, 32, 64, 128)   # q rows a K1/K3 block, as the C entry
                                     # takes them
BLOCK_N = 64            # keys per K/V tile (kBlockN)
PAD = 8                 # shared-memory row padding, elements (kPad)
STAGES = 3              # slots of the K/V ring (kStages)
FILL_MIN_SQ = 4 * BLOCK_N   # a plan halves its rows to fill the card only
                            # above this Sq (over four key tiles a block)
BWD_ROWS_PER_BLOCK = (64, 128)   # q rows a K4 block, kv rows a K5 block, as
                                 # the C entries take them
BWD_WIDE_MIN_S = 8192   # K4/K5 take 128 rows a block only above this length
DQ_STAGES = 3           # slots of K4's K/V ring (kStagesDq)
DKV_STAGES = 2          # slots of K5's Q/dO ring (kStagesDkv)
# The card's limit on K1/K3's output, row by row: each row that sees a key
# within ROW_TOL of its own max |plain|, beside 2e-2 absolute over the
# tensor, which a late prefill row's outputs of 0.02-0.1 pass with a tile
# lost. The kernels read one or two bf16 steps (7.6e-3 to 9.4e-3) at every
# case; a planted lost tile or doubled rescale 9e-2 or more (PERF.md).
ROW_TOL = 2e-2
# K1/K3 cases that give the kernel every kind of (warp, 64-key tile): a -1
# run that starts and ends inside a tile and covers another whole, q rows of
# two ids inside one warp, Sq != Skv both ragged, causal with Sq not a
# multiple of 128, GQA 7:1 at each head dim. name: (B, Hq, Hkv, Sq, Skv, D,
# causal, q id runs, kv id runs), a run (start, end, id) over a row of 0s
# (`segment_ids`); the card tests and chip_smoke.py hold K1/K3 at each.
_PROMPT_RUNS = ((200, 330, -1), (330, 405, 1), (405, 700, 2))
TILE_CASES = {
    "gqa7_causal_d128": (1, 7, 1, 700, 700, 128, True, _PROMPT_RUNS,
                         _PROMPT_RUNS),
    "gqa7_ragged_d80": (2, 14, 2, 333, 301, 80, False,
                        ((150, 320, 1), (320, 333, -1)),
                        ((130, 140, -1), (140, 301, 1))),
    "gqa7_ragged_causal_d64": (1, 7, 1, 301, 333, 64, True,
                               ((290, 301, 3),),
                               ((64, 128, -1), (250, 333, 3))),
}


def segment_ids(runs, B: int, S: int, device=None) -> torch.Tensor:
    """int32 [B, S] segment ids: 0, then each (start, end, id) run."""
    ids = torch.zeros(B, S, dtype=torch.int32, device=device)
    for a, b, val in runs:
        ids[:, a:b] = val
    return ids


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _visible(q, k, causal, q_segment_ids, kv_segment_ids, q_offset=0):
    """[B, 1, 1, Sq, Skv] bool: which (query, key) pairs attend."""
    B, Sq, Skv = q.shape[0], q.shape[2], k.shape[2]
    mask = torch.ones((B, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Skv, device=q.device)[None, :]
        mask = mask & (qi >= ki)
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        seg = seg & (kv_segment_ids[:, None, :] >= 0)
        mask = mask & seg[:, None, None]
    return mask


def _scores(q, k, scale):
    """f32 scaled scores [B, Hkv, g, Sq, Skv] from the exactly widened
    inputs."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).float()
    return torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale


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
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = _scores(q, k, scale)
    mask = _visible(q, k, causal, q_segment_ids, kv_segment_ids, q_offset)
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    # rows with no visible key: zero them (softmax of all-masked is uniform)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def flash_attention_fwd_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: `flash_attention_reference`'s output and each
    row's logsumexp of the scaled visible scores, [B, Hq, Sq] f32, -inf for
    a row that sees no key (the TPU kernel lane-replicates it to
    [B, Hq, Sq, 128])."""
    B, Hq, Sq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = flash_attention_reference(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, scale=scale)
    s = _scores(q, k, scale)
    mask = _visible(q, k, causal, q_segment_ids, kv_segment_ids)
    lse = torch.logsumexp(torch.where(mask, s, float("-inf")), dim=-1)
    return out, lse.reshape(B, Hq, Sq)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4 + K5, the recompute-from-lse math of the TPU
    kernels (:285-382) in f32: p = exp(s - lse), 0 where lse is not finite
    or the pair is masked; delta = rowsum(do * o); ds = p (do v^T - delta)
    scale; dq = ds k, dk = ds^T q and dv = p^T do, the last two summed over
    each kv head's GQA group. p and ds are rounded to the operands' dtype
    before their products, as the kernels round them. Returns (dq, dk, dv)
    in q's, k's and v's dtypes."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = _scores(q, k, scale)
    mask = _visible(q, k, causal, q_segment_ids, kv_segment_ids)
    lse5 = lse.reshape(B, Hkv, g, Sq, 1).float()
    live = torch.isfinite(lse5) & mask
    p = torch.where(live, torch.exp(s - torch.where(live, lse5, 0.0)), 0.0)
    dof = do.reshape(B, Hkv, g, Sq, D).float()
    of = o.reshape(B, Hkv, g, Sq, D).float()
    delta = (dof * of).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    ds = p * (dp - delta) * scale
    p = p.to(v.dtype).float()
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.reshape(B, Hkv, g, Sq, D).float())
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _check_operand(name: str, x: torch.Tensor, dev: torch.device) -> None:
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"flash attention kernels take bfloat16, {name} is "
                         f"{x.dtype}")
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(f"{name} must be [B, H, S, D] with a contiguous "
                         f"last dim, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if (any(s % 8 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)
            or x.data_ptr() % 16):
        raise ValueError(f"{name}: strides {x.stride()} must be multiples of "
                         f"8 elements and the data 16-byte aligned (the "
                         f"kernels load 16 bytes at a time)")


def _check_segments(name: str, seg: torch.Tensor, B: int, S: int,
                    dev: torch.device) -> None:
    if (seg.device != dev or seg.dtype != torch.int32
            or tuple(seg.shape) != (B, S) or not seg.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{B}, {S}] "
                         f"tensor on {dev}, got {seg.dtype} "
                         f"{tuple(seg.shape)} on {seg.device}")


def _check_call(q, k, v, q_segment_ids, kv_segment_ids, scale):
    """Validate a kernel call's operands; returns the problem's sizes and
    the scale."""
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
    return B, Hq, Sq, D, Hkv, Skv, float(scale)


class FwdPlan(NamedTuple):
    """K1/K3's launch: q rows per block (16 a warp), blocks in the grid
    (q tiles x Hq x B) and dynamic shared bytes (the C entry refuses any
    other number for those rows)."""
    rows_per_block: int
    blocks: int
    smem_bytes: int


def _smem_bytes(rows: int, D: int) -> int:
    """Q [rows][D + PAD] bf16, STAGES slots of K and V [64][D + PAD] bf16
    and of 64 int32 kv segment ids (csrc/flash_attention.cu
    `smem_needed`)."""
    return (2 * (D + PAD) * (rows + 2 * STAGES * BLOCK_N)
            + 4 * STAGES * BLOCK_N)


def _launch_plan(B: int, Hq: int, Sq: int, D: int,
                 rows_per_block: Optional[int] = None) -> FwdPlan:
    """K1/K3's launch for q [B, Hq, Sq, D]. Rows per block start at 128, no
    more than Sq needs; above FILL_MIN_SQ they halve down to 16 while the
    grid has fewer than N_SM blocks. At Sq <= FILL_MIN_SQ a block's loop is
    short and each extra block loads its K/V again: the ViT's S 64 and 256
    ran faster at 64 and 128 rows than at the 16 and 64 that fill the card
    (PERF.md). `rows_per_block` forces one of ROWS_PER_BLOCK instead (the
    result is the same bit for bit)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    rows = ROWS_PER_BLOCK[-1] if rows_per_block is None else rows_per_block
    if rows not in ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block {rows} not in {ROWS_PER_BLOCK}")
    if rows_per_block is None:
        while rows > 16 and rows // 2 >= Sq:
            rows //= 2
        while (rows > 16 and Sq > FILL_MIN_SQ
               and B * Hq * -(-Sq // rows) < N_SM):
            rows //= 2
    return FwdPlan(rows, B * Hq * -(-Sq // rows), _smem_bytes(rows, D))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch_fwd(q, k, v, lse, causal, q_segment_ids, kv_segment_ids, scale,
                name, rows_per_block=None):
    """K1 (lse None) or K3; the output is [B, Hq, Sq, D] stored as
    [B, Sq, Hq, D], so the caller's transpose back to tokens is free.
    `rows_per_block` overrides the plan's (the tests hold every choice to
    the same bits)."""
    B, Hq, Sq, D, Hkv, Skv, scale = _check_call(
        q, k, v, q_segment_ids, kv_segment_ids, scale)
    plan = _launch_plan(B, Hq, Sq, D, rows_per_block)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out, False
    if Skv == 0:
        if lse is not None:
            lse.fill_(float("-inf"))
        return out.zero_(), False
    rc = _build.library().fvt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
        _ptr(q_segment_ids), _ptr(kv_segment_ids),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, Hq, Sq, Skv, Hkv, D, int(causal), plan.rows_per_block,
        plan.smem_bytes, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    return out, True


def _needs_pad(q, k, v) -> bool:
    D = q.shape[-1]
    return D < HEAD_DIMS[0] and k.shape[-1] == v.shape[-1] == D


def _pad_head_dim(*xs):
    """Each tensor's last dim zero-padded to the kernels' smallest head_dim
    (64: the tiny test configs have 8 and 16)."""
    return tuple(F.pad(x, (0, HEAD_DIMS[0] - x.shape[-1])) for x in xs)


def fwd_padded(fwd, q, k, v, *, scale=None, **kw):
    """`fwd` (K1, K3 or a plain version) on q, k, v zero-padded to head_dim
    64, at the scale of the unpadded D: the scores are unchanged, so the
    output's first D columns (returned) and the lse are too."""
    D = q.shape[-1]
    res = fwd(*_pad_head_dim(q, k, v),
              scale=1.0 / math.sqrt(D) if scale is None else scale, **kw)
    if isinstance(res, tuple):
        return res[0][..., :D], res[1]
    return res[..., :D]


def bwd_padded(bwd, q, k, v, o, do, lse, *, scale=None, **kw):
    """`bwd` (K4 + K5 or the plain backward) on q, k, v, o, do zero-padded
    to head_dim 64, at the scale of the unpadded D; dq, dk and dv sliced
    back to D. delta = rowsum(do * o) and the scores are unchanged, and the
    padded columns' gradients are exactly zero (products with zero
    columns)."""
    D = q.shape[-1]
    grads = bwd(*_pad_head_dim(q, k, v, o, do), lse,
                scale=1.0 / math.sqrt(D) if scale is None else scale, **kw)
    return tuple(g[..., :D] for g in grads)


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
    stored as [B, Sq, Hq, D]. A head_dim below the kernel's smallest (64:
    the tiny test configs) is zero-padded to 64, which leaves the scores
    and the output's first D columns as they were. Raises on what the
    kernel does not take."""
    if _needs_pad(q, k, v):
        return fwd_padded(flash_attention_cuda, q, k, v, causal=causal,
                          q_segment_ids=q_segment_ids,
                          kv_segment_ids=kv_segment_ids, scale=scale)
    out, launched = _launch_fwd(q, k, v, None, causal, q_segment_ids,
                                kv_segment_ids, scale, "flash_attention_cuda")
    flash_attention_cuda.launches += launched
    return out


def flash_attention_fwd_lse_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3: K1's output and the per-row logsumexp [B, Hq, Sq] f32
    (-inf for a row that sees no key). A head_dim below 64 is zero-padded
    as K1's is; the lse is the unpadded one, since zero columns add nothing
    to a score."""
    if _needs_pad(q, k, v):
        return fwd_padded(flash_attention_fwd_lse_cuda, q, k, v,
                          causal=causal, q_segment_ids=q_segment_ids,
                          kv_segment_ids=kv_segment_ids, scale=scale)
    B, Hq, Sq = q.shape[:3]
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    out, launched = _launch_fwd(q, k, v, lse, causal, q_segment_ids,
                                kv_segment_ids, scale,
                                "flash_attention_fwd_lse_cuda")
    flash_attention_fwd_lse_cuda.launches += launched
    return out, lse


def _bwd_operand(name: str, x: torch.Tensor, like: torch.Tensor
                 ) -> torch.Tensor:
    """o or do for the backward kernels: q's shape, bf16, on q's device.
    A layout the kernels cannot read (the last dim not contiguous, a stride
    not a multiple of 8, unaligned data) is copied once, here."""
    if x.shape != like.shape or x.device != like.device:
        raise ValueError(f"{name} must have q's shape {tuple(like.shape)} on "
                         f"{like.device}, got {tuple(x.shape)} on {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"flash attention kernels take bfloat16, {name} is "
                         f"{x.dtype}")
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(s % 8 for s, n in zip(x.stride()[:3], x.shape[:3])
                   if n > 1)):
        x = x.contiguous()
    return x


class BwdPlan(NamedTuple):
    """K4's or K5's launch: rows per block (q rows for K4, kv rows for K5;
    16 a warp), blocks in the grid (tiles x Hq x B), dynamic shared bytes
    (the C entries refuse any other number for those rows) and the shape of
    K5's f32 scratch for the partial dk and dv of each q head, [2, B, Hq,
    Skv, D] (None for K4, and for K5 where Hq == Hkv: no second pass)."""
    rows_per_block: int
    blocks: int
    smem_bytes: int
    scratch: Optional[Tuple[int, int, int, int, int]]


def _bwd_smem_bytes(kernel: str, rows: int, D: int) -> int:
    """K4 ("dq"): DQ_STAGES slots of K and V [64][D + PAD] bf16 and of 64
    int32 kv ids, whatever the rows. K5 ("dkv"): K and V [rows][D + PAD]
    bf16, then DKV_STAGES slots of Q and dO [64][D + PAD] bf16 and of 64
    lse, delta and q ids (csrc/flash_attention_bwd.cu `dq_smem_bytes`,
    `dkv_smem_bytes`)."""
    if kernel == "dq":
        return 2 * (D + PAD) * 2 * DQ_STAGES * BLOCK_N + 4 * DQ_STAGES * BLOCK_N
    return (2 * (D + PAD) * (2 * rows + 2 * DKV_STAGES * BLOCK_N)
            + 12 * DKV_STAGES * BLOCK_N)


def _bwd_launch_plan(kernel: str, B: int, Hq: int, Hkv: int, Sq: int,
                     Skv: int, D: int,
                     rows_per_block: Optional[int] = None) -> BwdPlan:
    """K4's ("dq": one block per q tile, q head and batch) or K5's ("dkv":
    per kv tile, q head and batch) launch. Rows per block are 64, or 128
    where the rows the grid covers (Sq for K4, Skv for K5) exceed
    BWD_WIDE_MIN_S and 128-row blocks still number N_SM or more: on an H100
    64 rows ran 1-5% faster at S 4,096 (the training step) and 128 rows
    3.5-5% faster at S 14,000 (the production step; PERF.md).
    `rows_per_block` forces one of BWD_ROWS_PER_BLOCK instead (the result
    is the same bit for bit)."""
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"kernel {kernel!r} is not 'dq' or 'dkv'")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    S = Sq if kernel == "dq" else Skv
    rows = rows_per_block
    if rows is None:
        small, big = BWD_ROWS_PER_BLOCK
        rows = (big if S > BWD_WIDE_MIN_S and B * Hq * -(-S // big) >= N_SM
                else small)
    elif rows not in BWD_ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block {rows} not in {BWD_ROWS_PER_BLOCK}")
    scratch = ((2, B, Hq, Skv, D) if kernel == "dkv" and Hq > Hkv else None)
    return BwdPlan(rows, B * Hq * -(-S // rows),
                   _bwd_smem_bytes(kernel, rows, D), scratch)


def _launch_bwd(kernel, q, k, v, o, do, lse, delta, dq, dk, dv,
                causal, q_segment_ids, kv_segment_ids, scale,
                rows_per_block=None):
    """K4 ("dq": writes dq and delta) or K5 ("dkv": writes dk and dv, with
    its f32 scratch where Hq > Hkv). `rows_per_block` overrides the plan's
    (the tests hold every choice to the same bits)."""
    B, Hq, Sq, D, Hkv, Skv, scale = _check_call(
        q, k, v, q_segment_ids, kv_segment_ids, scale)
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous f32 [{B}, {Hq}, {Sq}] "
                         f"tensor on {q.device}")
    plan = _bwd_launch_plan(kernel, B, Hq, Hkv, Sq, Skv, D, rows_per_block)
    scratch = (None if plan.scratch is None else
               torch.empty(plan.scratch, dtype=torch.float32,
                           device=q.device))
    # an output the kernel does not write (dq for K5, dk/dv for K4) is a
    # null pointer with zero strides
    strides = [s for x in (q, k, v, o, do, dq, dk, dv)
               for s in (x.stride()[:3] if x is not None else (0, 0, 0))]
    fn_name = f"fvt_flash_attention_bwd_{kernel}"
    rc = getattr(_build.library(), fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(dq), _ptr(dk), _ptr(dv),
        _ptr(q_segment_ids), _ptr(kv_segment_ids), _ptr(scratch),
        (ctypes.c_longlong * 24)(*strides),
        B, Hq, Sq, Skv, Hkv, D, int(causal), plan.rows_per_block,
        plan.smem_bytes, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, fn_name)


def flash_attention_bwd_dq_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4: dq (q's dtype and layout) and delta = rowsum(do * o)
    [B, Hq, Sq] f32, which K5 reads."""
    o, do = _bwd_operand("o", o, q), _bwd_operand("do", do, q)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq, delta
    if k.shape[2] == 0:
        _check_call(q, k, v, q_segment_ids, kv_segment_ids, scale)
        return dq.zero_(), (do.float() * o.float()).sum(-1)
    _launch_bwd("dq", q, k, v, o, do, lse, delta, dq, None, None, causal,
                q_segment_ids, kv_segment_ids, scale)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq, delta


def flash_attention_bwd_dkv_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5: dk and dv (k's and v's dtype and layout), each summed over
    its kv head's GQA group, from K4's delta."""
    o, do = _bwd_operand("o", o, q), _bwd_operand("do", do, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    if q.shape[2] == 0:
        _check_call(q, k, v, q_segment_ids, kv_segment_ids, scale)
        return dk.zero_(), dv.zero_()
    if (delta.shape != lse.shape or delta.dtype != torch.float32
            or not delta.is_contiguous()):
        raise ValueError("delta must be K4's contiguous f32 [B, Hq, Sq]")
    _launch_bwd("dkv", q, k, v, o, do, lse, delta, None, dk, dv, causal,
                q_segment_ids, kv_segment_ids, scale)
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 then K5 on the current stream: (dq, dk, dv). A layout of o or do
    that the kernels cannot read is copied here, once for both; each
    wrapper's own check then finds the copy readable and takes it as is.
    A head_dim below 64 is zero-padded as K1's is, and the gradients sliced
    back (the padded columns' are exactly zero)."""
    if _needs_pad(q, k, v):
        return bwd_padded(flash_attention_bwd_cuda, q, k, v, o, do, lse, **kw)
    o, do = _bwd_operand("o", o, q), _bwd_operand("do", do, q)
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw)
    return dq, dk, dv


for _fn in (flash_attention_cuda, flash_attention_fwd_lse_cuda,
            flash_attention_bwd_dq_cuda, flash_attention_bwd_dkv_cuda):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# Autograd and dispatch
# ---------------------------------------------------------------------------

class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the fused backward, the port of the JAX `custom_vjp`
    (:480-500). The forward saves q, k, v, the output and the per-row lse;
    the backward recomputes p from lse. On CUDA tensors the forward is K3
    and the backward K4 + K5; on CPU tensors both are the plain versions.
    Under `torch.utils.checkpoint` the forward runs again in the backward
    pass, and the lse of that rerun is the one saved. Segment ids, `causal`
    and `scale` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal, scale):
        kw = dict(causal=causal, q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids, scale=scale)
        fwd = (flash_attention_fwd_lse_cuda if q.is_cuda
               else flash_attention_fwd_lse_reference)
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, q_segment_ids,
                              kv_segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        bwd = (flash_attention_bwd_cuda if q.is_cuda
               else flash_attention_bwd_reference)
        dq, dk, dv = bwd(q, k, v, out, do.to(q.dtype), lse, causal=ctx.causal,
                         q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                         scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


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
    if not prefill:
        return flash_attention_reference(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_offset=q_offset, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, q_segment_ids,
                                            kv_segment_ids, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal,
                                q_segment_ids=q_segment_ids,
                                kv_segment_ids=kv_segment_ids, scale=scale)
