"""Shared transformer layers as plain functions on tensors: norms, RoPE (1D,
M-RoPE, 2D vision), MLPs, attention with a KV cache.

Port of flash_vstream_tpu/models/layers.py. Parameters are nested dicts of
tensors in the JAX tree's names and layouts (dense weights [din, dout]), so
the modules in this package call these functions on their parameter trees.
The arithmetic follows the JAX functions op for op (f32 norms and rotary
math, the matmul in the activation's dtype, bias added after the matmul) so
the two packages agree on the CPU.

Weights are bf16/f32 tensors, int8 `QuantWeight`s (weight-only, or w8a8 at
prefill rows once `weights/quantize.enable_w8a8_prefill` is on), packed int4
`QuantWeight4`s (weights/quantize.py) or merge-free LoRA views
(train/lora.py's `LoRAWeight`). Under autograd a quantized weight is a
frozen base (QLoRA): `dense` then takes `_QuantDense`, whose backward
dequantizes again instead of keeping the dequantized copy. The KV cache is
bf16/f32, or int8 with per-position f32 scales (`quantize_kv`).

In tensor-parallel training a weight may be a `parallel.tensor.TPShard`:
`dense` then computes this rank's part, Megatron's column or row product
with its copy-to or reduce-from region, and `mha` runs on the local heads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import DEFAULT_MASK_VALUE, flash_attention
from ..kernels.int4_matmul import int4_matmul_cuda, int4_matmul_supported
from ..parallel.collectives import copy_to, gather_on_use, reduce_from
from ..parallel.tensor import TPShard
from ..weights.quantize import dequantize_weight4, weight_shape


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU (HF nn.GELU default)."""
    return F.gelu(x)


ACTIVATIONS = {
    "gelu": gelu_exact,
    "quick_gelu": quick_gelu,
    "silu": F.silu,
}


# w8a8 prefill (layers.py:59-75): with the switch on, QuantWeight matmuls of
# at least _W8A8_MIN_ROWS rows quantize the activations per token to int8 and
# take an int8 x int8 -> int32 product; decode rows stay weight-only. Set by
# weights/quantize.enable_w8a8_prefill and read at every call.
W8A8_PREFILL = False
_W8A8_MIN_ROWS = 128


def _w8a8_dot(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] @ int8 q [din, dout] with x quantized per token: amax in
    f32, xs = max(amax / 127, 1e-12), round half to even and clip to
    [-127, 127]; the int32 product (`torch._int_mm`, exact) times xs and
    the per-channel scale, cast to x's dtype. On the card `_int_mm` takes
    more than 16 rows and din, dout multiples of 8: other shapes raise."""
    if q.dim() != 2:
        raise ValueError(f"w8a8 takes a 2-D int8 weight, got {tuple(q.shape)}")
    din, dout = q.shape
    rows = math.prod(x.shape[:-1])
    if x.is_cuda and (rows <= 16 or din % 8 or dout % 8):
        raise ValueError(f"w8a8 on the card needs more than 16 rows and din, "
                         f"dout multiples of 8, got {rows} rows of "
                         f"[{din}, {dout}]")
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: CUDA turns a division by a Python scalar into a
    # product with its reciprocal, one ulp off the division JAX does
    xs = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    # the weight goes in column-major: cuBLASLt's int8 product takes that
    # layout at every shape, a row-major one only at some (and slower)
    out = torch._int_mm(xq.reshape(rows, din), q.t().contiguous().t())
    out = out.reshape(*x.shape[:-1], dout)
    return (out.float() * xs * scale).to(x.dtype)


def _quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ a quantized weight off the K6 and w8a8 routes: int8 values cast
    to x's dtype with the per-channel scale on the output, or the int4
    weight dequantized to x's dtype (JAX layers.py:95-116)."""
    if hasattr(w, "q"):
        out = torch.matmul(x, w.q.to(x.dtype))
        return out * w.scale.to(out.dtype)
    return torch.matmul(x, dequantize_weight4(w, x.dtype))


class _QuantDense(torch.autograd.Function):
    """x @ a frozen quantized weight under autograd (QLoRA): the gradient
    goes to x alone, and the backward dequantizes the weight again. Autograd
    of `_quant_matmul` would save the dequantized [din, dout] copy for the
    backward (0.47 GB a 7B layer in bf16, about 13 GB over 28 layers), where
    JAX lets XLA recompute it. Nothing is saved with `save_for_backward`:
    the quantized fields are frozen parameters, held on ctx by reference.
    Never routed to K6, which has no backward."""

    @staticmethod
    def forward(ctx, x, kind, *fields):
        ctx.kind, ctx.fields = kind, fields
        return _quant_matmul(x, kind(*fields))

    @staticmethod
    def backward(ctx, g):
        w = ctx.kind(*ctx.fields)
        if hasattr(w, "q"):          # d/dx of (x @ q) * scale
            gx = torch.matmul(g * w.scale.to(g.dtype), w.q.to(g.dtype).mT)
        else:
            gx = torch.matmul(g, dequantize_weight4(w, g.dtype).mT)
        return (gx, None, *(None for _ in ctx.fields))


def _base(w):
    """The base weight under a LoRA view (the weight itself otherwise)."""
    return w.w if hasattr(w, "a") else w


def tp_group(*ws):
    """The tp group of the first of `ws` whose base is a `TPShard`, or None
    where every base is whole (the layer then runs whole)."""
    for w in ws:
        if isinstance(_base(w), TPShard):
            return _base(w).group
    return None


def _rank_range(size: int, group, rep: int = 1) -> Tuple[int, int]:
    """[lo, hi) of a dim of `size` that this rank of `group` uses: its tp
    part, or with `rep` > 1 the parts of the `rep` consecutive ranks that
    hold its kv head (gathered on use)."""
    n = size // group.size
    lo = (group.rank // rep) * rep * n
    return lo, lo + rep * n


def _int4_rows(w, lo: int, hi: int):
    """Rows [lo, hi) of a `QuantWeight4` as one of their own: the nibbles
    read from the split-half packing (row i low in byte row i, row
    i + din/2 high) and packed split-half again, under their blocks'
    scales. Where the part holds whole input blocks they stay as they
    are; otherwise each block is cut into gcd(block, rows) rows, every
    piece under its block's scale, so the values are the same."""
    from ..weights.quantize import QuantWeight4
    half = w.q4.shape[-2]
    bs = 2 * half // w.scale.shape[-2]
    n = hi - lo
    if n % 2:
        raise ValueError(f"int4 rows [{lo}, {hi}): an odd count does not "
                         f"pack")
    rows = torch.arange(lo, hi, device=w.q4.device)
    byte = w.q4.index_select(-2, rows % half)
    nib = torch.where((rows < half)[:, None], byte & 0xF, byte >> 4)
    piece = math.gcd(bs, n, lo) if lo else math.gcd(bs, n)
    scale = w.scale.repeat_interleave(bs // piece, dim=-2)
    return QuantWeight4(nib[..., :n // 2, :] | (nib[..., n // 2:, :] << 4),
                        scale[..., lo // piece:hi // piece, :])


def _whole_part(w, kind: str, lo: int, hi: int):
    """This rank's part of a quantized base left whole beside split
    neighbours (it rests whole, as JAX's `LLM_RULES` leave its `.q`, `.q4`
    and `.scale` paths): a column part takes q's (q4's) and the scale's
    columns; a row part q's rows under the whole per-channel scale, or an
    int4 weight's rows (`_int4_rows`)."""
    from ..weights.quantize import QuantWeight
    if kind == "column":
        return type(w)(*(f[..., lo:hi] for f in w))
    if hasattr(w, "q"):
        return QuantWeight(w.q[..., lo:hi, :], w.scale)
    return _int4_rows(w, lo, hi)


def _part_matmul(x: torch.Tensor, w, kind: str, group, rep: int = 1
                 ) -> torch.Tensor:
    """x @ this rank's part of `w` in a split layer: for a column part its
    output columns, for a row part its input rows (the product left
    unsummed). `w` is a `TPShard` (its own part; with `rep` > 1 gathered
    over the ranks that share its kv head), a whole quantized base (its
    part taken on use) or a LoRA view of either. A LoRA view's factors
    rest whole, as in JAX: beside a column base b's columns are used,
    beside a row base a's rows. Each factor enters a copy-to region first,
    whose backward sums the ranks' partial gradients over tp, so a factor's
    gradient is whole and equal on every rank, as a whole leaf's is."""
    lora = None
    if hasattr(w, "a"):
        w, lora = w.w, (copy_to(w.a, group), copy_to(w.b, group))
    if isinstance(w, TPShard):
        wl = w.local()
        if rep > 1:
            wl = gather_on_use(wl, group.part(rep), -1)
        out = torch.matmul(x, wl.to(x.dtype))
        size = w.shape[-1] if kind == "column" else w.shape[-2]
    else:
        size = weight_shape(w)[-1 if kind == "column" else -2]
        lo, hi = _rank_range(size, group, rep)
        out = dense(x, _whole_part(w, kind, lo, hi))
    if lora is not None:
        a, b = lora
        lo, hi = _rank_range(size, group, rep)
        if kind == "column":
            b = b[..., lo:hi]
        else:
            a = a[..., lo:hi, :]
        lora_out = torch.matmul(torch.matmul(x, a.to(x.dtype)), b.to(x.dtype))
        out = out + lora_out.to(out.dtype)
    return out


def _column_bias(b, group, rep: int = 1):
    """A column part's bias (split, as the rules split every one beside a
    column base): this rank's part, gathered over the kv head's ranks with
    `rep` > 1."""
    if b is None:
        return None
    return gather_on_use(b.local(), group.part(rep), -1) if rep > 1 \
        else b.local()


def _tp_column(x, w, b, group, rep: int = 1) -> torch.Tensor:
    """A column part in a split layer whose input entered the copy-to region
    already: this rank's output columns and bias."""
    out = _part_matmul(x, w, "column", group, rep)
    b = _column_bias(b, group, rep)
    return out if b is None else out + b.to(out.dtype)


def _tp_row(x, w, b, group) -> torch.Tensor:
    """A row part in a split layer: x's part (the previous column product's)
    @ this rank's rows, the sum over tp (`reduce_from`), then the whole
    bias once."""
    out = reduce_from(_part_matmul(x, w, "row", group), group)
    return out if b is None else out + b.to(out.dtype)


def _tp_dense(x: torch.Tensor, w, b, entered: bool) -> torch.Tensor:
    """A split `dense` (w a `TPShard` or a LoRA view of one). A column
    split: x through `copy_to` (unless the caller `entered` the region
    already, for several products of one input), this rank's output
    columns, its part of the bias. A row split: `_tp_row`."""
    base = _base(w)
    if base.kind == "column":
        if not entered:
            x = copy_to(x, base.group)
        return _tp_column(x, w, b, base.group)
    return _tp_row(x, w, b, base.group)


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w in x's dtype (the weight is cast to it, as in JAX), then the bias
    in the output's dtype. A LoRA view (w, a, b) computes x @ w + (x @ a) @ b
    with the factors cast to x's dtype (`a` carries the alpha/rank scale), so
    the merged matrix never exists and only the factors get gradients.

    An int8 `QuantWeight` multiplies by its int8 values cast to x's dtype and
    scales the output per channel; with `W8A8_PREFILL` on and at least 128
    rows (x.shape[-2], as in JAX) it takes `_w8a8_dot`. A `QuantWeight4` of a 2-D weight, on the
    card, at a shape the K6 gate takes (a decode matvec: at most 32 rows),
    launches K6; everywhere else (prefill rows, the CPU) it dequantizes to
    x's dtype and multiplies, the JAX package's own path (layers.py:95-116),
    so on the CPU the port matches JAX op for op. When x requires a
    gradient, either quantized kind takes `_QuantDense` (the same
    arithmetic; a backward that keeps no dequantized copy).

    A `TPShard`, or a LoRA view of one, takes `_tp_dense`. A split bias
    beside a whole base (a quantized layer under tp, whose `w[qkv]/b` the
    rules still split) is gathered whole on use: such a layer runs whole."""
    if isinstance(_base(w), TPShard):
        return _tp_dense(x, w, b, False)
    if hasattr(w, "a"):                  # train/lora.LoRAWeight
        out = dense(x, w.w)
        lora = torch.matmul(torch.matmul(x, w.a.to(x.dtype)), w.b.to(x.dtype))
        out = out + lora.to(out.dtype)
    elif (hasattr(w, "q") or hasattr(w, "q4")) and torch.is_grad_enabled() \
            and x.requires_grad:
        out = _QuantDense.apply(x, type(w), *w)
    elif hasattr(w, "q"):                # weights/quantize.QuantWeight
        if W8A8_PREFILL and x.dim() >= 2 and x.shape[-2] >= _W8A8_MIN_ROWS:
            out = _w8a8_dot(x, w.q, w.scale)
        else:
            out = _quant_matmul(x, w)
    elif hasattr(w, "q4"):               # weights/quantize.QuantWeight4
        rows = math.prod(x.shape[:-1])
        if (x.is_cuda and w.q4.dim() == 2
                and int4_matmul_supported(rows, w.q4.shape[0],
                                          w.scale.shape[0], w.q4.shape[1])):
            out = int4_matmul_cuda(x.reshape(rows, x.shape[-1]), w.q4,
                                   w.scale, out_dtype=x.dtype)
            out = out.reshape(*x.shape[:-1], w.q4.shape[-1])
        else:
            out = _quant_matmul(x, w)
    elif isinstance(w, torch.Tensor):
        out = torch.matmul(x, w.to(x.dtype))
    else:
        raise TypeError(f"dense takes a tensor, a QuantWeight, a QuantWeight4 "
                        f"or a LoRA view, not {type(w).__name__}")
    if isinstance(b, TPShard):           # a split bias beside a whole base
        b = gather_on_use(b.local(), b.group, b.dim)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _inv_freq(n: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, n, dtype=torch.float32,
                                         device=device) / n))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for HF-style rotate_half RoPE: positions [..., S] ->
    [..., S, head_dim] (the half-dim frequencies duplicated)."""
    half = head_dim // 2
    freqs = positions.float()[..., None] * _inv_freq(half, theta,
                                                     positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def mrope_angles(positions: torch.Tensor, head_dim: int,
                 sections: Tuple[int, int, int],
                 theta: float = 1000000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): positions [3, B, S] (t/h/w); frequency band i takes
    its angle from axis sel[i]. Returns cos/sin [B, S, head_dim]."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"sections {sections} do not sum to {head_dim // 2}")
    cos3, sin3 = rope_angles(positions, head_dim, theta)    # [3, B, S, hd]
    sel = torch.cat([torch.full((s,), i, dtype=torch.int64)
                     for i, s in enumerate(sections)])
    sel = torch.cat([sel, sel]).to(positions.device)
    idx = sel.view(1, 1, 1, head_dim).expand(1, *cos3.shape[1:])
    return cos3.gather(0, idx)[0], sin3.gather(0, idx)[0]


def vision_rope_angles(hpos: torch.Tensor, wpos: torch.Tensor,
                       head_dim: int, theta: float = 10000.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL vision 2D rotary: half the bands rotate by h, half by w.
    hpos/wpos [S] -> cos/sin [S, head_dim]."""
    inv = _inv_freq(head_dim // 4, theta, hpos.device)
    freqs = torch.cat([hpos.float()[:, None] * inv,
                       wpos.float()[:, None] * inv], dim=-1)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [B, S, D] or [S, D]. Computed in f32."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, None].float()
    sin = sin[:, None].float()
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Stacked per-layer KV cache, updated IN PLACE (the JAX cache is
    functional; here a prefill or decode step writes its k/v slices and
    segment ids into these buffers and advances `length`).

    k, v: [L, B, Hkv, Smax, D]; length: filled prefix (host int);
    segments: [B, Smax] int32, -1 = padding or not yet written. An int8
    cache (dtype=torch.int8) holds k/v quantized per (position, head) by
    `quantize_kv`, with their f32 scales in k_scale / v_scale [L, B, Hkv,
    Smax, 1] (two buffers): (2 + 8 / D) / 4 of a bf16 cache's bytes, about
    half (JAX layers.py:202-246)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int
    segments: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, num_layers: int, batch: int, num_kv_heads: int,
               max_len: int, head_dim: int, dtype=torch.bfloat16,
               device=None) -> "KVCache":
        shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
        ks = vs = None
        if dtype == torch.int8:
            ks = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                             device=device)
            vs = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                             device=device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0,
                   torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device), ks, vs)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int) -> tuple:
        """Layer i's (k, v) views, and (k_scale, v_scale) of an int8 cache."""
        if self.quantized:
            return (self.k[i], self.v[i], self.k_scale[i], self.v_scale[i])
        return (self.k[i], self.v[i])

    def write_segments(self, seg: torch.Tensor) -> None:
        """Segment ids of the S tokens being appended at `length`."""
        self.segments[:, self.length:self.length + seg.shape[1]] = seg


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head_dim axis: x [..., D] -> (int8 [..., D],
    f32 scale [..., 1]); amax / 127 floored at 1e-12, rounded half to even
    and clipped to [-127, 127] (JAX layers.py:248-255)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: CUDA turns a division by a Python scalar into a
    # product with its reciprocal, one ulp off the division JAX does
    scale = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# Attention / MLP blocks
# ---------------------------------------------------------------------------

def init_dense(generator: torch.Generator, din: int, dout: int, *,
               bias: bool = False, layers: Optional[int] = None,
               dtype=torch.float32, device=None) -> dict:
    """N(0, 1/din) weights [din, dout] (stacked [layers, din, dout] when
    `layers` is given) and zero biases: the JAX init's distributions."""
    lead = () if layers is None else (layers,)
    p = {"w": torch.randn(*lead, din, dout, generator=generator,
                          dtype=dtype, device=device).mul_(1.0 / math.sqrt(din))}
    if bias:
        p["b"] = torch.zeros(*lead, dout, dtype=dtype, device=device)
    return p


def cache_attention(q, kc, vc, ks=None, vs=None, *, q_offset, q_segment_ids,
                    kv_segment_ids):
    """Attention of new tokens over a cache prefix. A bf16/f32 cache at
    q_offset > 0 (a decode step, a speculative verify, a later prefill
    chunk) takes the plain path on every device, as in JAX
    (kernels/flash_attention.py:526). At q_offset 0 (the first chunk of a
    chunked prefill) a card launches K1: JAX takes XLA there only because
    its offset is traced, and the math (causal over the chunk, segments
    from the cache) is the same.

    An int8 cache (its scales ks, vs [B, Hkv, Skv, 1]) is JAX's XLA branch
    (layers.py:271-309) in plain torch on every device: scores from the
    int8 keys in f32, times the key scales and 1/sqrt(D); masked scores at
    DEFAULT_MASK_VALUE, softmax, rows that see no key written as 0; p times
    the value scales, cast to q's dtype, then the product with the int8
    values in f32."""
    if ks is None:
        return flash_attention(q, kc, vc, causal=True, q_offset=q_offset,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = kc.shape[1], kc.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D)
    # the int8 values are exact in bf16 and f32, so widening them to f32
    # is JAX's cast to q's dtype with an f32 product
    s = torch.matmul(qg.float(), kc.float()[:, :, None].mT)  # [B,Hkv,g,Sq,Skv]
    s = s * ks[..., 0][:, :, None, None, :] * (1.0 / (D ** 0.5))
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = (qi >= ki)[None, None, None]
    if kv_segment_ids is not None:
        seg = ((q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
               & (kv_segment_ids[:, None, :] >= 0))
        mask = mask & seg[:, None, None]
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    pv = (p * vs[..., 0][:, :, None, None, :]).to(q.dtype)
    out = torch.matmul(pv.float(), vc.float()[:, :, None])
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def attend(
    q: torch.Tensor,                     # [B, S, Hq * head_dim]
    k: torch.Tensor,                     # [B, S, Hkv * head_dim]
    v: torch.Tensor,
    *,
    head_dim: int,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_cache: Optional[tuple] = None,
    cache_len: int = 0,
    cache_segments: Optional[torch.Tensor] = None,
    decode_multi: bool = False,
) -> torch.Tensor:
    """The attention of `mha` between its projections: q, k, v split into
    heads (their counts from the widths), RoPE, the cache write and the
    attention; returns [B, S, Hq * head_dim], before the output projection.
    A tensor-parallel shard (parallel/inference.py) calls it on its own
    heads."""
    B, S, _ = q.shape
    q = q.reshape(B, S, -1, head_dim).transpose(1, 2)
    k = k.reshape(B, S, -1, head_dim).transpose(1, 2)
    v = v.reshape(B, S, -1, head_dim).transpose(1, 2)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    if kv_cache is not None:
        kc, vc = kv_cache[:2]
        ks = vs = None
        if len(kv_cache) == 4:           # int8: quantized k/v and scales
            ks, vs = kv_cache[2:]
            kq, ksn = quantize_kv(k)
            vq, vsn = quantize_kv(v)
            kc[:, :, cache_len:cache_len + S] = kq
            vc[:, :, cache_len:cache_len + S] = vq
            ks[:, :, cache_len:cache_len + S] = ksn
            vs[:, :, cache_len:cache_len + S] = vsn
        else:
            kc[:, :, cache_len:cache_len + S] = k.to(kc.dtype)
            vc[:, :, cache_len:cache_len + S] = v.to(vc.dtype)
        if S > 1 and not decode_multi:
            out = flash_attention(q, k, v, causal=True,
                                  q_segment_ids=q_segment_ids,
                                  kv_segment_ids=kv_segment_ids)
        else:
            # slots past the written prefix are masked either way; reading
            # only the prefix saves the rest of the buffer's bytes
            n = cache_len + S
            q_seg = (torch.zeros((B, S), dtype=torch.int32, device=q.device)
                     if cache_segments is not None else None)
            out = cache_attention(
                q, kc[:, :, :n], vc[:, :, :n],
                None if ks is None else ks[:, :, :n],
                None if vs is None else vs[:, :, :n], q_offset=cache_len,
                q_segment_ids=q_seg,
                kv_segment_ids=(cache_segments[:, :n].contiguous()
                                if cache_segments is not None else None))
    else:
        out = flash_attention(q, k, v, causal=causal,
                              q_segment_ids=q_segment_ids,
                              kv_segment_ids=kv_segment_ids)
    return out.transpose(1, 2).reshape(B, S, -1)


def mha(
    params: dict,
    x: torch.Tensor,                     # [B, S, D]
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_cache: Optional[tuple] = None,    # (k, v[, k_scale, v_scale])
    cache_len: int = 0,
    cache_segments: Optional[torch.Tensor] = None,   # [B, Smax]
    decode_multi: bool = False,
) -> torch.Tensor:
    """Multi-head attention with optional GQA, RoPE and a per-layer cache.

    With a cache ((k, v) views [B, Hkv, Smax, D] of one layer, written in
    place at cache_len; an int8 cache adds its (k_scale, v_scale) views and
    takes k/v through `quantize_kv`): S > 1 without `decode_multi` is a
    prefill (fresh, unquantized k/v through the fused kernel, the cache
    starting at 0; only the cached copy is int8). Otherwise the S
    new tokens (S >= 1) attend to the cache prefix they were just written
    into: the JAX `mha_decode` (layers.py:381-440) on the stacked cache,
    with the queries in segment 0, the keys in the cache's segments (-1
    never attended) and q_offset = cache_len. That is a decode step (S 1),
    a speculative verify (k + 1 tokens) or a prefill chunk."""
    wq = params["wq"]["w"]
    group = tp_group(*(params[n]["w"] for n in ("wq", "wk", "wv", "wo")))
    if group is not None:
        if kv_cache is not None:
            raise ValueError("tensor-parallel training runs without a KV "
                             "cache (parallel/inference.py decodes split)")
        q, k, v = _tp_qkv(params, x, group, num_heads, num_kv_heads)
    else:
        q = dense(x, wq, params["wq"].get("b"))
        k = dense(x, params["wk"]["w"], params["wk"].get("b"))
        v = dense(x, params["wv"]["w"], params["wv"].get("b"))
    out = attend(q, k, v, head_dim=head_dim, rope=rope, causal=causal,
                 q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                 kv_cache=kv_cache, cache_len=cache_len,
                 cache_segments=cache_segments, decode_multi=decode_multi)
    if group is not None:
        return _tp_row(out, params["wo"]["w"], params["wo"].get("b"), group)
    return dense(out, params["wo"]["w"], params["wo"].get("b"))


def _tp_qkv(params: dict, x: torch.Tensor, group, num_heads: int,
            num_kv_heads: int):
    """The local q, k, v of a split attention: x enters the column region
    once; rank r's q heads are the r-th tp part of them. Where tp divides
    the kv heads, its k and v heads are the r-th part too; where the kv
    heads divide tp, the rep = tp / kv consecutive ranks whose q heads read
    one kv head each hold 1/rep of its columns (JAX's layout), gather it
    on use, and the gather's backward sums their gradients to it. A base
    left whole (quantized) gives the same columns, taken on use."""
    tp = group.size
    if num_heads % tp or (num_kv_heads % tp and tp % num_kv_heads):
        raise ValueError(f"{num_heads} q and {num_kv_heads} kv heads do not "
                         f"split over tp {tp}")
    x = copy_to(x, group)
    rep = 1 if num_kv_heads % tp == 0 else tp // num_kv_heads
    q = _tp_column(x, params["wq"]["w"], params["wq"].get("b"), group)
    return (q, *(_tp_column(x, params[n]["w"], params[n].get("b"), group,
                            rep) for n in ("wk", "wv")))


def _mlp_chunks(fn, x: torch.Tensor, seq_chunk: int) -> torch.Tensor:
    """fn over x [B, S, D] in sequence chunks of the largest divisor of S
    at most `seq_chunk`, each under a non-reentrant checkpoint (JAX
    layers.py:444-462): exact, as the MLP is per token. No chunking where
    seq_chunk is 0, S fits one chunk, or that divisor is 1."""
    if not seq_chunk or x.dim() != 3 or x.shape[1] <= seq_chunk:
        return fn(x)
    S = x.shape[1]
    c = seq_chunk
    while S % c:
        c -= 1
    if c == 1:
        return fn(x)
    from torch.utils.checkpoint import checkpoint
    return torch.cat([checkpoint(fn, x[:, i:i + c], use_reentrant=False,
                                 preserve_rng_state=False)
                      for i in range(0, S, c)], dim=1)


def swiglu_mlp(params: dict, x: torch.Tensor,
               seq_chunk: int = 0) -> torch.Tensor:
    """SwiGLU MLP; seq_chunk > 0 runs the sequence in checkpointed chunks
    (`_mlp_chunks`), which caps the backward's [S, I] intermediates at
    [chunk, I]. In a split layer (any base a `TPShard`) gate and up are one
    column region and down a row product."""
    group = tp_group(*(params[n]["w"] for n in ("gate", "up", "down")))

    def one(h):
        if group is not None:
            h = copy_to(h, group)
            gate, up = (_tp_column(h, params[n]["w"], None, group)
                        for n in ("gate", "up"))
            return _tp_row(F.silu(gate) * up, params["down"]["w"], None,
                           group)
        gate = dense(h, params["gate"]["w"])
        up = dense(h, params["up"]["w"])
        return dense(F.silu(gate) * up, params["down"]["w"])
    return _mlp_chunks(one, x, seq_chunk)


def gelu_mlp(params: dict, x: torch.Tensor,
             act: str = "quick_gelu") -> torch.Tensor:
    group = tp_group(params["fc1"]["w"], params["fc2"]["w"])
    if group is not None:                # fc1 by columns, fc2 by rows
        h = _tp_column(copy_to(x, group), params["fc1"]["w"],
                       params["fc1"].get("b"), group)
        return _tp_row(ACTIVATIONS[act](h), params["fc2"]["w"],
                       params["fc2"].get("b"), group)
    h = ACTIVATIONS[act](dense(x, params["fc1"]["w"], params["fc1"].get("b")))
    return dense(h, params["fc2"]["w"], params["fc2"].get("b"))


def _index(v, i):
    if hasattr(v, "tp_index"):           # a tensor-parallel part
        return v.tp_index(i)
    if hasattr(v, "zero_index"):         # a ZeRO-3 shard: gathered on use
        return v.zero_index(i)
    if hasattr(v, "_fields"):            # a LoRA view or a quantized leaf:
        return type(v)(*(_index(f, i) for f in v))   # slice every field
    return v[i]


def layer_slice(tree: dict, i) -> dict:
    """One layer's parameters (`i` an int), or a run of layers (`i` a
    slice), out of a tree stacked on a leading [L] axis (views, no
    copy). A ZeRO-3 leaf (parallel/sharding.ZeroShard) gathers one layer
    here, on use, and keeps a run of layers sharded; a tensor-parallel
    leaf (parallel/tensor.TPShard) gives its layer as a TPShard."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else _index(v, i)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter trees as modules
# ---------------------------------------------------------------------------

class QuantLeaf(torch.nn.Module):
    """A quantized leaf (`QuantWeight`, `QuantWeight4`) as a module holding
    its fields as frozen Parameters under their names (`...w.q4`,
    `...w.scale`). A module-wide dtype cast moves the fields but keeps their
    dtypes: the scales stay f32, as the kernels and the JAX tree have them."""

    def __init__(self, leaf):
        super().__init__()
        self.kind = type(leaf)
        for name, t in zip(leaf._fields, leaf):
            self.register_parameter(
                name, torch.nn.Parameter(t, requires_grad=False))

    def tree(self):
        return self.kind(*(self._parameters[n] for n in self.kind._fields))

    def _apply(self, fn, recurse=True):
        for name, p in self._parameters.items():
            new = fn(p)
            if new.dtype != p.dtype:     # a dtype cast: move, keep the dtype
                new = p.to(new.device)
            self._parameters[name] = torch.nn.Parameter(new,
                                                        requires_grad=False)
        return self


class ParamTree(torch.nn.Module):
    """An nn.Module over a nested dict of tensors: each dict level is a
    submodule and each leaf a frozen Parameter (a quantized leaf a
    `QuantLeaf`), so `state_dict()` keys are the JAX tree's key paths joined
    by '.', and a JAX tree converts leaf by leaf (weights/from_jax.py)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, torch.nn.Module):
                self.add_module(k, v)
            elif hasattr(v, "_fields"):
                self.add_module(k, QuantLeaf(v))
            else:
                self.register_parameter(
                    k, torch.nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        """The parameters as the nested dict the layer functions take."""
        out = {k: m.tree() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out
