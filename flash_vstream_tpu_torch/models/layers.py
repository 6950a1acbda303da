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
(train/lora.py's `LoRAWeight`). The int8 KV cache raises
NotImplementedError (ROADMAP A10).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.int4_matmul import int4_matmul_cuda, int4_matmul_supported
from ..weights.quantize import dequantize_weight4


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
    so on the CPU the port matches JAX op for op."""
    if hasattr(w, "a"):                  # train/lora.LoRAWeight
        out = dense(x, w.w)
        lora = torch.matmul(torch.matmul(x, w.a.to(x.dtype)), w.b.to(x.dtype))
        out = out + lora.to(out.dtype)
    elif hasattr(w, "q"):                # weights/quantize.QuantWeight
        if W8A8_PREFILL and x.dim() >= 2 and x.shape[-2] >= _W8A8_MIN_ROWS:
            out = _w8a8_dot(x, w.q, w.scale)
        else:
            out = torch.matmul(x, w.q.to(x.dtype))
            out = out * w.scale.to(out.dtype)
    elif hasattr(w, "q4"):               # weights/quantize.QuantWeight4
        rows = math.prod(x.shape[:-1])
        if (x.is_cuda and w.q4.dim() == 2
                and int4_matmul_supported(rows, w.q4.shape[0],
                                          w.scale.shape[0], w.q4.shape[1])):
            out = int4_matmul_cuda(x.reshape(rows, x.shape[-1]), w.q4,
                                   w.scale, out_dtype=x.dtype)
            out = out.reshape(*x.shape[:-1], w.q4.shape[-1])
        else:
            out = torch.matmul(x, dequantize_weight4(w, x.dtype))
    elif isinstance(w, torch.Tensor):
        out = torch.matmul(x, w.to(x.dtype))
    else:
        raise TypeError(f"dense takes a tensor, a QuantWeight, a QuantWeight4 "
                        f"or a LoRA view, not {type(w).__name__}")
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
    segments: [B, Smax] int32, -1 = padding or not yet written."""
    k: torch.Tensor
    v: torch.Tensor
    length: int
    segments: torch.Tensor

    @classmethod
    def create(cls, num_layers: int, batch: int, num_kv_heads: int,
               max_len: int, head_dim: int, dtype=torch.bfloat16,
               device=None) -> "KVCache":
        if dtype == torch.int8:
            raise NotImplementedError("the int8 KV cache is not ported yet: "
                                      "ROADMAP A10")
        shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0,
                   torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device))

    def write_segments(self, seg: torch.Tensor) -> None:
        """Segment ids of the S tokens being appended at `length`."""
        self.segments[:, self.length:self.length + seg.shape[1]] = seg


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


def cache_attention(q, kc, vc, *, q_offset, q_segment_ids, kv_segment_ids):
    """Attention of new tokens over a bf16 cache prefix. At q_offset > 0 (a
    decode step, a speculative verify, a later prefill chunk) it is the
    plain path on every device, as in JAX (kernels/flash_attention.py:526).
    At q_offset 0 (the first chunk of a chunked prefill) a card launches K1:
    JAX takes XLA there only because its offset is traced, and the math
    (causal over the chunk, segments from the cache) is the same."""
    return flash_attention(q, kc, vc, causal=True, q_offset=q_offset,
                           q_segment_ids=q_segment_ids,
                           kv_segment_ids=kv_segment_ids)


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
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: int = 0,
    cache_segments: Optional[torch.Tensor] = None,   # [B, Smax]
    decode_multi: bool = False,
) -> torch.Tensor:
    """Multi-head attention with optional GQA, RoPE and a per-layer cache.

    With a cache ((k, v) views [B, Hkv, Smax, D] of one layer, written in
    place at cache_len): S > 1 without `decode_multi` is a prefill (fresh
    k/v through the fused kernel, the cache starting at 0). Otherwise the S
    new tokens (S >= 1) attend to the cache prefix they were just written
    into: the JAX `mha_decode` (layers.py:381-440) on the stacked cache,
    with the queries in segment 0, the keys in the cache's segments (-1
    never attended) and q_offset = cache_len. That is a decode step (S 1),
    a speculative verify (k + 1 tokens) or a prefill chunk."""
    B, S, _ = x.shape
    q = dense(x, params["wq"]["w"], params["wq"].get("b"))
    k = dense(x, params["wk"]["w"], params["wk"].get("b"))
    v = dense(x, params["wv"]["w"], params["wv"].get("b"))
    q = q.reshape(B, S, num_heads, head_dim).transpose(1, 2)
    k = k.reshape(B, S, num_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(B, S, num_kv_heads, head_dim).transpose(1, 2)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    if kv_cache is not None:
        kc, vc = kv_cache
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
            q_seg = (torch.zeros((B, S), dtype=torch.int32, device=x.device)
                     if cache_segments is not None else None)
            out = cache_attention(
                q, kc[:, :, :n], vc[:, :, :n], q_offset=cache_len,
                q_segment_ids=q_seg,
                kv_segment_ids=(cache_segments[:, :n].contiguous()
                                if cache_segments is not None else None))
    else:
        out = flash_attention(q, k, v, causal=causal,
                              q_segment_ids=q_segment_ids,
                              kv_segment_ids=kv_segment_ids)
    out = out.transpose(1, 2).reshape(B, S, num_heads * head_dim)
    return dense(out, params["wo"]["w"], params["wo"].get("b"))


def swiglu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = dense(x, params["gate"]["w"])
    up = dense(x, params["up"]["w"])
    return dense(F.silu(gate) * up, params["down"]["w"])


def gelu_mlp(params: dict, x: torch.Tensor,
             act: str = "quick_gelu") -> torch.Tensor:
    h = ACTIVATIONS[act](dense(x, params["fc1"]["w"], params["fc1"].get("b")))
    return dense(h, params["fc2"]["w"], params["fc2"].get("b"))


def _index(v, i: int):
    if hasattr(v, "_fields"):            # a LoRA view or a quantized leaf:
        return type(v)(*(_index(f, i) for f in v))   # slice every field
    return v[i]


def layer_slice(tree: dict, i: int) -> dict:
    """One layer's parameters out of a tree stacked on a leading [L] axis
    (views, no copy)."""
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
