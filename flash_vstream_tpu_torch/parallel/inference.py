"""Tensor-parallel decode: the decoder's weights split over the 'tp' axis of
a mesh, one shard tree per decode device.

Port of flash_vstream_tpu/parallel/inference.py. JAX places the weights
and lets GSPMD insert the collectives; here one controller drives every
shard and the collectives are written out where GSPMD puts them
(`sharding.LLM_RULES`):

- q, k, v (and their biases) are column-parallel: shard r holds q heads
  [r Hq/tp, (r + 1) Hq/tp) and the kv heads they read, kv head
  h // (Hq / Hkv) (Megatron's replication where tp exceeds Hkv), so no
  shard splits a head;
- wo is row-parallel over those heads, followed by an all-reduce;
- gate and up are column-parallel, down row-parallel, then an all-reduce;
- the embedding is split over the vocabulary: a masked row gather on each
  shard, then an all-reduce (exact: one shard holds the row, the others
  add zeros);
- the lm_head is column-parallel over the vocabulary: the shards' logits
  are gathered onto the first decode device;
- RMS norms and residual adds run replicated, once per distinct device.

A quantized leaf's path ends in its field (".../wq/w/.q4"), so no rule
matches it and it stays whole on every decode device, as in JAX. A whole
column-parallel weight runs its product once, on the first decode device,
and each shard takes its columns; a whole row-parallel weight (wo, down)
cannot be summed as partials, so its input is gathered there and the
product runs once (an int4 decode matvec through K6), its result
broadcast. Under a quantized base the decode is therefore the one-device
arithmetic, split only in attention and the embedding.

The collectives are `TPGroup`'s plain tensor operations: a partial moves
with `.to(device)`, partials are summed in rank order (shard 0 first) so a
result never depends on timing, and a device listed twice (several shards
on one card) gets one sum. `TPDecoder` has `Qwen2Decoder`'s interface, so
`Generator` and the streaming session take it; its KV cache (`TPKVCache`)
is one `KVCache` per shard, holding that shard's kv heads.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import KVCache, attend, dense, layer_slice, rms_norm
from ..models.llm import Qwen2Decoder, _rope_for, embed_tokens, lm_head
from .sharding import (Mesh, PartitionSpec, _fit_mesh, create_mesh,
                       map_with_path, param_pspec, param_shardings,
                       visible_devices)
from ..weights.quantize import path_str


class TPGroup:
    """The collectives of a tensor-parallel group over `devices` (rank r on
    devices[r]), as plain tensor operations on one controller."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.size = len(self.devices)

    def per_device(self, fn: Callable, *per_rank: list) -> list:
        """fn(r, *args of rank r) once per distinct device (at its first
        rank), the result shared by every rank on that device: the
        replicated part of the computation."""
        done, out = {}, []
        for r, d in enumerate(self.devices):
            if d not in done:
                done[d] = fn(r, *(a[r] for a in per_rank))
            out.append(done[d])
        return out

    def broadcast(self, x: torch.Tensor) -> list:
        """x on every rank's device."""
        return self.per_device(lambda r: x.to(self.devices[r]))

    def all_reduce(self, parts: Sequence[torch.Tensor]) -> list:
        """The sum of the ranks' partials on every rank's device, added in
        rank order."""
        def total(r):
            acc = parts[0].to(self.devices[r])
            for p in parts[1:]:
                acc = acc + p.to(self.devices[r])
            return acc
        return self.per_device(total)

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The ranks' parts concatenated along `dim` in rank order, on the
        first rank's device."""
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=dim)


class TPKVCache:
    """One `KVCache` a shard, each holding the shard's kv heads on its
    device; `length` is theirs, set on all at once."""

    def __init__(self, shards: List[KVCache]):
        self.shards = shards

    @property
    def length(self) -> int:
        return self.shards[0].length

    @length.setter
    def length(self, n: int) -> None:
        for c in self.shards:
            c.length = n

    def write_segments(self, seg: torch.Tensor) -> None:
        for c in self.shards:
            c.write_segments(seg.to(c.segments.device))


def _cuts(path: str, n: int, tp: int, cfg) -> List[Tuple[int, int]]:
    """Each rank's [lo, hi) of a split dim of size n. The k and v
    projections (weights and biases) take the kv heads their rank's q heads
    read; every other split is even."""
    if re.search(r"layers/attn/w[kv]/[wb]$", path):
        Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        qs, g = Hq // tp, Hq // Hkv
        return [(r * qs // g * Dh, ((r + 1) * qs - 1) // g * Dh + Dh)
                for r in range(tp)]
    if n % tp:
        raise ValueError(f"{path}: dim of {n} does not split over tp {tp}")
    return [(r * n // tp, (r + 1) * n // tp) for r in range(tp)]


class TPDecoder:
    """A Qwen2/Llama decoder split over tp devices: `shards[r]` is rank r's
    parameter tree on `devices[r]`, `specs` the spec of every leaf, `cuts`
    each split leaf's [lo, hi) a rank.
    `forward`, `logits`, `embed_tokens`, `device` (the first decode
    device, where inputs and outputs live) and `cfg` are `Qwen2Decoder`'s;
    `new_cache` makes the per-shard cache the Generator uses."""

    def __init__(self, cfg, shards: List[dict], specs: dict, cuts: dict,
                 devices: Sequence[torch.device]):
        self.cfg = cfg
        self.shards = shards
        self.specs = specs
        self.cuts = cuts
        self.group = TPGroup(devices)

    @property
    def device(self) -> torch.device:
        return self.group.devices[0]

    def _split(self, path: str) -> bool:
        """Whether the leaf at `path` is split over tp (False for a whole
        leaf, a quantized one among them)."""
        node = self.specs
        for k in path.split("/"):
            node = node[k]
        return isinstance(node, PartitionSpec) and "tp" in node

    def new_cache(self, batch: int, length: int, dtype) -> TPKVCache:
        cfg = self.cfg
        return TPKVCache([
            KVCache.create(cfg.num_layers, batch, (hi - lo) // cfg.head_dim,
                           length, cfg.head_dim, dtype, d)
            for (lo, hi), d in zip(self.cuts["layers/attn/wk/w"],
                                   self.group.devices)])

    def _column(self, lps: list, block: str, name: str, h: list) -> list:
        """Each rank's columns of h @ w (+ b): its own shard's product, or
        for a whole weight the columns of one product on the first device."""
        path = f"layers/{block}/{name}/w"
        ps = [lp[block][name] for lp in lps]
        if self._split(path):
            return [dense(h[r], p["w"], p.get("b")) for r, p in enumerate(ps)]
        full = dense(h[0], ps[0]["w"])
        out = []
        for r, ((lo, hi), p) in enumerate(zip(self.cuts[path], ps)):
            part = full[..., lo:hi].to(self.group.devices[r])
            if p.get("b") is not None:
                part = part + p["b"].to(part.dtype)
            out.append(part)
        return out

    def _row(self, lps: list, block: str, name: str, parts: list) -> list:
        """sum_r parts[r] @ w_r (+ b) on every rank: the all-reduce of the
        shards' partials, or for a whole weight one product on the first
        device over the gathered input, broadcast."""
        g = self.group
        ps = [lp[block][name] for lp in lps]
        if self._split(f"layers/{block}/{name}/w"):
            out = g.all_reduce([dense(parts[r], p["w"])
                                for r, p in enumerate(ps)])
        else:
            out = g.broadcast(dense(g.gather(parts, -1), ps[0]["w"]))
        if ps[0].get("b") is not None:
            out = g.per_device(lambda r, y: y + ps[r]["b"].to(y.dtype), out)
        return out

    def forward(self, input_embeds: torch.Tensor, positions: torch.Tensor, *,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[TPKVCache] = None,
                decode_multi: bool = False) -> torch.Tensor:
        """`decoder_forward` over the shards (the same cache rules): the
        final hidden states [B, S, D] on the first decode device."""
        cfg, g = self.cfg, self.group
        eps, Dh = cfg.rms_norm_eps, cfg.head_dim
        B, S, _ = input_embeds.shape
        tp = g.size
        x = g.broadcast(input_embeds)
        rope = g.per_device(lambda r, p: _rope_for(cfg, p),
                            g.broadcast(positions))
        seg = (g.broadcast(segment_ids) if segment_ids is not None
               else [None] * tp)
        if cache is not None:
            if S > 1 and cache.length and not decode_multi:
                raise ValueError(
                    f"a prefill starts at an empty cache (length "
                    f"{cache.length}); pass decode_multi=True to append S > 1 "
                    f"tokens to a prefix")
            cache_len = cache.length
            cache.write_segments(
                segment_ids if segment_ids is not None
                else torch.zeros((B, S), dtype=torch.int32,
                                 device=self.device))
        for i in range(cfg.num_layers):
            lps = [layer_slice(s["layers"], i) for s in self.shards]
            h = g.per_device(lambda r, xr: rms_norm(
                xr, lps[r]["attn_norm"], eps), x)
            q, k, v = (self._column(lps, "attn", n, h)
                       for n in ("wq", "wk", "wv"))
            att = []
            for r in range(tp):
                kw = {}
                if cache is not None:
                    c = cache.shards[r]
                    kw = dict(kv_cache=c.layer(i), cache_len=cache_len,
                              cache_segments=c.segments,
                              decode_multi=decode_multi)
                att.append(attend(q[r], k[r], v[r], head_dim=Dh,
                                  rope=rope[r], causal=True,
                                  q_segment_ids=seg[r],
                                  kv_segment_ids=seg[r], **kw))
            y = self._row(lps, "attn", "wo", att)
            x = g.per_device(lambda r, a, b: a + b, x, y)
            h = g.per_device(lambda r, xr: rms_norm(
                xr, lps[r]["mlp_norm"], eps), x)
            gate, up = (self._column(lps, "mlp", n, h) for n in ("gate", "up"))
            y = self._row(lps, "mlp", "down",
                          [F.silu(a) * b for a, b in zip(gate, up)])
            x = g.per_device(lambda r, a, b: a + b, x, y)
        if cache is not None:
            cache.length += S
        return rms_norm(x[0], self.shards[0]["final_norm"], eps)

    __call__ = forward

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits [..., V] on the first decode device: each shard's
        vocabulary columns, gathered (a whole head: one product there)."""
        head = "lm_head" if "lm_head" in self.shards[0] else "embed"
        if not self._split(head):
            return lm_head(self.shards[0], self.cfg, hidden)
        hs = self.group.broadcast(hidden)
        return self.group.gather([lm_head(s, self.cfg, hs[r])
                                  for r, s in enumerate(self.shards)], -1)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Embedding rows on the first decode device: each shard gathers
        the rows of its vocabulary range (zeros elsewhere), all-reduced."""
        g = self.group
        if not self._split("embed"):
            return embed_tokens(self.shards[0], input_ids)
        ids = g.broadcast(input_ids)
        parts = []
        for r, (lo, hi) in enumerate(self.cuts["embed"]):
            local = ids[r] - lo
            inside = (local >= 0) & (local < hi - lo)
            rows = self.shards[r]["embed"][local.clamp(0, hi - lo - 1)]
            parts.append(torch.where(inside[..., None], rows,
                                     rows.new_zeros(())))
        return g.all_reduce(parts)[0]


def shard_params_for_inference(decoder: Qwen2Decoder,
                               mesh: Optional[Mesh] = None,
                               tp: Optional[int] = None):
    """The decoder split over a (1, tp) mesh: returns (TPDecoder, mesh).

    With no mesh, the mesh is the first `tp` visible cards (tp None: all of
    them). JAX's function takes the bare tree, its model functions taking
    the config apart; the port's decoder carries its config. Each split
    leaf is sliced per rank and copied to that rank's device (contiguous,
    as it would sit on a card of its own); a leaf no rule splits, a
    quantized one among them, goes whole to every device (`.to`: no copy on
    the device it is on)."""
    if mesh is None:
        devices = visible_devices()
        mesh = create_mesh(dp=1, tp=len(devices) if tp is None else tp,
                           devices=devices)
    if mesh.axis_names != ("dp", "tp") or mesh.shape["dp"] != 1:
        raise ValueError(f"tensor-parallel decode takes a (1, tp) mesh, got "
                         f"{mesh}")
    cfg = decoder.cfg
    devices = list(mesh.devices[0])
    tp = len(devices)
    if cfg.num_heads % tp or not (cfg.num_kv_heads % tp == 0
                                  or tp % cfg.num_kv_heads == 0):
        raise ValueError(f"tp {tp} must divide the {cfg.num_heads} q heads, "
                         f"and divide or be a multiple of the "
                         f"{cfg.num_kv_heads} kv heads")
    tree = decoder.tree()
    specs = param_shardings(mesh, tree)
    cuts = {}

    def place(r):
        def one(path, x):
            p = path_str(path)
            spec = _fit_mesh(param_pspec(p, x.dim()), mesh)
            if "tp" not in spec:
                return x.to(devices[r])
            dim = spec.index("tp")
            if p not in cuts:
                cuts[p] = _cuts(p, x.shape[dim], tp, cfg)
            lo, hi = cuts[p][r]
            return x.narrow(dim, lo, hi - lo).to(devices[r]).contiguous()
        return map_with_path(one, tree)

    shards = [place(r) for r in range(tp)]
    # the column cuts of whole (quantized) weights, which no spec splits
    for p, n in (("layers/attn/wq/w", cfg.num_heads * cfg.head_dim),
                 ("layers/attn/wk/w", cfg.num_kv_heads * cfg.head_dim),
                 ("layers/attn/wv/w", cfg.num_kv_heads * cfg.head_dim),
                 ("layers/mlp/gate/w", cfg.intermediate_size),
                 ("layers/mlp/up/w", cfg.intermediate_size)):
        cuts.setdefault(p, _cuts(p, n, tp, cfg))
    return TPDecoder(cfg, shards, specs, cuts, devices), mesh

