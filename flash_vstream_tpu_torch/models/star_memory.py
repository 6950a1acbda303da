"""STAR memory of the LLaVA generation: spatial (current), long (clustered
temporal), Turing (NTM abstract) and retrieved (key frame) memory.

Port of flash_vstream_tpu/models/star_memory.py, the reference's
compress_temporal_features (Flash-VStream-LLaVA/flash_vstream/model/
vstream_arch.py:214-277) and its streaming writer embed_video_streaming
(vstream_arch.py:611-697): the offline consolidation of one video
(`star_consolidate`) and the streaming update over a ring bank of the
last `max_frames_static` frames (`star_stream_update`). Every section has
a static token capacity and a validity mask; the tokens are ordered
[Turing | long | key + current], the reference's concat.

Key frames are retrieved with the cluster centroids as queries, the JAX
package's reading of the reference's indexing quirk (ops/retrieval.py).
They are picked by plain indexing of the bank (three frames), not by the
row-gather kernel.

Differences from the JAX version, all of interface:
- `STARState.n_frames` is a host int (the session knows how many frames it
  fed), and the valid counts of the long and Turing memories follow from
  it, so the short phase, the growth of the Turing memory and the passing
  of invalid steps are host branches where JAX computes both sides and
  selects one;
- the bank is written in place; every tensor a snapshot holds is fresh;
- where JAX takes a PRNG key, these functions take `draws`, a function
  n -> [n] uniform f32 draws: the k-means init takes draws(T), the drop
  ops' coins are draws(T - t0) < 0.5 (`jax.random.bernoulli` is
  `uniform < p`). The tests hand in `jax.random.uniform(key, (n,))`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..core.config import STARConfig
from ..ops.kmeans import weighted_kmeans
from ..ops.ntm import NTMParams, ntm_compress, ntm_update
from ..ops.pooling import spatial_pool
from ..ops.retrieval import star_retrieve
from ..ops.sequential import drop_frames, k_drop_frames, k_merge_frames, merge_frames

Draws = Callable[[int], torch.Tensor]
KMEANS_TYPES = ("weighted_kmeans", "kmeans")
KMERGE_TYPES = ("kmerge", "uni_kmerge", "both_kmerge", "split_kmerge")


class STARMemory(NamedTuple):
    """Fixed-capacity memory tokens and their validity, ordered
    [Turing | long | key + current] like the reference concat."""
    tokens: torch.Tensor   # [n_tokens, D]
    valid: torch.Tensor    # [n_tokens] bool


def star_token_count(cfg: STARConfig) -> int:
    return (cfg.turing_length * cfg.turing_size ** 2
            + cfg.long_length * cfg.long_size ** 2
            + (cfg.key_length + cfg.current_length) * cfg.current_size ** 2)


def _compress_long(cfg: STARConfig, long_pooled: torch.Tensor,
                   long_valid: torch.Tensor, n_long: int, draws: Draws
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The long memory compressed by the configured op: (clusters [L, P_l,
    D] f32, cluster_valid [L], weights [L]). With n_long <= long_length the
    frames pass through with unit weights (compress_functions.py:160-161)."""
    L = cfg.long_length
    Tmax, Pl, D = long_pooled.shape
    dev = long_pooled.device
    if L == 0:
        # long memory off (video_long_memory_length=0 skips the whole
        # compress + retrieve block, vstream_arch.py:256-258)
        return (long_pooled.new_zeros(0, Pl, D, dtype=torch.float32),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.float32, device=dev))
    ct = cfg.compress_type
    if ct not in KMEANS_TYPES + KMERGE_TYPES + ("merge", "drop", "kdrop"):
        raise NotImplementedError(f"compress_type {ct}")
    slot = torch.arange(L, device=dev)
    if n_long <= L:                      # short video: pass through
        keep = slot < n_long
        clusters = torch.where(keep[:, None, None], long_pooled[:L].float(),
                               0.0)
        return clusters, keep, keep.float()
    flat = long_pooled.reshape(Tmax, Pl * D)
    if ct in KMEANS_TYPES:
        res = weighted_kmeans(flat, L, valid=long_valid,
                              init_scores=draws(Tmax))
        return (res.centroids.reshape(L, Pl, D), torch.ones_like(slot,
                                                                 dtype=torch.bool),
                res.cluster_weights)
    if ct == "merge":
        r = merge_frames(flat, n_long, L)
    elif ct == "drop":
        r = drop_frames(flat, n_long, L, draws(Tmax - L) < 0.5)
    elif ct in KMERGE_TYPES:
        # the reference maps every kmerge alias to k_merge_feature
        # (vstream_arch.py:633-635)
        r = k_merge_frames(flat, n_long, L)
    else:                                # kdrop
        r = k_drop_frames(flat, n_long, L, draws(Tmax - L) < 0.5)
    return (r.features.reshape(L, Pl, D),
            torch.ones(L, dtype=torch.bool, device=dev), r.valid.float())


def star_consolidate(
    ntm_params: NTMParams,
    cfg: STARConfig,
    features: torch.Tensor,      # [Tmax, P_cur, D] spatially pooled
    n_valid: int,                # frames present (>= 1)
    draws: Draws,
) -> STARMemory:
    """Offline STAR consolidation of one video's frame features, already
    pooled to current_size**2 tokens a frame (vstream_arch.py:319). The
    last current_length frames are the current memory; the frames before
    them are the history the other sections compress."""
    Tmax, P, D = features.shape
    if P != cfg.current_size ** 2:
        raise ValueError(f"features have {P} tokens a frame, want "
                         f"{cfg.current_size ** 2}")
    need = max(cfg.long_length, cfg.turing_length, cfg.current_length)
    if Tmax < need:
        # a bucket shorter than a memory section: JAX's shapes fail here
        # (a [Tmax] pass-through against [long_length] slots); frames past
        # n_valid are masked everywhere, so zero frames up to the longest
        # section give what a longer bucket gives
        features = torch.cat([features, features.new_zeros(need - Tmax, P,
                                                           D)])
        Tmax = need
    dev = features.device
    c = cfg.current_length
    n_hist = max(n_valid - c, 0)
    hist_valid = torch.arange(Tmax, device=dev) < n_hist

    long_pooled = spatial_pool(features, cfg.long_size)        # [Tmax, Pl, D]
    turing_pooled = spatial_pool(features, cfg.turing_size)    # [Tmax, Pt, D]

    clusters, cluster_valid, weights = _compress_long(
        cfg, long_pooled, hist_valid, n_hist, draws)

    if cfg.key_length == 0 or cfg.long_length == 0:
        # no retrieval without long-memory clusters to query (the reference
        # retrieves inside the long-compression branch only,
        # vstream_arch.py:260-270)
        key_frames = features[:0]
        key_valid = torch.zeros(0, dtype=torch.bool, device=dev)
    else:
        key_idx = star_retrieve(
            clusters.reshape(cfg.long_length, -1), weights,
            long_pooled.reshape(Tmax, -1), hist_valid, cfg.key_length)
        key_frames = features[key_idx.long()]                  # [k, P, D]
        key_valid = torch.full((cfg.key_length,), n_hist > 0, device=dev)

    turing = ntm_compress(ntm_params, turing_pooled, n_hist,
                          cfg.turing_length, cfg.turing_size ** 2,
                          cfg.turing_update_ratio)             # [Lt, Pt, D]
    turing_valid = (torch.arange(cfg.turing_length, device=dev)
                    < min(n_hist, cfg.turing_length))

    # the last c frames; the start clamps as lax.dynamic_slice's does
    cur_start = min(max(n_valid - c, 0), Tmax - c)
    cur = features[cur_start:cur_start + c]
    cur_valid = torch.arange(c, device=dev) < min(n_valid, c)

    tokens = torch.cat([turing.reshape(-1, D), clusters.reshape(-1, D),
                        key_frames.reshape(-1, D).float(),
                        cur.reshape(-1, D).float()])
    valid = torch.cat([
        turing_valid.repeat_interleave(cfg.turing_size ** 2),
        cluster_valid.repeat_interleave(cfg.long_size ** 2),
        key_valid.repeat_interleave(P),
        cur_valid.repeat_interleave(P),
    ])
    return STARMemory(tokens, valid)


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------

class STARState(NamedTuple):
    """Streaming memory state of one stream: the reference's shared
    [cur, long_compressed, Turing_compressed, img_feature_buffer]
    (vstream_arch.py:694), its unbounded frame buffer replaced by a ring
    bank of the last max_frames_static frames."""
    cur: torch.Tensor            # [c, P, D] current memory
    cur_valid: torch.Tensor      # [c] bool
    key_frames: torch.Tensor     # [k, P, D] retrieved memory
    key_valid: torch.Tensor      # [k] bool
    long: torch.Tensor           # [L, P_l, D] compressed long memory
    long_valid: torch.Tensor     # [L] bool
    long_weights: torch.Tensor   # [L]
    turing: torch.Tensor         # [Lt, P_t, D] compressed Turing memory
    turing_valid: torch.Tensor   # [Lt] bool
    bank: torch.Tensor           # [B, P, D] full-resolution frame ring
    bank_pos: torch.Tensor       # [B] int32 global frame index (-1 empty)
    n_frames: int                # frames seen


def init_star_state(cfg: STARConfig, feat_dim: int, device=None,
                    dtype=torch.float32) -> STARState:
    P = cfg.current_size ** 2
    Pl = cfg.long_size ** 2
    Pt = cfg.turing_size ** 2
    B = cfg.max_frames_static
    kw = dict(dtype=dtype, device=device)

    def flags(n):
        return torch.zeros(n, dtype=torch.bool, device=device)

    return STARState(
        cur=torch.zeros(cfg.current_length, P, feat_dim, **kw),
        cur_valid=flags(cfg.current_length),
        key_frames=torch.zeros(cfg.key_length, P, feat_dim, **kw),
        key_valid=flags(cfg.key_length),
        long=torch.zeros(cfg.long_length, Pl, feat_dim, **kw),
        long_valid=flags(cfg.long_length),
        long_weights=torch.zeros(cfg.long_length, **kw),
        turing=torch.zeros(cfg.turing_length, Pt, feat_dim, **kw),
        turing_valid=flags(cfg.turing_length),
        bank=torch.zeros(B, P, feat_dim, **kw),
        bank_pos=torch.full((B,), -1, dtype=torch.int32, device=device),
        n_frames=0,
    )


def _stable_valid_first(valid: torch.Tensor) -> torch.Tensor:
    """argsort(~valid), stable: the valid rows first, in order."""
    return torch.argsort((~valid).to(torch.int8), stable=True)


def star_stream_update(
    ntm_params: NTMParams,
    cfg: STARConfig,
    state: STARState,
    new_features: torch.Tensor,  # [T_new, P, D] pooled new-frame features
    n_new: int,                  # valid leading rows of new_features
    draws: Draws,
) -> STARState:
    """Fold a clip into the streaming memory (embed_video_streaming,
    vstream_arch.py:611-697): the old compressed long and Turing memories
    with the clip's pooled frames are compressed again, the key frames
    retrieved again from the bank, and the current memory refreshed. The
    bank of `state` is written in place (only the clip's valid rows)."""
    T_new, P, D = new_features.shape
    L, Lt, c = cfg.long_length, cfg.turing_length, cfg.current_length
    dev = new_features.device
    n0 = state.n_frames
    new_idx = torch.arange(T_new, device=dev)
    new_valid = new_idx < n_new

    # --- the ring bank (in place) ---
    B = state.bank.shape[0]
    wp = (n0 + new_idx[:n_new]) % B
    state.bank.index_copy_(0, wp, new_features[:n_new].to(state.bank.dtype))
    state.bank_pos.index_copy_(0, wp, (n0 + new_idx[:n_new]).to(torch.int32))
    bank, bank_pos = state.bank, state.bank_pos

    # --- long memory: [old compressed | new pooled], compressed again by
    # the configured op (the offline registry, vstream_arch.py:626-670) ---
    new_long = spatial_pool(new_features, cfg.long_size)
    cat_long = torch.cat([state.long, new_long.to(state.long.dtype)])
    cat_valid = torch.cat([state.long_valid, new_valid])
    cat_weights = torch.cat([
        torch.where(state.long_valid,
                    torch.clamp_min(state.long_weights, 1e-6), 0.0),
        new_valid.float()])
    n_cat = min(n0, L) + n_new           # = state.long_valid.sum() + n_new
    slot = torch.arange(L, device=dev)
    if n_cat <= L:
        # short phase: the valid rows packed into the first n_cat slots
        order = _stable_valid_first(cat_valid)
        in_prefix = slot < n_cat
        long_mem = torch.where(in_prefix[:, None, None], cat_long[order][:L],
                               0.0)
        long_weights = torch.where(in_prefix, cat_weights[order][:L], 0.0)
        long_valid = in_prefix
    elif cfg.compress_type in KMEANS_TYPES:
        res = weighted_kmeans(cat_long.reshape(L + T_new, -1), L,
                              weights=cat_weights, valid=cat_valid,
                              init_scores=draws(L + T_new))
        long_mem = res.centroids.reshape(L, *cat_long.shape[1:])
        long_weights = res.cluster_weights
        long_valid = torch.ones(L, dtype=torch.bool, device=dev)
    else:
        # the sequential ops take a packed valid prefix; their weights are
        # validity, as offline
        packed = cat_long[_stable_valid_first(cat_valid)]
        long_mem, long_valid, long_weights = _compress_long(
            cfg, packed, torch.arange(L + T_new, device=dev) < n_cat, n_cat,
            draws)

    # --- retrieval from the bank ---
    key_idx = star_retrieve(
        long_mem.reshape(L, -1), long_weights,
        spatial_pool(bank, cfg.long_size).reshape(B, -1),
        bank_pos >= 0, cfg.key_length)
    key_frames = bank[key_idx.long()]
    key_valid = torch.full((cfg.key_length,), n_cat > 0, device=dev)

    # --- Turing memory: one NTM write of the clip, or growth until Lt
    # frames are kept, the overflow NTM-blended into the packed memory
    # (attention_feature, compress_functions.py:263-277) ---
    Pt = cfg.turing_size ** 2
    new_turing = spatial_pool(new_features, cfg.turing_size)
    n_tur = min(n0, Lt)                  # = state.turing_valid.sum()
    if n_tur < Lt:
        cat_tur = torch.cat([state.turing, new_turing.to(state.turing.dtype)])
        cat_tvalid = torch.cat([state.turing_valid, new_valid])
        torder = _stable_valid_first(cat_tvalid)
        packed_all, packed_valid_all = cat_tur[torder], cat_tvalid[torder]
        turing = packed_all[:Lt]
        turing_valid = packed_valid_all[:Lt]
        if n_tur + n_new > Lt:           # some frames overflow
            overflow_valid = packed_valid_all[Lt:Lt + T_new]
            turing = ntm_update(
                ntm_params, turing.reshape(-1, D),
                packed_all[Lt:Lt + T_new].reshape(-1, D),
                overflow_valid.repeat_interleave(Pt),
                cfg.turing_update_ratio).reshape(turing.shape)
    else:
        updated = ntm_update(
            ntm_params, state.turing.reshape(-1, D),
            new_turing.reshape(-1, D), new_valid.repeat_interleave(Pt),
            cfg.turing_update_ratio).reshape(state.turing.shape)
        turing = torch.where(state.turing_valid[:, None, None], updated,
                             state.turing)
        turing_valid = state.turing_valid

    # --- current memory: the last c valid frames of the stream ---
    cat_cur = torch.cat([state.cur, new_features.to(state.cur.dtype)])
    cat_cvalid = torch.cat([state.cur_valid, new_valid])
    corder = torch.argsort(cat_cvalid.to(torch.int32), stable=True)
    cur = cat_cur[corder][-c:]
    cur_valid = cat_cvalid[corder][-c:]

    return STARState(
        cur=cur, cur_valid=cur_valid,
        key_frames=key_frames, key_valid=key_valid,
        long=long_mem.to(state.long.dtype), long_valid=long_valid,
        long_weights=long_weights.to(state.long_weights.dtype),
        turing=turing.to(state.turing.dtype), turing_valid=turing_valid,
        bank=bank, bank_pos=bank_pos,
        n_frames=n0 + n_new,
    )


def star_memory_tokens(cfg: STARConfig, state: STARState) -> STARMemory:
    """The streaming state as LLM-ready memory tokens, ordered [Turing |
    long | key + current] (vstream_arch.py:483); fresh tensors."""
    D = state.cur.shape[-1]
    tokens = torch.cat([
        state.turing.reshape(-1, D), state.long.reshape(-1, D),
        state.key_frames.reshape(-1, D), state.cur.reshape(-1, D)])
    valid = torch.cat([
        state.turing_valid.repeat_interleave(cfg.turing_size ** 2),
        state.long_valid.repeat_interleave(cfg.long_size ** 2),
        state.key_valid.repeat_interleave(cfg.current_size ** 2),
        state.cur_valid.repeat_interleave(cfg.current_size ** 2),
    ])
    return STARMemory(tokens, valid)
