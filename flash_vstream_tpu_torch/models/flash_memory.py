"""Flash Memory (Qwen generation): CSM clustered temporal memory, DAM
retrieved spatial memory, and AM-RoPE visual positions, in the streaming form
and the offline form of training.

Port of flash_vstream_tpu/models/flash_memory.py:47-70, 127-265, 271-346,
351-539. `flash_stream_update` folds one clip into a ring-buffered frame
bank, re-clusters [old clusters | new frames] into K CSM clusters with
ordered weighted k-means, and retrieves t_dam full-resolution DAM frames,
gathered out of the bank by the row-gather kernel K2. `flash_consolidate`
compresses a whole video at once (offline QA, training), and `cat_spa_tem`
lays out the [DAM | CSM] token stream for the PatchMerger.
`mm_rope_positions` (with `qwen_rope_positions`, its one-video case) lays
out the 3D rope positions of a prompt with any sequence of image and video
blocks, on the host.

Differences from the JAX version, all of interface:
- the banks are updated in place (`index_copy_`), where JAX donates and
  rewrites the state; every tensor the update publishes is fresh, so a
  snapshot held by a reader never changes under it;
- `n_frames` is a host int: the session knows how many frames it fed, so
  the short-stream branches and the sequential methods' frame counts are
  host branches where JAX computes both sides and selects one;
- where JAX takes a PRNG key, both functions take `draws`, a function
  n -> [n] uniform f32 draws (torch cannot reproduce jax.random): the
  k-means init takes draws(T), the drop coins are draws(T - t0) < 0.5
  (`jax.random.bernoulli` is `uniform < p`), as STAR's functions do; the
  tests hand in `jax.random.uniform(key, (n,))`.

Temporal methods, every entry of JAX's registry: the k-means family
(kmeans, kmeans_ordered, fast_kmeans_ordered), the PCA k-means
(pca_kmeans_ordered, torchpca_kmeans_ordered), merge and drop (timed
sequential scans), attention (the parameter-free Turing blend), sample,
and offline dbscan and gmm (streaming sends those two, and the PCA names,
to ordered k-means, as JAX does). Spatial methods: klarge_retrieve(_cos),
sample, nearest.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import FlashMemoryConfig

from ..kernels.gather_rows import gather_rows
from ..ops.kmeans import pca_weighted_kmeans_ordered, weighted_kmeans
from ..ops.retrieval import dam_retrieve
from ..ops.sequential import (drop_frames_timed, merge_frames_timed,
                              sample_frames)

Draws = Callable[[int], torch.Tensor]
INT32_MAX = 2 ** 31 - 1
KMEANS_TEMPORAL = ("kmeans_ordered", "fast_kmeans_ordered", "kmeans")
PCA_TEMPORAL = ("pca_kmeans_ordered", "torchpca_kmeans_ordered")
# the Qwen 'attention' method's blend ratio: LLaVA STAR's Turing-memory
# decay (the reference's own Qwen entry calls attention_fn=None)
ATTENTION_UPDATE_RATIO = 0.2


class FlashMemoryOutput(NamedTuple):
    spa_x: torch.Tensor          # [t_dam, P_full, D] DAM frames (full res)
    spa_positions: torch.Tensor  # [t_dam] frame indices
    tem_x: torch.Tensor          # [t_csm, P_small, D] CSM clusters
    tem_weights: torch.Tensor    # [t_csm]
    tem_positions: torch.Tensor  # [t_csm] rounded cluster timestamps


class FlashState(NamedTuple):
    """Device-resident streaming Flash memory of one stream."""
    tem_x: torch.Tensor          # [K, P_small, D] CSM clusters
    tem_valid: torch.Tensor      # [K] bool
    tem_weights: torch.Tensor    # [K]
    tem_times: torch.Tensor      # [K] f32 global timestamps
    bank: torch.Tensor           # [B, P_full, D] full-res ring buffer
    bank_small: torch.Tensor     # [B, P_small, D] pooled ring buffer
    bank_pos: torch.Tensor       # [B] int32 global frame index, -1 = empty
    n_frames: int                # frame pairs folded in so far


def init_flash_state(cfg: FlashMemoryConfig, p_full: int, p_small: int,
                     feat_dim: int, bank_size: int = 1024, *, device=None,
                     dtype=torch.float32,
                     bank_dtype=torch.bfloat16) -> FlashState:
    """CSM centroids keep `dtype` (k-means accumulates in f32); the banks
    store raw ViT features in `bank_dtype`."""
    K = cfg.csm_grid_len
    kw = dict(device=device)
    return FlashState(
        tem_x=torch.zeros((K, p_small, feat_dim), dtype=dtype, **kw),
        tem_valid=torch.zeros(K, dtype=torch.bool, **kw),
        tem_weights=torch.zeros(K, dtype=torch.float32, **kw),
        tem_times=torch.zeros(K, dtype=torch.float32, **kw),
        bank=torch.zeros((bank_size, p_full, feat_dim), dtype=bank_dtype, **kw),
        bank_small=torch.zeros((bank_size, p_small, feat_dim),
                               dtype=bank_dtype, **kw),
        bank_pos=torch.full((bank_size,), -1, dtype=torch.int32, **kw),
        n_frames=0,
    )


def flash_state_from_numpy(state, device=None) -> FlashState:
    """A FlashState from the JAX one's fields as numpy arrays (for example
    `jax.tree.map(np.asarray, state)`), on `device`."""
    d = state._asdict() if hasattr(state, "_asdict") else dict(state)
    fields = {k: torch.from_numpy(np.array(d[k])).to(device)
              for k in FlashState._fields if k != "n_frames"}
    return FlashState(n_frames=int(d["n_frames"]), **fields)


def _ordered_kmeans_with_times(flat, k, weights, times, valid, init_scores,
                               iters=10):
    """Weighted k-means plus the weighted mean of member timestamps, the
    clusters sorted by that time."""
    res = weighted_kmeans(flat, k, weights=weights, valid=valid,
                          init_scores=init_scores, iters=iters)
    ar = torch.arange(k, device=flat.device)
    onehot = (res.labels[:, None] == ar[None, :]).float() * valid[:, None].float()
    w = weights * valid
    wsum = (onehot.T @ w[:, None])[:, 0]
    tsum = (onehot.T @ (w * times.float())[:, None])[:, 0]
    ts = torch.where(wsum > 0, tsum / torch.clamp_min(wsum, 1e-30),
                     float(flat.shape[0]))
    order = torch.argsort(ts, stable=True)
    return res.centroids[order], res.cluster_weights[order], ts[order]


def _attention_blend(memory: torch.Tensor, chunk: torch.Tensor,
                     key_valid: Optional[torch.Tensor] = None,
                     ratio: float = ATTENTION_UPDATE_RATIO) -> torch.Tensor:
    """The parameter-free Turing-memory blend: memory tokens [M, D] attend
    to chunk tokens [N, D] (scaled dot product, identity projections) and
    move toward what they read by `ratio`; with no valid key the memory is
    unchanged. f32."""
    mem = memory.float()
    scores = (mem @ chunk.float().T) / torch.sqrt(
        torch.tensor(float(memory.shape[-1])))
    if key_valid is not None:
        if not bool(key_valid.any()):
            return mem
        scores = torch.where(key_valid[None, :], scores, float("-inf"))
    read = torch.softmax(scores, dim=-1) @ chunk.float()
    return (1.0 - ratio) * mem + ratio * read


def _attention_compress(small_x: torch.Tensor, t_csm: int) -> torch.Tensor:
    """[t, P, D] -> [t_csm, P, D]: the memory is the first t_csm frames'
    tokens, and each later chunk of t_csm frames folds in through
    `_attention_blend` (the last chunk's missing frames masked)."""
    t, P, D = small_x.shape
    mem = small_x[:t_csm].reshape(t_csm * P, D).float()
    for c in range(t_csm, t, t_csm):
        chunk = small_x[c:c + t_csm].reshape(-1, D)
        n = chunk.shape[0]
        pad = t_csm * P - n
        key_valid = None
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros(pad, D)])
            key_valid = torch.arange(t_csm * P, device=small_x.device) < n
        mem = _attention_blend(mem, chunk, key_valid=key_valid)
    return mem.reshape(t_csm, P, D)


def flash_stream_update(
    cfg: FlashMemoryConfig,
    state: FlashState,
    new_x: torch.Tensor,         # [T_new, P_full, D]
    new_small: torch.Tensor,     # [T_new, P_small, D]
    n_new: int,                  # valid leading rows of new_x / new_small
    draws: Draws,                # n -> [n] uniforms (k-means init, coins)
    *,
    gather: bool = True,
):
    """Fold a clip into the streaming memory and produce the current
    [DAM | CSM] snapshot. The banks of `state` are written in place.
    Returns (state, snapshot); with gather=False the snapshot's spa_x is
    None and (state, snapshot, DAM bank indices [t_dam] int32) come back,
    so that a caller holding several streams' banks gathers them at once."""
    T_new, P_full, D = new_x.shape
    P_small = new_small.shape[1]
    K = cfg.csm_grid_len
    dev = new_x.device
    n0 = state.n_frames
    new_idx = torch.arange(T_new, device=dev)
    new_valid = new_idx < n_new
    new_times = (n0 + new_idx).float()

    # --- ring-buffer banks (in place; only the valid rows are written) ---
    B = state.bank.shape[0]
    wp = (n0 + new_idx[:n_new]) % B
    state.bank.index_copy_(0, wp, new_x[:n_new].to(state.bank.dtype))
    state.bank_small.index_copy_(0, wp,
                                 new_small[:n_new].to(state.bank_small.dtype))
    state.bank_pos.index_copy_(0, wp, (n0 + new_idx[:n_new]).to(torch.int32))
    bank, bank_pos = state.bank, state.bank_pos

    # --- CSM: concat old clusters + new frames, recluster ---
    cat_x = torch.cat([state.tem_x, new_small.to(state.tem_x.dtype)])
    cat_valid = torch.cat([state.tem_valid, new_valid])
    cat_w = torch.cat([
        torch.where(state.tem_valid,
                    torch.clamp_min(state.tem_weights, 1e-6), 0.0),
        new_valid.float()])
    cat_t = torch.cat([state.tem_times, new_times])
    n_cat = state.tem_valid.sum() + n_new
    flat = cat_x.reshape(K + T_new, P_small * D)
    # [old clusters | new frames] in temporal order, invalid rows last
    order = torch.argsort(torch.where(cat_valid, cat_t, float("inf")),
                          stable=True)
    method = cfg.temporal_method
    # the short branch: [old clusters | new frames] packed in order while
    # they fit in the K slots
    in_prefix = torch.arange(K, device=dev) < n_cat
    packed_idx = order[:K]
    short_x = torch.where(in_prefix[:, None, None], cat_x[packed_idx], 0.0)
    short_w = torch.where(in_prefix, cat_w[packed_idx], 0.0)
    short_t = torch.where(in_prefix, cat_t[packed_idx], 0.0)
    if method in ("sample", "merge", "drop", "attention"):
        # host loops or host branches: the count of valid rows on the host
        n_cat_host = int(n_cat)
        if n_cat_host <= K:
            tem_x, tem_weights, tem_times = short_x, short_w, short_t
            tem_valid = in_prefix
        else:
            srt_x, srt_w, srt_t = flat[order], cat_w[order], cat_t[order]
            if method == "sample":
                cents, idx = sample_frames(srt_x, n_cat_host, K)
                idx = idx.long()
                cw, cts = srt_w[idx], srt_t[idx]
            elif method == "attention":
                # cells: the first K entries; later ones fold in as one
                # parameter-free cross-attention blend
                rest_valid = (torch.arange(K, K + T_new, device=dev)
                              < n_cat_host).repeat_interleave(P_small)
                cents = _attention_blend(
                    srt_x[:K].reshape(K * P_small, D),
                    srt_x[K:].reshape(T_new * P_small, D),
                    key_valid=rest_valid)
                cw, cts = srt_w[:K], srt_t[:K]
            else:
                # the offline scan continued over [old cells | new frames]
                if method == "merge":
                    res = merge_frames_timed(srt_x, n_cat_host, K,
                                             times=srt_t, weights=srt_w)
                else:
                    res = drop_frames_timed(srt_x, n_cat_host, K,
                                            draws(T_new) < 0.5,
                                            times=srt_t, weights=srt_w)
                cents, cw, cts = res.features, res.weights, res.times
            tem_x = cents.reshape(K, P_small, D)
            tem_weights, tem_times = cw, cts
            tem_valid = torch.ones(K, dtype=torch.bool, device=dev)
    else:
        # the clustering registry; streaming sends the PCA, dbscan and gmm
        # names to ordered k-means too, as JAX does; both sides on the
        # device, selected by the device flag
        cents, cw, cts = _ordered_kmeans_with_times(
            flat, K, cat_w, cat_t, cat_valid, draws(K + T_new))
        is_short = n_cat <= K
        tem_x = torch.where(is_short, short_x, cents.reshape(K, P_small, D))
        tem_weights = torch.where(is_short, short_w, cw)
        tem_times = torch.where(is_short, short_t, cts)
        tem_valid = torch.where(is_short, in_prefix, True)

    n_total = n0 + n_new
    new_state = FlashState(tem_x=tem_x, tem_valid=tem_valid,
                           tem_weights=tem_weights, tem_times=tem_times,
                           bank=bank, bank_small=state.bank_small,
                           bank_pos=bank_pos, n_frames=n_total)

    # --- DAM retrieval from the pooled bank ---
    t_dam = cfg.dam_grid_len
    if n_total <= t_dam:
        # short stream: every frame, in temporal order; slots past n_total
        # repeat the earliest frame and are sliced off when the prompt is
        # built. The bank has not wrapped (n_total <= t_dam), so slot s
        # holds frame s unless the bank is smaller than t_dam.
        rank = torch.clamp(torch.arange(t_dam, device=dev), max=max(n_total, 1) - 1)
        if t_dam <= B:
            idx = rank
        else:
            idx = torch.argsort(torch.where(bank_pos >= 0, bank_pos,
                                            INT32_MAX), stable=True)[rank]
    elif cfg.spatial_method == "sample":
        order_b = torch.argsort(torch.where(bank_pos >= 0, bank_pos,
                                            INT32_MAX), stable=True)
        pos_f = (torch.linspace(0.0, 1.0, t_dam, device=dev)
                 * float(max(n_total, 1) - 1))
        idx = order_b[torch.clamp(pos_f.to(torch.int32), max=B - 1)]
    elif cfg.spatial_method == "nearest":
        # frames at the heaviest clusters' timestamps
        top = torch.argsort(-torch.where(tem_valid, tem_weights,
                                         float("-inf")), stable=True)[:t_dam]
        want = torch.round(tem_times[top]).to(torch.int32)
        hits = bank_pos[None, :] == want[:, None]
        idx = torch.where(hits.any(dim=1), hits.to(torch.uint8).argmax(dim=1),
                          0)
    else:
        metric = ("cosine" if cfg.spatial_method.endswith("_cos")
                  else "euclidean")
        idx, _ = dam_retrieve(
            tem_x, torch.where(tem_valid, tem_weights, float("-inf")),
            state.bank_small, bank_pos >= 0, t_dam, metric)
    idx = idx.to(torch.int32)
    out = FlashMemoryOutput(
        spa_x=gather_rows(bank, idx) if gather else None,
        spa_positions=bank_pos[idx.long()],
        tem_x=tem_x,
        tem_weights=tem_weights,
        tem_positions=torch.round(tem_times).to(torch.int32),
    )
    return (new_state, out) if gather else (new_state, out, idx)


def flash_consolidate(
    cfg: FlashMemoryConfig,
    x: torch.Tensor,             # [t, P_full, D] full-res per-frame features
    small_x: torch.Tensor,       # [t, P_small, D] pooled per-frame features
    *,
    draws: Optional[Draws] = None,  # n -> [n] uniforms (k-means, coins)
    times: Optional[torch.Tensor] = None,
) -> FlashMemoryOutput:
    """Offline consolidation of a whole video (FlashMemory.forward's
    per-sample pipeline). CSM: the t pooled frames themselves when
    t <= csm_grid_len, else the temporal method's csm_grid_len slots (the
    k-means methods draw their init from `draws`, drop its coins). DAM:
    every frame when t <= dam_grid_len, else the spatial method's
    dam_grid_len frames."""
    t, P_full, D = x.shape
    P_small = small_x.shape[1]
    dev = x.device
    t_csm = min(t, cfg.csm_grid_len)
    t_dam = min(t, cfg.dam_grid_len)
    if times is None:
        times = torch.arange(t, dtype=torch.float32, device=dev)
    method = cfg.temporal_method
    if (t > cfg.csm_grid_len and draws is None
            and method in (*KMEANS_TEMPORAL, *PCA_TEMPORAL, "drop")):
        raise ValueError(f"temporal_method {method!r} needs `draws`")
    flat = small_x.reshape(t, P_small * D)

    # --- CSM: temporal compression ---
    if t <= cfg.csm_grid_len:
        tem_x = small_x
        tem_weights = torch.ones(t, dtype=torch.float32, device=dev)
        tem_ts = times
    elif method in KMEANS_TEMPORAL:
        cents, tem_weights, tem_ts = _ordered_kmeans_with_times(
            flat, t_csm, torch.ones(t, dtype=torch.float32, device=dev),
            times, torch.ones(t, dtype=torch.bool, device=dev), draws(t))
        tem_x = cents.reshape(t_csm, P_small, D)
    elif method in PCA_TEMPORAL:
        res = pca_weighted_kmeans_ordered(
            flat, t_csm, cfg.temporal_pca_dim, init_scores=draws(t),
            tokens_per_frame=P_small)
        onehot = (res.labels.long()[:, None]
                  == torch.arange(t_csm, device=dev)[None, :]).float()
        counts = onehot.sum(dim=0)
        tsum = (onehot.T @ times.float()[:, None])[:, 0]
        tem_ts = torch.where(counts > 0,
                             tsum / torch.clamp_min(counts, 1.0), 0.0)
        order = torch.argsort(tem_ts, stable=True)
        tem_x = res.centroids[order].reshape(t_csm, P_small, D)
        tem_weights = res.cluster_weights[order]
        tem_ts = tem_ts[order]
    elif method in ("merge", "drop"):
        if method == "merge":
            res = merge_frames_timed(flat, t, t_csm, times=times)
        else:
            res = drop_frames_timed(flat, t, t_csm, draws(t - t_csm) < 0.5,
                                    times=times)
        tem_x = res.features.reshape(t_csm, P_small, D)
        tem_weights, tem_ts = res.weights, res.times
    elif method == "attention":
        tem_x = _attention_compress(small_x, t_csm)
        tem_weights = torch.ones(t_csm, dtype=torch.float32, device=dev)
        # the cells keep the timestamps of the frames that seeded them
        tem_ts = times[:t_csm]
    elif method == "sample":
        sampled, idx = sample_frames(flat, t, t_csm)
        tem_x = sampled.reshape(t_csm, P_small, D)
        tem_weights = torch.ones(t_csm, dtype=torch.float32, device=dev)
        tem_ts = times[idx.long()]
    elif method in ("dbscan", "gmm"):
        from ..ops.clustering_extra import dbscan_compress, gmm_compress
        res = (dbscan_compress(flat, t_csm) if method == "dbscan" else
               gmm_compress(flat, t_csm, pca_dim=cfg.temporal_pca_dim))
        # empty slots take the earliest frames (the reference pads with
        # img_feature[:pad])
        slot = torch.arange(t_csm, device=dev)
        fallback = flat[torch.clamp(slot, max=t - 1)].float()
        tem_x = torch.where(res.valid[:, None], res.centroids,
                            fallback).reshape(t_csm, P_small, D)
        onehot = (res.labels.long()[:, None] == slot[None, :]).float()
        counts = onehot.sum(dim=0)
        tsum = (onehot.T @ times.float()[:, None])[:, 0]
        tem_ts = torch.where(counts > 0, tsum / torch.clamp_min(counts, 1.0),
                             slot.float())
        tem_weights = torch.clamp_min(counts, 1.0)
    else:
        raise NotImplementedError(f"temporal_method {method}")
    tem_positions = torch.round(tem_ts).to(torch.int32)

    # --- DAM: spatial retrieval ---
    if cfg.dam_grid_len == 0:
        spa_x = x[:0]
        spa_positions = torch.zeros(0, dtype=torch.int32, device=dev)
    elif t <= cfg.dam_grid_len:
        spa_x = x
        spa_positions = torch.round(times).to(torch.int32)
    elif cfg.spatial_method in ("klarge_retrieve", "klarge_retrieve_cos"):
        metric = ("cosine" if cfg.spatial_method.endswith("_cos")
                  else "euclidean")
        idx, _ = dam_retrieve(tem_x, tem_weights, small_x,
                              torch.ones(t, dtype=torch.bool, device=dev),
                              t_dam, metric)
        idx = idx.long()
        spa_x = x[idx]
        spa_positions = torch.round(times[idx]).to(torch.int32)
    elif cfg.spatial_method == "sample":
        pos = torch.linspace(0.0, 1.0, t_dam, device=dev) * float(t - 1)
        idx = pos.to(torch.int32).long()
        spa_x = x[idx]
        spa_positions = torch.round(times[idx]).to(torch.int32)
    elif cfg.spatial_method == "nearest":
        top = torch.argsort(-tem_weights, stable=True)[:t_dam]
        idx = tem_positions[top]
        spa_x = x[idx.long()]
        spa_positions = idx
    else:
        raise NotImplementedError(f"spatial_method {cfg.spatial_method}")
    return FlashMemoryOutput(spa_x, spa_positions, tem_x, tem_weights,
                             tem_positions)


def cat_spa_tem(spa_x: torch.Tensor, tem_x: torch.Tensor) -> torch.Tensor:
    """DAM before CSM, each [t, P, D] flattened to tokens, 2x2 window
    grouping kept: [N_tok, D] (the wider of the two dtypes, as
    jnp.concatenate promotes)."""
    D = spa_x.shape[-1]
    dtype = torch.promote_types(spa_x.dtype, tem_x.dtype)
    return torch.cat([spa_x.reshape(-1, D).to(dtype),
                      tem_x.reshape(-1, D).to(dtype)])


def am_rope_visual_positions(
    spa_positions: torch.Tensor,   # [t_dam] temporal ids of DAM frames
    tem_positions: torch.Tensor,   # [t_csm] temporal ids of CSM clusters
    spa_grid_hw: Tuple[int, int],  # (h, w) full-res grid (pre merge)
    tem_grid_hw: Tuple[int, int],  # (h, w) pooled grid
) -> torch.Tensor:
    """3D rope positions [3, n_visual] int32 (t, h, w) for the [DAM | CSM]
    visual block, relative to its start: DAM tokens keep their frame index
    on t, CSM tokens their cluster timestamp offset by the DAM token count."""
    def mm_index(t_positions, h, w):
        gh, gw = h // 2, w // 2
        n = t_positions.shape[0]
        dev = t_positions.device
        t_idx = torch.repeat_interleave(t_positions.long(), gh * gw)
        h_idx = torch.arange(gh, device=dev).repeat_interleave(gw).repeat(n)
        w_idx = torch.arange(gw, device=dev).repeat(n * gh)
        return torch.stack([t_idx, h_idx, w_idx]).to(torch.int32)

    spa_ids = mm_index(spa_positions, *spa_grid_hw)
    tem_ids = mm_index(tem_positions, *tem_grid_hw) + spa_ids.shape[1]
    return torch.cat([spa_ids, tem_ids], dim=1)


def qwen_rope_positions(input_ids: np.ndarray, visual_span: Tuple[int, int],
                        visual_positions) -> Tuple[np.ndarray, int]:
    """`mm_rope_positions` for one video block at visual_span = (start,
    n_visual) with its AM-RoPE positions [3, n_visual]."""
    start, _ = visual_span
    return mm_rope_positions(input_ids, [(start, visual_positions)])


def mm_rope_positions(input_ids: np.ndarray, spans: list
                      ) -> Tuple[np.ndarray, int]:
    """3D rope positions [3, S] int64 of a prompt with ordered,
    non-overlapping visual blocks spans = [(start, positions [3, n])]
    (AM-RoPE positions for a video, `mm_grid_index` for an image), and
    rope_delta = max + 1 - S. Text counts on from the running index; a
    block is offset by it; the text after a block resumes at max(block) + 1
    past that offset (get_rope_index's rule, for any interleaving)."""
    S = len(input_ids)
    pos = np.zeros((3, S), np.int64)
    cur = 0       # next sequence slot to fill
    st_idx = 0    # next 1D position value for text
    for start, vp in spans:
        vp = np.asarray(vp.cpu() if isinstance(vp, torch.Tensor) else vp)
        n = vp.shape[1]
        text_len = start - cur
        if text_len < 0:
            raise ValueError("spans must be ordered and non-overlapping")
        pos[:, cur:start] = st_idx + np.arange(text_len)
        st_idx += text_len
        pos[:, start:start + n] = vp + st_idx
        if n:
            st_idx += int(vp.max()) + 1
        cur = start + n
    pos[:, cur:] = st_idx + np.arange(S - cur)
    rope_delta = int(pos.max()) + 1 - S if S else 0
    return pos, rope_delta
