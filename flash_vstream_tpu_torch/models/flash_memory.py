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
- `n_frames` is a host int: the session knows how many frames it fed;
- the k-means init takes its uniform draws (`init_scores`) from the caller
  where JAX takes a PRNG key (torch cannot reproduce jax.random).

Temporal methods: the k-means family (every name the JAX path sends to
ordered k-means). 'sample', 'merge', 'drop', 'attention' and the PCA,
dbscan and gmm methods raise NotImplementedError (ROADMAP A14). Spatial
methods: klarge_retrieve(_cos), sample, nearest.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import FlashMemoryConfig

from ..kernels.gather_rows import gather_rows
from ..ops.kmeans import weighted_kmeans
from ..ops.retrieval import dam_retrieve

INT32_MAX = 2 ** 31 - 1
UNPORTED_TEMPORAL = ("sample", "merge", "drop", "attention")
KMEANS_TEMPORAL = ("kmeans_ordered", "fast_kmeans_ordered", "kmeans")


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


def flash_stream_update(
    cfg: FlashMemoryConfig,
    state: FlashState,
    new_x: torch.Tensor,         # [T_new, P_full, D]
    new_small: torch.Tensor,     # [T_new, P_small, D]
    n_new: int,                  # valid leading rows of new_x / new_small
    init_scores: torch.Tensor,   # [K + T_new] uniform draws for k-means init
) -> Tuple[FlashState, FlashMemoryOutput]:
    """Fold a clip into the streaming memory and produce the current
    [DAM | CSM] snapshot. The banks of `state` are written in place."""
    if cfg.temporal_method in UNPORTED_TEMPORAL:
        raise NotImplementedError(
            f"temporal_method {cfg.temporal_method!r} is not ported yet: "
            f"ROADMAP A14")
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
    cents, cw, cts = _ordered_kmeans_with_times(flat, K, cat_w, cat_t,
                                                cat_valid, init_scores)
    slot = torch.arange(K, device=dev)
    is_short = n_cat <= K
    order = torch.argsort(torch.where(cat_valid, cat_t, float("inf")),
                          stable=True)[:K]
    packed, packed_w, packed_t = cat_x[order], cat_w[order], cat_t[order]
    in_prefix = slot < n_cat
    tem_x = torch.where(is_short,
                        torch.where(in_prefix[:, None, None], packed, 0.0),
                        cents.reshape(K, P_small, D))
    tem_weights = torch.where(is_short, torch.where(in_prefix, packed_w, 0.0),
                              cw)
    tem_times = torch.where(is_short, torch.where(in_prefix, packed_t, 0.0),
                            cts)
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
    spa_x = gather_rows(bank, idx)
    out = FlashMemoryOutput(
        spa_x=spa_x,
        spa_positions=bank_pos[idx.long()],
        tem_x=tem_x,
        tem_weights=tem_weights,
        tem_positions=torch.round(tem_times).to(torch.int32),
    )
    return new_state, out


def flash_consolidate(
    cfg: FlashMemoryConfig,
    x: torch.Tensor,             # [t, P_full, D] full-res per-frame features
    small_x: torch.Tensor,       # [t, P_small, D] pooled per-frame features
    *,
    init_scores: Optional[torch.Tensor] = None,   # [t] k-means init draws
    times: Optional[torch.Tensor] = None,
) -> FlashMemoryOutput:
    """Offline consolidation of a whole video (FlashMemory.forward's
    per-sample pipeline). CSM: the t pooled frames themselves when
    t <= csm_grid_len, else ordered k-means into csm_grid_len clusters (its
    init drawn from `init_scores`, the uniform draws JAX takes from its key).
    DAM: every frame when t <= dam_grid_len, else the spatial method's
    dam_grid_len frames."""
    t, P_full, D = x.shape
    P_small = small_x.shape[1]
    dev = x.device
    t_csm = min(t, cfg.csm_grid_len)
    t_dam = min(t, cfg.dam_grid_len)
    if times is None:
        times = torch.arange(t, dtype=torch.float32, device=dev)

    # --- CSM: temporal compression ---
    if t <= cfg.csm_grid_len:
        tem_x = small_x
        tem_weights = torch.ones(t, dtype=torch.float32, device=dev)
        tem_ts = times
    elif cfg.temporal_method in KMEANS_TEMPORAL:
        if init_scores is None:
            raise ValueError("k-means consolidation needs `init_scores`")
        cents, tem_weights, tem_ts = _ordered_kmeans_with_times(
            small_x.reshape(t, P_small * D), t_csm,
            torch.ones(t, dtype=torch.float32, device=dev), times,
            torch.ones(t, dtype=torch.bool, device=dev), init_scores)
        tem_x = cents.reshape(t_csm, P_small, D)
    else:
        raise NotImplementedError(
            f"temporal_method {cfg.temporal_method!r} is not ported yet: "
            f"ROADMAP A14")
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
