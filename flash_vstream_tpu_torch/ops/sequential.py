"""Sequential frame-compression ops (drop / merge / k-drop / k-merge).

Port of flash_vstream_tpu/ops/sequential.py, the reference's drop_feature,
merge_feature, k_drop_feature and k_merge_feature
(Flash-VStream-LLaVA/flash_vstream/model/compress_functions.py:20-260),
with the `_timed` forms that also track each slot's member weight and
mean timestamp, and `sample_frames`.

Each incoming frame mutates a buffer of t0 kept frames. JAX scans every
frame up to a static Tmax with a per-step valid flag; here a host loop
runs the valid steps only (`n_valid` is a host int), which leaves the
same state: an invalid JAX step passes its state through unchanged. The
arithmetic is JAX's, op for op, in f32.

The coin flips of the drop ops are an argument (`coins`, [Tmax - t0]
bool): JAX draws them with `jax.random.bernoulli(key, 0.5, ...)`, which
is `jax.random.uniform(key, ...) < 0.5`; torch cannot reproduce
jax.random, so the caller draws them (the tests hand in JAX's).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .distances import cosine_similarity, l2_normalize

_NEG = -100.0


class SeqCompressResult(NamedTuple):
    features: torch.Tensor   # [t0, D] f32
    valid: torch.Tensor      # [t0] bool
    aux: torch.Tensor        # neighbour sims [t0] or sim matrix [t0, t0]


class TimedSeqResult(NamedTuple):
    """A sequential compression that also tracks, per slot, the weight of
    the frames folded into it and their weighted mean timestamp (the Qwen
    temporal_compress registry's (weights, timestamps); JAX
    sequential.py:226-240 documents the semantics as its own)."""
    features: torch.Tensor   # [t0, D] f32
    valid: torch.Tensor      # [t0] bool
    weights: torch.Tensor    # [t0] f32 member weight per slot
    times: torch.Tensor      # [t0] f32 weighted mean member timestamp


def _delete_shift(buf: torch.Tensor, idx: int, out_len: int) -> torch.Tensor:
    """Row `idx` removed from buf ([N, ...]): its first out_len rows."""
    return torch.cat([buf[:idx], buf[idx + 1:]])[:out_len]


def _delete_rowcol(mat: torch.Tensor, idx: int, out_len: int) -> torch.Tensor:
    keep = [i for i in range(mat.shape[0]) if i != idx][:out_len]
    keep = torch.tensor(keep, device=mat.device)
    return mat[keep][:, keep]


def _neighbor_sims(x: torch.Tensor) -> torch.Tensor:
    """sim[i] = cos(x[i], x[i+1]); the last entry is padding."""
    s = cosine_similarity(x[:-1], x[1:])
    return torch.cat([s, s.new_full((1,), _NEG)])


def _valid(n_valid: int, t0: int, device) -> torch.Tensor:
    return torch.arange(t0, device=device) < min(n_valid, t0)


def _initial_sims(feat0: torch.Tensor, n_valid: int, t0: int) -> torch.Tensor:
    i = torch.arange(t0, device=feat0.device)
    return torch.where(i < min(n_valid, t0) - 1, _neighbor_sims(feat0), _NEG)


def _adjacent_step(feat, sim, new, t0):
    """The incoming frame appended to the neighbour chain: (sims [t0] with
    the last pair's, the extended features [t0 + 1, D])."""
    asim = sim.clone()
    asim[t0 - 1] = cosine_similarity(feat[t0 - 1], new)
    return asim, torch.cat([feat, new[None].float()])


def _shift_sims(asim, idx, t0):
    """The sims after deleting pair slot `idx`, the last one padding."""
    j = torch.arange(t0, device=asim.device)
    nsim = asim[torch.clamp_max(j + (j >= idx).long(), t0 - 1)]
    nsim[t0 - 1] = _NEG
    return nsim


def _patch(nsim, nfeat, k, t0):
    """Recompute sim k (if 0 <= k < t0 - 1) from the merged chain."""
    if 0 <= k < t0 - 1:
        nsim[k] = cosine_similarity(nfeat[k], nfeat[k + 1])


def merge_frames(x: torch.Tensor, n_valid: int, t0: int) -> SeqCompressResult:
    """Neighbour-merge compression of x [Tmax, D] (frames flattened over
    patches, the first n_valid valid) to at most t0 frames: the most
    similar adjacent pair is averaged, one incoming frame at a time."""
    x = x.float()
    Tmax = x.shape[0]
    if Tmax < t0:
        raise ValueError(f"merge_frames needs Tmax >= t0, got {Tmax} < {t0}")
    feat = x[:t0]
    sim = _initial_sims(feat, n_valid, t0)
    for t in range(t0, min(n_valid, Tmax)):
        asim, af = _adjacent_step(feat, sim, x[t], t0)
        idx = int(asim.argmax())
        af[idx + 1] = (af[idx] + af[idx + 1]) / 2.0
        feat = _delete_shift(af, idx, t0)
        sim = _shift_sims(asim, idx, t0)
        _patch(sim, feat, idx - 1, t0)   # reference: if idx > 0
        _patch(sim, feat, idx, t0)       # reference: if idx + 1 < T0
    return SeqCompressResult(feat, _valid(n_valid, t0, x.device), sim)


def _drop_patch(nsim, nfeat, idx, t0):
    """After dropping an interior frame, the joined pair's sim (JAX clips
    its indices; only 0 < idx < t0 writes)."""
    if 0 < idx < t0:
        k = idx - 1
        nsim[k] = cosine_similarity(nfeat[min(k, t0 - 2)],
                                    nfeat[min(k + 1, t0 - 1)])


def drop_frames(x: torch.Tensor, n_valid: int, t0: int,
                coins: torch.Tensor) -> SeqCompressResult:
    """Similarity-drop compression to at most t0 frames: one frame of the
    most similar adjacent pair is dropped, the later one where the step's
    coin (`coins` [Tmax - t0] bool) is set."""
    x = x.float()
    Tmax = x.shape[0]
    feat = x[:t0]
    sim = _initial_sims(feat, n_valid, t0)
    for t in range(t0, min(n_valid, Tmax)):
        asim, af = _adjacent_step(feat, sim, x[t], t0)
        idx = int(asim.argmax()) + int(coins[t - t0])     # may equal t0
        feat = _delete_shift(af, idx, t0)
        sim = _shift_sims(asim, idx, t0)
        _drop_patch(sim, feat, idx, t0)
    return SeqCompressResult(feat, _valid(n_valid, t0, x.device), sim)


def _full_sim_matrix(nf: torch.Tensor) -> torch.Tensor:
    s = nf @ nf.T
    eye = torch.eye(nf.shape[0], dtype=torch.bool, device=nf.device)
    return torch.where(eye, _NEG, s)


def _k_init(x, n_valid, t0):
    feat0 = x[:t0]
    nf0 = l2_normalize(feat0)
    live = _valid(n_valid, t0, x.device)
    sim0 = torch.where(live[:, None] & live[None, :], _full_sim_matrix(nf0),
                       _NEG)
    return feat0, nf0, sim0


def _k_step_common(feat, nf, sim, new, t0):
    """The buffers extended with the incoming frame, and the globally most
    similar pair (left, right) of the extended sim matrix."""
    nnew = l2_normalize(new[None])                          # [1, D]
    new_sim = nf @ nnew.T                                   # [t0, 1]
    af = torch.cat([feat, new[None].float()])
    anf = torch.cat([nf, nnew])
    asim = sim.new_full((t0 + 1, t0 + 1), _NEG)
    asim[:t0, :t0] = sim
    asim[:t0, t0] = new_sim[:, 0]
    asim[t0, :t0] = new_sim[:, 0]
    flat = int(asim.argmax())
    return af, anf, asim, flat // (t0 + 1), flat % (t0 + 1)


def k_drop_frames(x: torch.Tensor, n_valid: int, t0: int,
                  coins: torch.Tensor) -> SeqCompressResult:
    """Global-pair drop compression (k_drop_feature): one member of the
    globally most similar pair is dropped, the left where the step's coin
    is set."""
    x = x.float()
    Tmax = x.shape[0]
    feat, nf, sim = _k_init(x, n_valid, t0)
    for t in range(t0, min(n_valid, Tmax)):
        af, anf, asim, left, right = _k_step_common(feat, nf, sim, x[t], t0)
        idx = left if bool(coins[t - t0]) else right
        feat = _delete_shift(af, idx, t0)
        nf = _delete_shift(anf, idx, t0)
        sim = _delete_rowcol(asim, idx, t0)
    return SeqCompressResult(feat, _valid(n_valid, t0, x.device), sim)


def k_merge_frames(x: torch.Tensor, n_valid: int, t0: int
                   ) -> SeqCompressResult:
    """Global-pair merge compression (k_merge_feature): the globally most
    similar pair is averaged into the `right` slot and the `left` slot
    deleted."""
    x = x.float()
    Tmax = x.shape[0]
    feat, nf, sim = _k_init(x, n_valid, t0)
    for t in range(t0, min(n_valid, Tmax)):
        af, anf, asim, left, right = _k_step_common(feat, nf, sim, x[t], t0)
        merged = (af[left] + af[right]) / 2.0
        af[right] = merged
        anf[right] = l2_normalize(merged[None])[0]
        rs = (anf @ anf[right][:, None])[:, 0]              # [t0 + 1]
        asim[right, :] = rs
        asim[:, right] = rs
        asim[right, right] = _NEG
        feat = _delete_shift(af, left, t0)
        nf = _delete_shift(anf, left, t0)
        sim = _delete_rowcol(asim, left, t0)
    return SeqCompressResult(feat, _valid(n_valid, t0, x.device), sim)


def _provenance(x, times, weights):
    Tmax = x.shape[0]
    if times is None:
        times = torch.arange(Tmax, dtype=torch.float32, device=x.device)
    if weights is None:
        weights = torch.ones(Tmax, dtype=torch.float32, device=x.device)
    return times.float(), weights.float()


def merge_frames_timed(x: torch.Tensor, n_valid: int, t0: int,
                       times: Optional[torch.Tensor] = None,
                       weights: Optional[torch.Tensor] = None
                       ) -> TimedSeqResult:
    """merge_frames with provenance: a slot's weight is the sum of its
    members' weights and its time their weighted mean time. The features
    stay the reference's plain (a + b) / 2 average whatever the weights;
    per-frame weights default to 1 (streaming passes accumulated cluster
    weights)."""
    x = x.float()
    Tmax = x.shape[0]
    if Tmax < t0:
        raise ValueError(f"merge_frames_timed needs Tmax >= t0, got "
                         f"{Tmax} < {t0}")
    times, weights = _provenance(x, times, weights)
    feat = x[:t0]
    sim = _initial_sims(feat, n_valid, t0)
    cnt = weights[:t0]
    tsum = times[:t0] * cnt
    for t in range(t0, min(n_valid, Tmax)):
        asim, af = _adjacent_step(feat, sim, x[t], t0)
        acnt = torch.cat([cnt, weights[t:t + 1]])
        atsum = torch.cat([tsum, (times[t] * weights[t])[None]])
        idx = int(asim.argmax())
        af[idx + 1] = (af[idx] + af[idx + 1]) / 2.0
        acnt[idx + 1] = acnt[idx] + acnt[idx + 1]
        atsum[idx + 1] = atsum[idx] + atsum[idx + 1]
        feat = _delete_shift(af, idx, t0)
        cnt = _delete_shift(acnt, idx, t0)
        tsum = _delete_shift(atsum, idx, t0)
        sim = _shift_sims(asim, idx, t0)
        _patch(sim, feat, idx - 1, t0)
        _patch(sim, feat, idx, t0)
    valid = _valid(n_valid, t0, x.device)
    out_t = torch.where(cnt > 0, tsum / torch.clamp_min(cnt, 1e-30), 0.0)
    return TimedSeqResult(feat, valid, torch.where(valid, cnt, 0.0),
                          torch.where(valid, out_t, 0.0))


def drop_frames_timed(x: torch.Tensor, n_valid: int, t0: int,
                      coins: torch.Tensor,
                      times: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None
                      ) -> TimedSeqResult:
    """drop_frames with provenance: each surviving slot keeps its own
    frame's weight and timestamp (a dropped frame's provenance goes with
    it)."""
    x = x.float()
    Tmax = x.shape[0]
    times, weights = _provenance(x, times, weights)
    feat = x[:t0]
    sim = _initial_sims(feat, n_valid, t0)
    wv, tv = weights[:t0], times[:t0]
    for t in range(t0, min(n_valid, Tmax)):
        asim, af = _adjacent_step(feat, sim, x[t], t0)
        aw = torch.cat([wv, weights[t:t + 1]])
        at = torch.cat([tv, times[t:t + 1]])
        idx = int(asim.argmax()) + int(coins[t - t0])
        feat = _delete_shift(af, idx, t0)
        wv = _delete_shift(aw, idx, t0)
        tv = _delete_shift(at, idx, t0)
        sim = _shift_sims(asim, idx, t0)
        _drop_patch(sim, feat, idx, t0)
    valid = _valid(n_valid, t0, x.device)
    return TimedSeqResult(feat, valid, torch.where(valid, wv, 0.0),
                          torch.where(valid, tv, 0.0))


def sample_frames(x: torch.Tensor, n_valid: int, t0: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform temporal sampling (the Qwen 'sample' method,
    vstream_qwen2vl_model.py:161): linspace(0, t-1, t0) rounded down, in
    f32 as JAX computes it. Returns (x at those frames, the indices)."""
    t = max(n_valid, 1)
    dev = x.device
    # jnp.linspace(0, 1, t0): iota / (t0 - 1) in f32, the end point exact
    if t0 > 1:
        lin = torch.cat([torch.arange(t0 - 1, dtype=torch.float32, device=dev)
                         / torch.tensor(float(t0 - 1), device=dev),
                         torch.ones(1, device=dev)])
    else:
        lin = torch.zeros(t0, device=dev)
    idx = (lin * torch.tensor(float(t - 1), device=dev)).to(torch.int32)
    return x[idx.long()], idx
