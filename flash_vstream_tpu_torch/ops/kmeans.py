"""Masked, fixed-shape weighted k-means for temporal memory consolidation.

Port of flash_vstream_tpu/ops/kmeans.py:40-214: fixed `iters` Lloyd steps
over a [T, D] matrix with a validity mask, matmul distances and one-hot
matmul updates, deterministic empty-cluster repair at the worst-fit points.

One difference of interface: the JAX init draws `jax.random.uniform(key)`,
which torch cannot reproduce. Here the caller passes those uniform draws
(`init_scores`, [T]) or the initial centroids (`init`); nothing in this
module touches a global RNG. Every sort is stable, as `jnp.argsort` is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .distances import sq_euclidean_distance


class KMeansResult(NamedTuple):
    centroids: torch.Tensor        # [k, D] f32
    labels: torch.Tensor           # [T] int32 (0 at invalid rows)
    cluster_weights: torch.Tensor  # [k] total assigned weight per cluster
    timestamps: torch.Tensor       # [k] mean assigned position


def _onehot(labels: torch.Tensor, k: int, valid: torch.Tensor) -> torch.Tensor:
    ar = torch.arange(k, device=labels.device)
    return (labels[:, None] == ar[None, :]).float() * valid[:, None].float()


def _assign(x, centroids, valid):
    """Labels for valid rows (0 at invalid rows) and each row's distance to
    its centroid (-inf at invalid rows). The centroids take x's dtype first,
    as in JAX."""
    d = sq_euclidean_distance(x, centroids.to(x.dtype))            # [T, k]
    min_d, labels = d.min(dim=1)
    labels = torch.where(valid, labels.to(torch.int32), 0)
    return labels, torch.where(valid, min_d, float("-inf"))


def _update(x, weights, valid, labels, k, old_centroids):
    onehot = _onehot(labels, k, valid)                             # [T, k]
    w = (weights * valid).float()
    # the weight scaling sits on the small [k, T] factor, rounded once to
    # x's dtype, as in JAX
    wo = (onehot * w[:, None]).T                                   # [k, T]
    weighted_sum = wo.to(x.dtype).float() @ x.float()              # [k, D]
    cluster_w = (onehot.T @ w[:, None])[:, 0]                      # [k]
    nonempty = cluster_w > 0
    centroids = torch.where(
        nonempty[:, None],
        weighted_sum / torch.clamp_min(cluster_w, 1e-30)[:, None],
        old_centroids)
    return centroids, cluster_w, nonempty


def _repair_empty(x, valid, labels, min_d, centroids, nonempty, k):
    """Reseed empty clusters at the currently worst-fit valid points: the
    j-th empty cluster (in cluster order) takes the j-th worst point."""
    order = torch.argsort(-min_d, stable=True)                     # [T]
    empty_rank = torch.cumsum((~nonempty).long(), dim=0) - 1        # [k]
    seed_idx = order[torch.clamp(empty_rank, 0, x.shape[0] - 1)]
    seeds = x[seed_idx].float()
    return torch.where(nonempty[:, None], centroids, seeds)


def init_centroids(x: torch.Tensor, k: int, valid: torch.Tensor,
                   scores: torch.Tensor) -> torch.Tensor:
    """Pick k valid rows as initial centroids: the rows with the k smallest
    uniform `scores` [T] (invalid rows pushed last), as the JAX seeded
    permutation does with its own uniform draws."""
    s = scores.float() + (~valid).float() * 10.0
    idx = torch.argsort(s, stable=True)[:k]
    return x[idx].float()


def weighted_kmeans(
    x: torch.Tensor,
    k: int,
    *,
    weights: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    init: Optional[torch.Tensor] = None,
    init_scores: Optional[torch.Tensor] = None,
    iters: int = 10,
) -> KMeansResult:
    """Weighted Lloyd k-means over x [T, D] (rows beyond `valid` ignored).
    Give either the initial centroids `init` or the uniform draws
    `init_scores` [T] that pick them."""
    T = x.shape[0]
    dev = x.device
    if weights is None:
        weights = torch.ones(T, device=dev)
    weights = weights.float()
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=dev)
    if init is None:
        if init_scores is None:
            raise ValueError("weighted_kmeans needs `init` or `init_scores`")
        init = init_centroids(x, k, valid, init_scores)
    centroids = init.float()

    # x stays in its own dtype; centroids and statistics accumulate in f32
    for _ in range(iters):
        labels, min_d = _assign(x, centroids, valid)
        new_c, _, nonempty = _update(x, weights, valid, labels, k, centroids)
        centroids = _repair_empty(x, valid, labels, min_d, new_c, nonempty, k)

    # final consistent assignment (labels/stats match the returned centroids)
    labels, _ = _assign(x, centroids, valid)
    onehot = _onehot(labels, k, valid)
    w = weights * valid
    cluster_w = (onehot.T @ w[:, None])[:, 0]
    # mean assigned local position per cluster (empty -> T, sorts last)
    pos = torch.arange(T, dtype=torch.float32, device=dev)
    counts = onehot.sum(dim=0)
    pos_sum = (onehot.T @ pos[:, None])[:, 0]
    timestamps = torch.where(counts > 0, pos_sum / torch.clamp_min(counts, 1.0),
                             float(T))
    return KMeansResult(centroids, labels, cluster_w, timestamps)


def weighted_kmeans_ordered(
    x: torch.Tensor,
    k: int,
    *,
    weights: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    init: Optional[torch.Tensor] = None,
    init_scores: Optional[torch.Tensor] = None,
    iters: int = 10,
) -> KMeansResult:
    """K-means whose clusters are re-sorted by mean assigned position."""
    res = weighted_kmeans(x, k, weights=weights, valid=valid, init=init,
                          init_scores=init_scores, iters=iters)
    order = torch.argsort(res.timestamps, stable=True)
    inv = torch.argsort(order, stable=True)    # old cluster id -> new slot
    return KMeansResult(
        centroids=res.centroids[order],
        labels=inv[res.labels.long()].to(torch.int32),
        cluster_weights=res.cluster_weights[order],
        timestamps=res.timestamps[order],
    )
