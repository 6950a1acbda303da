"""Masked, fixed-shape weighted k-means for temporal memory consolidation.

Port of flash_vstream_tpu/ops/kmeans.py: fixed `iters` Lloyd steps
over a [T, D] matrix with a validity mask, matmul distances and one-hot
matmul updates, deterministic empty-cluster repair at the worst-fit points;
the greedy farthest-point init, PCA and the PCA k-means of the Flash
memory's `pca_kmeans_ordered` methods.

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


def greedy_init_centroids(x: torch.Tensor, k: int,
                          valid: torch.Tensor) -> torch.Tensor:
    """Greedy farthest-point init (deterministic): the valid point farthest
    from the valid mean, then k - 1 times the point farthest from every
    centroid chosen so far. [k, D] f32."""
    xf = x.float()
    vf = valid.float()
    mean = (xf * vf[:, None]).sum(0) / torch.clamp_min(vf.sum(), 1.0)
    d0 = ((xf - mean) ** 2).sum(1)
    first = int(torch.argmax(torch.where(valid, d0, float("-inf"))))
    cents = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    cents[0] = xf[first]
    mind = torch.where(valid, ((xf - xf[first]) ** 2).sum(1), float("-inf"))
    for i in range(1, k):
        nxt = int(torch.argmax(mind))
        cents[i] = xf[nxt]
        d = ((xf - xf[nxt]) ** 2).sum(1)
        mind = torch.minimum(mind, torch.where(valid, d, float("-inf")))
    return cents


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


def pca_project(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows of x [N, D] projected onto their `dim` largest principal
    components (the reference's pca_torch takes the smallest; JAX takes the
    largest, and so does this). An eigenvector's sign is the solver's
    choice, so the coordinates may differ from JAX's in sign per
    component."""
    xf = x.float()
    xc = xf - xf.mean(dim=0, keepdim=True)
    cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
    _, vecs = torch.linalg.eigh(cov)          # ascending eigenvalues
    return xc @ vecs[:, -dim:]


def pca_weighted_kmeans_ordered(
    x: torch.Tensor,
    k: int,
    pca_dim: int,
    *,
    weights: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    init_scores: Optional[torch.Tensor] = None,
    iters: int = 10,
    tokens_per_frame: int = 1,
) -> KMeansResult:
    """Ordered k-means in a PCA-reduced space: rows [T, P * D] project per
    token ([T * P, D] -> [T * P, pca_dim]), cluster as [T, P * pca_dim]
    (init from `init_scores` [T]), and the centroids returned are the
    unweighted means of the original rows of each cluster."""
    T, PD = x.shape
    P = tokens_per_frame
    x_red = pca_project(x.reshape(T * P, PD // P), pca_dim).reshape(
        T, P * pca_dim)
    res = weighted_kmeans_ordered(x_red, k, weights=weights, valid=valid,
                                  init_scores=init_scores, iters=iters)
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=x.device)
    onehot = _onehot(res.labels.long(), k, valid)
    counts = onehot.sum(dim=0)
    centroids = (onehot.T @ x.float()) / torch.clamp_min(counts, 1.0)[:, None]
    return KMeansResult(centroids, res.labels, res.cluster_weights,
                        res.timestamps)
