"""DBSCAN and GMM temporal compression, fixed-shape.

Port of flash_vstream_tpu/ops/clustering_extra.py (the reference's
dbscan_feature / gmm_feature, Flash-VStream-Qwen/models/
compress_functions.py:671-719, which call sklearn on the host):

- DBSCAN: one [T, T] distance matrix; core points by neighbour count;
  connected components by min-label propagation over the core-reachability
  graph, a loop that stops when no label changes (JAX's lax.while_loop);
  noise points become singleton clusters after the real ones, up to k.
- GMM: PCA projection, then diagonal-covariance EM for a fixed number of
  iterations from a k-means of greedy farthest-point seeds.

Both return k slots with a validity mask, the centroids the means of each
slot's original rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .distances import sq_euclidean_distance
from .kmeans import greedy_init_centroids, pca_project, weighted_kmeans


class ClusterResult(NamedTuple):
    centroids: torch.Tensor   # [k, D] cluster means of the original rows
    valid: torch.Tensor       # [k] bool
    labels: torch.Tensor      # [T] int32 slot per point (-1 = dropped)


def _slot_means(x: torch.Tensor, labels: torch.Tensor, k: int):
    onehot = (labels.long()[:, None]
              == torch.arange(k, device=x.device)[None, :]).float()
    counts = onehot.sum(dim=0)
    return (onehot.T @ x.float()) / torch.clamp_min(counts, 1.0)[:, None], \
        counts


def dbscan_compress(x: torch.Tensor, k: int, *, eps: float = 0.62,
                    min_samples: int = 2,
                    valid: Optional[torch.Tensor] = None) -> ClusterResult:
    """DBSCAN of the rows of x [T, D] into at most k slots: the clusters by
    their lowest point index, then the noise points, one slot each."""
    T = x.shape[0]
    dev = x.device
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=dev)
    d2 = sq_euclidean_distance(x, x)
    adj = (d2 <= eps * eps) & valid[None, :] & valid[:, None]
    core = (adj.sum(dim=1) >= min_samples) & valid
    # points connect through core points only
    edges = adj & (core[:, None] | core[None, :])
    ar = torch.arange(T, device=dev)
    labels = torch.where(valid, ar, T)
    while True:
        nbr_min = torch.where(edges, labels[None, :], T).min(dim=1).values
        new = torch.minimum(labels, nbr_min)
        if torch.equal(new, labels):
            break
        labels = new
    is_clustered = core | (edges.sum(dim=1) > 1) & valid
    root = torch.where(is_clustered & valid, labels, T + ar)
    is_root = (root == ar) & valid & is_clustered
    noise = valid & ~is_clustered
    root_rank = torch.cumsum(is_root.long(), 0) - 1
    n_clusters = is_root.sum()
    noise_rank = torch.cumsum(noise.long(), 0) - 1 + n_clusters
    slot_of_point = torch.where(is_root, root_rank,
                                torch.where(noise, noise_rank, -1))
    slot = torch.where(noise, slot_of_point,
                       slot_of_point[torch.clamp(root, 0, T - 1)])
    slot = torch.where(valid & (slot < k) & (slot >= 0), slot, -1)
    centroids, counts = _slot_means(x, slot, k)
    return ClusterResult(centroids, counts > 0, slot.to(torch.int32))


def _log_lik(z, mu, var):
    """log N(z | mu, diag var) [T, k]."""
    lognorm = -0.5 * torch.log(2 * math.pi * var).sum(dim=1)
    diff2 = (z[:, None, :] - mu[None, :, :]) ** 2 / var[None, :, :]
    return lognorm[None, :] - 0.5 * diff2.sum(dim=2)


def gmm_compress(x: torch.Tensor, k: int, *, pca_dim: int = 32,
                 iters: int = 20,
                 valid: Optional[torch.Tensor] = None) -> ClusterResult:
    """A diagonal-covariance GMM of the rows of x [T, D] in their
    min(pca_dim, D, T) principal components; the slots are the hard
    assignments, their centroids the means of the original rows. The init
    is deterministic (greedy seeds), so it takes no draws."""
    T, D = x.shape
    dev = x.device
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=dev)
    z = pca_project(x, min(pca_dim, D, T))
    km = weighted_kmeans(z, k, valid=valid,
                         init=greedy_init_centroids(z, k, valid), iters=15)
    mu = km.centroids
    var = torch.ones_like(mu)
    pi = torch.full((k,), 1.0 / k, device=dev)
    vmask = valid.float()
    for _ in range(iters):
        logp = _log_lik(z, mu, var) + torch.log(torch.clamp_min(pi, 1e-12))
        r = torch.softmax(logp, dim=1) * vmask[:, None]
        nk = r.sum(dim=0) + 1e-6
        mu = (r.T @ z) / nk[:, None]
        var = (r.T @ (z * z)) / nk[:, None] - mu ** 2 + 1e-6
        pi = nk / nk.sum()
    # the hard assignment (the reference's gmm.predict)
    labels = torch.argmax(
        _log_lik(z, mu, var) + torch.log(torch.clamp_min(pi, 1e-12)), dim=1)
    labels = torch.where(valid, labels, -1)
    centroids, counts = _slot_means(x, labels, k)
    return ClusterResult(centroids, counts > 0, labels.to(torch.int32))
