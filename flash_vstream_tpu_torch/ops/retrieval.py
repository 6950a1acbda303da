"""Key-frame retrieval for the Flash DAM memory.

Port of flash_vstream_tpu/ops/retrieval.py:26-87: the spatial_length
heaviest CSM clusters query the pooled frame bank, and each picks its
nearest valid frame.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .distances import cosine_similarity_matrix, sq_euclidean_distance


def topk_by_weight(weights: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest weights, in descending-weight order (stable
    among ties, as `jnp.argsort(-w)`)."""
    return torch.argsort(-weights, stable=True)[:k]


def retrieve_nearest_frames(
    centroids: torch.Tensor,     # [k, Dq] queries
    bank: torch.Tensor,          # [T, Dq] pooled per-frame features
    bank_valid: torch.Tensor,    # [T] bool
    metric: str = "euclidean",
) -> torch.Tensor:
    """For each centroid, the index of the nearest valid bank frame. [k]
    int32. The cosine metric keeps the reference's argmin over similarity
    (the least similar frame), as the JAX version does for parity."""
    if metric == "euclidean":
        d = sq_euclidean_distance(centroids, bank)
        d = torch.where(bank_valid[None, :], d, float("inf"))
    elif metric == "cosine":
        d = cosine_similarity_matrix(centroids, bank)
        d = torch.where(bank_valid[None, :], d, float("-inf"))
    else:
        raise ValueError(f"unknown metric {metric}")
    return torch.argmin(d, dim=1).to(torch.int32)


def dam_retrieve(
    tem_x: torch.Tensor,         # [K, P, D] CSM cluster features
    tem_weights: torch.Tensor,   # [K]
    small_bank: torch.Tensor,    # [T, P, D] pooled feature bank
    bank_valid: torch.Tensor,    # [T]
    spatial_length: int,
    metric: str = "euclidean",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash DAM retrieval (klarge_retrieve): (frame indices
    [spatial_length] int32, the clusters that queried them)."""
    K, P, D = tem_x.shape
    top = topk_by_weight(tem_weights, spatial_length)
    queries = tem_x[top].reshape(spatial_length, P * D)
    bank2d = small_bank.reshape(small_bank.shape[0], -1)
    idx = retrieve_nearest_frames(queries, bank2d, bank_valid, metric)
    return idx, top
