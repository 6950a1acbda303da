"""Pairwise distance/similarity primitives written as matmuls.

Port of flash_vstream_tpu/ops/distances.py. The JAX versions accumulate in
f32 from operands in their own dtype (`preferred_element_type`); here the
operands are widened to f32 first, which gives the same exact products and
f32 sums.
"""
from __future__ import annotations

import torch


def sq_euclidean_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance matrix. a: [n, d], b: [m, d] -> [n, m] f32,
    as one `|a|^2 + |b|^2 - 2 a.b^T` expansion."""
    af, bf = a.float(), b.float()
    a2 = (af * af).sum(dim=1)[:, None]
    b2 = (bf * bf).sum(dim=1)[None, :]
    ab = af @ bf.T
    return torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)


def euclidean_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_euclidean_distance(a, b))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    return xf / torch.clamp_min(torch.linalg.vector_norm(xf, dim=dim,
                                                         keepdim=True), eps)


def cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity matrix. a: [n, d], b: [m, d] -> [n, m]."""
    return l2_normalize(a) @ l2_normalize(b).T


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Rowwise cosine similarity of same-shape [..., d] inputs, the
    denominator clamped at eps."""
    a, b = a.float(), b.float()
    dot = (a * b).sum(dim=-1)
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    return dot / torch.clamp_min(na * nb, eps)
