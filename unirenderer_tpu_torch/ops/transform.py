"""Point and vector transforms (counterpart of
`unirenderer_tpu/ops/transform.py`): one batched matrix product each."""

from __future__ import annotations

import torch


def xfm_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Transform points by homogeneous 4x4 matrices.

    points (B, N, 3); matrix (B, 4, 4), row-vector convention
    (p' = p @ M^T).  Returns (B, N, 4)."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    p = torch.cat([points, ones], dim=-1)
    return torch.matmul(p, matrix.transpose(-1, -2))


def xfm_vectors(vectors: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Transform direction vectors (w = 0).  vectors (B, N, 3), matrix
    (B, 4, 4); returns (B, N, 3)."""
    return torch.matmul(vectors, matrix[:, :3, :3].transpose(-1, -2))
