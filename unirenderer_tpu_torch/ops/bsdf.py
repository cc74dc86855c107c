"""Shading-normal helpers of the split-sum renderer (counterpart of the
parts of `unirenderer_tpu/ops/bsdf.py` that `render_mesh` reaches).
Elementwise torch over (..., 3) tensors.  The BSDF evaluation functions
come with the training slice."""

from __future__ import annotations

import torch

NORMAL_THRESHOLD = 0.1


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1, keepdim=True)


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return 2.0 * dot(x, n) * n - x


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True),
                                       min=eps))


def length(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.sqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True),
                                  min=eps))


def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading: bool):
    if two_sided_shading:
        flip = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(flip, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(flip, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl: bool):
    smooth_bitang = safe_normalize(torch.cross(smooth_tng, smooth_nrm,
                                               dim=-1))
    sign = -1.0 if opengl else 1.0
    shading_nrm = (smooth_tng * perturbed_nrm[..., 0:1]
                   + sign * smooth_bitang * perturbed_nrm[..., 1:2]
                   + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3],
                                              min=0.0))
    return safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm,
                           smooth_tng, geom_nrm, two_sided_shading=True,
                           opengl=True) -> torch.Tensor:
    """Bent shading normal.  `perturbed_nrm` may be None."""
    smooth_nrm = safe_normalize(smooth_nrm)
    view_vec = safe_normalize(view_pos - pos)
    if perturbed_nrm is None:
        shading_nrm = smooth_nrm
    else:
        smooth_tng = safe_normalize(smooth_tng)
        shading_nrm = _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng,
                                      opengl)
    return _bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)
