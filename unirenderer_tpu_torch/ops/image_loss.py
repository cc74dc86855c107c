"""Tonemapped image losses (counterpart of
`unirenderer_tpu/ops/image_loss.py`): tonemap "none" or "log_srgb", loss
"l1", "mse", "smape" or "relmse", the mean over every element.  Plain
torch; autograd gives the backward."""

from __future__ import annotations

import torch


def _srgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(f > 0.0031308,
                       1.055 * torch.pow(torch.clamp(f, min=0.0031308),
                                         1.0 / 2.4) - 0.055,
                       12.92 * f)


def _tonemap(img: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "none":
        return img
    if mode == "log_srgb":
        return _srgb(torch.log(torch.clamp(img, 0.0, 65535.0) + 1.0))
    raise ValueError(mode)


def image_loss(img: torch.Tensor, target: torch.Tensor, loss: str = "l1",
               tonemap: str = "none") -> torch.Tensor:
    """The mean loss between the tonemapped images."""
    img_t = _tonemap(img, tonemap)
    ref_t = _tonemap(target, tonemap)
    err = img_t - ref_t
    if loss == "l1":
        return torch.mean(torch.abs(err))
    if loss == "mse":
        return torch.mean(err * err)
    if loss == "smape":
        denom = torch.abs(img_t) + torch.abs(ref_t) + 0.01
        return torch.mean(2.0 * torch.abs(err) / denom)
    if loss == "relmse":
        denom = img_t * img_t + ref_t * ref_t + 0.01
        return torch.mean(err * err / denom)
    raise ValueError(loss)
