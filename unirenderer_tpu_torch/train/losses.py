"""Training losses (counterpart of `unirenderer_tpu/train/losses.py`), the
same terms, group slices and weights, in f32:

    forward-rendering step: mse_img + 10 mse_attr + 0.01 contrastive
    inverse-rendering step: mse_img + mse_attr + 0.8 mse_cycle

The contrastive term pulls the albedo predictions of samples 0 and 1
together and pushes material and specular apart (temperature 0.1); it
needs a batch of 2 or more and is 0 below that.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from unirenderer_tpu_torch.core.config import LATENT_CHANNELS, TrainConfig


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.reshape(-1).float()
    b = b.reshape(-1).float()
    na = torch.clamp(torch.linalg.vector_norm(a), min=1e-8)
    nb = torch.clamp(torch.linalg.vector_norm(b), min=1e-8)
    return torch.dot(a, b) / (na * nb)


def contrastive_loss(attr_pred: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """attr_pred: (B, h, w, 24), the prediction after the mask group is
    dropped; groups material [:4], albedo [8:12], spec [12:16]."""
    c = LATENT_CHANNELS
    material = attr_pred[..., 0 * c:1 * c]
    albedo = attr_pred[..., 2 * c:3 * c]
    spec = attr_pred[..., 3 * c:4 * c]
    m = _cos(material[0], material[1]) / temperature
    a = _cos(albedo[0], albedo[1]) / temperature
    s = _cos(spec[0], spec[1]) / temperature
    pos = torch.exp(a)
    neg = pos + torch.exp(m) + torch.exp(s)
    return -torch.log(pos / neg)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def dual_stream_loss(img_pred: torch.Tensor, attr_pred: torch.Tensor,
                     img_target: torch.Tensor, attr_target: torch.Tensor,
                     cycle_img_pred: torch.Tensor, is_inverse: bool,
                     cfg: TrainConfig, contrastive_scale: float = 1.0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, metrics).  Targets are the clean latents; `cycle_img_pred`
    is the cycle pass's prediction on inverse steps (zeros on forward
    steps, as the JAX step reports it).  Both branches' terms are in the
    metrics; the loss is the branch's.  `contrastive_scale` weighs the
    contrastive term (a data-parallel rank's share of the global batch's
    term: `parallel/mesh.ParamSharding.contrastive_scale`)."""
    loss_img = mse(img_pred, img_target)
    loss_attr = mse(attr_pred, attr_target)
    contr = (contrastive_loss(attr_pred, cfg.contrastive_temperature)
             if img_pred.shape[0] >= 2
             else torch.zeros((), device=img_pred.device))
    if contrastive_scale != 1.0:
        contr = contr * contrastive_scale
    loss_cycle = mse(cycle_img_pred, img_target)
    if is_inverse:
        loss = loss_img + loss_attr + cfg.w_cycle * loss_cycle
    else:
        loss = (cfg.w_img * loss_img + cfg.w_attr * loss_attr
                + cfg.w_contrastive * contr)
    metrics = {
        "loss": loss, "loss_img": loss_img, "loss_attr": loss_attr,
        "loss_contrastive": contr, "loss_cycle": loss_cycle,
        "is_inverse": torch.tensor(float(is_inverse)),
    }
    return loss, metrics
