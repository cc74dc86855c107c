"""DDPM noise schedule, x0-prediction variant (counterpart of
`unirenderer_tpu/diffusion/schedule.py`): scaled-linear SD betas, f32,
computed as the JAX package does (linspace of sqrt(beta), squared,
cumulative product)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unirenderer_tpu_torch.core.config import DiffusionConfig


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """cumprod(1 - beta_t), length num_train_timesteps."""
    alphas_cumprod: torch.Tensor

    @classmethod
    def create(cls, cfg: DiffusionConfig, device="cpu") -> "DiffusionSchedule":
        betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                               cfg.num_train_timesteps,
                               dtype=torch.float32) ** 2
        return cls(alphas_cumprod=torch.cumprod(1.0 - betas, dim=0).to(device))

    def alpha_sigma(self, t: torch.Tensor):
        """(sqrt(acp_t), sqrt(1-acp_t)) for integer timesteps t (a tensor of
        any shape; `take` keeps a 0-dim index on the device, where indexing
        with it would copy it to the host)."""
        acp = torch.take(self.alphas_cumprod, t)
        return torch.sqrt(acp), torch.sqrt(1.0 - acp)


def inference_timesteps(num_train_timesteps: int, num_steps: int) -> np.ndarray:
    """Descending inference grid, diffusers 'linspace' spacing:
    linspace(0, T-1, N+1).round() reversed, dropping the trailing 0."""
    ts = np.linspace(0, num_train_timesteps - 1, num_steps + 1).round()
    return ts[::-1][:-1].astype(np.int64).copy()
