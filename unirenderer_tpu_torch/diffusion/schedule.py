"""DDPM noise schedule, x0-prediction variant (counterpart of
`unirenderer_tpu/diffusion/schedule.py`): scaled-linear SD betas, f32,
computed as the JAX package does (linspace of sqrt(beta), squared,
cumulative product), and the training step's dual-schedule timestep draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

    @property
    def num_train_timesteps(self) -> int:
        return self.alphas_cumprod.shape[0]

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(acp_t) x0 + sqrt(1 - acp_t) noise, t (B,)
        broadcast over the batch."""
        a, s = self.alpha_sigma(t)
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return a.reshape(shape) * x0 + s.reshape(shape) * noise


def compute_dual_t(generator: torch.Generator, num_timesteps: int,
                   batch: int, is_inverse: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """The dual-schedule timestep draw (the JAX `compute_dual_t`): one
    stream gets a uniform t in [0, T), the other is anchored per sample at
    0 or T-1.  Inverse rendering (True): the attribute stream is uniform,
    the image anchored; forward rendering (False): the other way round.

    `generator` is a host (CPU) generator: the branch is a host bool, so
    the step branches without a device-to-host copy, and the timesteps are
    host tensors the caller moves.  `is_inverse` forces the branch (its
    draw is still taken, so the rest of the stream does not move).
    -> (t_img (B,), t_attr (B,), is_inverse)
    """
    if generator.device.type != "cpu":
        raise ValueError("compute_dual_t draws on the host: pass a CPU "
                         "torch.Generator")
    idx = bool(torch.rand((), generator=generator) < 0.5)
    if is_inverse is not None:
        idx = bool(is_inverse)
    t_uniform = torch.randint(0, num_timesteps, (batch,),
                              generator=generator)
    t_anchor = (torch.rand((batch,), generator=generator) < 0.5
                ).long() * (num_timesteps - 1)
    if idx:
        return t_anchor, t_uniform, True
    return t_uniform, t_anchor, False


def inference_timesteps(num_train_timesteps: int, num_steps: int) -> np.ndarray:
    """Descending inference grid, diffusers 'linspace' spacing:
    linspace(0, T-1, N+1).round() reversed, dropping the trailing 0."""
    ts = np.linspace(0, num_train_timesteps - 1, num_steps + 1).round()
    return ts[::-1][:-1].astype(np.int64).copy()
