"""SD AutoencoderKL, NHWC (counterpart of `unirenderer_tpu/models/vae.py`).

GroupNorm epsilons follow the JAX package: 1e-5 in every ResnetBlock, 1e-6
in the mid-block attention norm and in `conv_norm_out`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unirenderer_tpu_torch.core.config import VAEConfig
from unirenderer_tpu_torch.models.layers import (
    Conv, FusedGroupNorm, ResnetBlock, SelfAttention2D, upsample_nearest2x,
)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chs, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv(cfg.in_channels, chs[0], 3, padding=1)
        prev = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(prev, ch, g))
                prev = ch
            if i != len(chs) - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv(ch, ch, 3, stride=2, padding=0))
        self.mid_res_0 = ResnetBlock(prev, prev, g)
        self.mid_attn = SelfAttention2D(prev, g)
        self.mid_res_1 = ResnetBlock(prev, prev, g)
        self.conv_norm_out = FusedGroupNorm(prev, g, 1e-6, silu=True)
        self.conv_out = Conv(prev, 2 * cfg.latent_channels, 3, padding=1)
        self.quant_conv = Conv(2 * cfg.latent_channels,
                               2 * cfg.latent_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chs = self.cfg.block_out_channels
        x = self.conv_in(x.to(self.conv_in.weight.dtype))
        for i in range(len(chs)):
            for j in range(self.cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x)
            if i != len(chs) - 1:
                # SD VAE downsample: asymmetric (0, 1) pad on H and W, then
                # a stride-2 VALID conv
                x = F.pad(x, (0, 0, 0, 1, 0, 1))
                x = getattr(self, f"down_{i}_downsample")(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        x = self.conv_out(self.conv_norm_out(x))
        return self.quant_conv(x)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels, 1)
        self.conv_in = Conv(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_res_0 = ResnetBlock(rev[0], rev[0], g)
        self.mid_attn = SelfAttention2D(rev[0], g)
        self.mid_res_1 = ResnetBlock(rev[0], rev[0], g)
        prev = rev[0]
        for i, ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(prev, ch, g))
                prev = ch
            if i != len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        self.conv_norm_out = FusedGroupNorm(prev, g, 1e-6, silu=True)
        self.conv_out = Conv(prev, cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n_levels = len(cfg.block_out_channels)
        x = self.conv_in(self.post_quant_conv(
            z.to(self.post_quant_conv.weight.dtype)))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        for i in range(n_levels):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(x)
            if i != n_levels - 1:
                x = getattr(self, f"up_{i}_upsample")(upsample_nearest2x(x))
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """encode -> (mean, logvar); decode -> image.  Latents are scaled by
    cfg.scaling_factor at the call sites (pipelines.py)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.encoder(x).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
