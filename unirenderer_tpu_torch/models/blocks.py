"""UNet down/mid/up blocks (counterparts of `unirenderer_tpu/models/blocks.py`).

Down blocks return the taps the skips and the dual-stream residuals read
(one per resnet, plus one for a downsample); up blocks consume skips from
the end.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from unirenderer_tpu_torch.models.layers import (
    Downsample, ResnetBlock, Transformer2D, Upsample,
)

Taps = Tuple[torch.Tensor, ...]


class DownBlock(nn.Module):
    """n resnets (+ a transformer after each) + optional downsample."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 has_attention: bool, num_heads: int, ctx_dim: int,
                 transformer_layers: int, num_groups: int,
                 add_downsample: bool, temb_dim: int):
        super().__init__()
        self.num_layers = num_layers
        self.has_attention = has_attention
        self.add_downsample = add_downsample
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", ResnetBlock(
                in_channels if i == 0 else out_channels, out_channels,
                num_groups, temb_dim=temb_dim))
            if has_attention:
                self.add_module(f"attn_{i}", Transformer2D(
                    out_channels, num_heads, ctx_dim, transformer_layers,
                    num_groups))
        if add_downsample:
            self.downsample = Downsample(out_channels)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                ctx: torch.Tensor) -> Tuple[torch.Tensor, Taps]:
        taps: List[torch.Tensor] = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            if self.has_attention:
                x = getattr(self, f"attn_{i}")(x, ctx)
            taps.append(x)
        if self.add_downsample:
            x = self.downsample(x)
            taps.append(x)
        return x, tuple(taps)


class MidBlock(nn.Module):
    """resnet -> transformer -> resnet (UNetMidBlock2DCrossAttn)."""

    def __init__(self, channels: int, num_heads: int, ctx_dim: int,
                 transformer_layers: int, num_groups: int, temb_dim: int):
        super().__init__()
        self.resnet_0 = ResnetBlock(channels, channels, num_groups,
                                    temb_dim=temb_dim)
        self.attn = Transformer2D(channels, num_heads, ctx_dim,
                                  transformer_layers, num_groups)
        self.resnet_1 = ResnetBlock(channels, channels, num_groups,
                                    temb_dim=temb_dim)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                ctx: torch.Tensor) -> torch.Tensor:
        x = self.resnet_0(x, temb)
        x = self.attn(x, ctx)
        return self.resnet_1(x, temb)


class UpBlock(nn.Module):
    """n+1 resnets, each on the concat of x and one skip (taken from the
    end), + optional upsample.  `skip_channels` lists the skips' widths in
    the order they are consumed.  (The JAX block also returns per-resnet
    taps; nothing on the forward path reads them.)"""

    def __init__(self, in_channels: int, out_channels: int,
                 skip_channels: Sequence[int], has_attention: bool,
                 num_heads: int, ctx_dim: int, transformer_layers: int,
                 num_groups: int, add_upsample: bool, temb_dim: int):
        super().__init__()
        self.num_layers = len(skip_channels)
        self.has_attention = has_attention
        self.add_upsample = add_upsample
        ch = in_channels
        for i, sc in enumerate(skip_channels):
            self.add_module(f"resnet_{i}", ResnetBlock(
                ch + sc, out_channels, num_groups, temb_dim=temb_dim))
            ch = out_channels
            if has_attention:
                self.add_module(f"attn_{i}", Transformer2D(
                    out_channels, num_heads, ctx_dim, transformer_layers,
                    num_groups))
        if add_upsample:
            self.upsample = Upsample(out_channels)

    def forward(self, x: torch.Tensor, skips: Taps, temb: torch.Tensor,
                ctx: torch.Tensor) -> torch.Tensor:
        assert len(skips) == self.num_layers
        for i in range(self.num_layers):
            x = torch.cat([x, skips[-(i + 1)]], dim=-1)
            x = getattr(self, f"resnet_{i}")(x, temb)
            if self.has_attention:
                x = getattr(self, f"attn_{i}")(x, ctx)
        if self.add_upsample:
            x = self.upsample(x)
        return x
