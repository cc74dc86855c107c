"""The dual-stream denoiser: image UNet, attribute encoder and attribute
decoder.

Counterpart of `unirenderer_tpu/models/dual_stream.py`: `ImageUNet`,
`AttrEncoder`, `AttrDecoder` (flax name `controldec`) and the split entry
points the sampler uses.  Forward rendering: `encode_attr` (run once per
request: the attribute stream is clean at t_attr = 0, so the encoder's
residuals do not change across denoise steps) and
`image_stream_with_residuals` (one UNet pass per step), or with encoder
reuse `image_stream_full_taps` (a full pass that also returns the UNet's
raw taps) and `image_stream_cached` (the decoder half alone from cached
raw taps) in between.  Inverse
rendering: `unet_raw_taps` (the UNet's encoder half, once per request: the
image latent is clean at t_img = 0 and the decoder reads the taps before
any residual is added) and `attr_streams_with_unet_taps` (encoder and
decoder, once per step).  Training: `forward`, the full model (the JAX
`__call__`), optionally without the decoder; with `UNetConfig.remat`
every down and up block recomputes its activations in the backward
(`torch.utils.checkpoint`, where the JAX package wraps them in `nn.remat`).

Submodule names are the flax names (`unet`, `controlnet`, `controldec`,
`down_0`, ...).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unirenderer_tpu_torch.core.config import UNetConfig
from unirenderer_tpu_torch.models.blocks import DownBlock, MidBlock, UpBlock
from unirenderer_tpu_torch.models.layers import (
    Conv, FusedGroupNorm, TimestepEmbedMLP, ZeroConv, timestep_embedding,
)

Taps = Tuple[torch.Tensor, ...]


def down_tap_channels(cfg: UNetConfig) -> List[int]:
    """Widths of the encoder half's taps: conv_in, then one per resnet and
    one per downsample (1 + 3 + 3 + 3 + 2 at SD1.x)."""
    chs = [cfg.block_out_channels[0]]
    for i, ch in enumerate(cfg.block_out_channels):
        chs += [ch] * cfg.layers_per_block
        if i != len(cfg.block_out_channels) - 1:
            chs.append(ch)
    return chs


class _Trunk(nn.Module):
    """The time embedding every stream carries (flax `_Trunk.time_embed`)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.time_embedding = TimestepEmbedMLP(cfg.block_out_channels[0],
                                               cfg.time_embed_dim)

    def time_embed(self, t: torch.Tensor) -> torch.Tensor:
        return self.time_embedding(
            timestep_embedding(t, self.cfg.block_out_channels[0]))

    def _block(self, block: nn.Module, *args):
        """A down or up block, under activation checkpointing when the
        config asks for remat and a backward will follow."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)


class _EncoderHalf(_Trunk):
    """conv_in and the down + mid blocks shared by the UNet and the
    attribute encoder."""

    def __init__(self, cfg: UNetConfig, in_channels: int):
        super().__init__(cfg)
        chs = cfg.block_out_channels
        temb = cfg.time_embed_dim
        self.conv_in = Conv(in_channels, chs[0], 3, padding=1)
        prev = chs[0]
        for i, ch in enumerate(chs):
            self.add_module(f"down_{i}", DownBlock(
                prev, ch, cfg.layers_per_block, cfg.down_block_attn[i],
                cfg.num_heads, cfg.cross_attention_dim,
                cfg.transformer_layers, cfg.norm_num_groups,
                add_downsample=i != len(chs) - 1, temb_dim=temb))
            prev = ch
        self.mid = MidBlock(chs[-1], cfg.num_heads, cfg.cross_attention_dim,
                            cfg.transformer_layers, cfg.norm_num_groups, temb)

    def encode(self, x: torch.Tensor, temb: torch.Tensor,
               ctx: torch.Tensor) -> Tuple[Taps, torch.Tensor]:
        x = self.conv_in(x.to(self.conv_in.weight.dtype))
        taps = [x]
        for i in range(len(self.cfg.block_out_channels)):
            x, t = self._block(getattr(self, f"down_{i}"), x, temb, ctx)
            taps.extend(t)
        return tuple(taps), self.mid(x, temb, ctx)


class _DecoderHalf:
    """The up blocks, conv_norm_out (through K1) and conv_out shared by the
    UNet and the attribute decoder (a mixin of an `nn.Module`)."""

    def _add_decoder_half(self, cfg: UNetConfig, out_channels: int) -> None:
        chs = cfg.block_out_channels
        rev = tuple(reversed(chs))
        n_skip = cfg.layers_per_block + 1
        skips = down_tap_channels(cfg)
        prev = chs[-1]
        for i, ch in enumerate(rev):
            blk = skips[-n_skip:]
            del skips[-n_skip:]
            self.add_module(f"up_{i}", UpBlock(
                prev, ch, tuple(reversed(blk)), cfg.up_block_attn[i],
                cfg.num_heads, cfg.cross_attention_dim,
                cfg.transformer_layers, cfg.norm_num_groups,
                add_upsample=i != len(rev) - 1,
                temb_dim=cfg.time_embed_dim))
            prev = ch
        self.conv_norm_out = FusedGroupNorm(chs[0], cfg.norm_num_groups, 1e-5,
                                            silu=True)
        self.conv_out = Conv(chs[0], out_channels, 3, padding=1)

    def decode(self, x: torch.Tensor, skips: Taps, temb: torch.Tensor,
               ctx: torch.Tensor) -> torch.Tensor:
        """Up blocks over the mid output `x`, consuming `skips` from the
        end; -> conv_out(silu(norm(x))) in f32."""
        skips = list(skips)
        n_skip = self.cfg.layers_per_block + 1
        for i in range(len(self.cfg.block_out_channels)):
            blk_skips = tuple(skips[-n_skip:])
            del skips[-n_skip:]
            x = self._block(getattr(self, f"up_{i}"), x, blk_skips, temb,
                            ctx)
        return self.conv_out(self.conv_norm_out(x)).float()


class ImageUNet(_EncoderHalf, _DecoderHalf):
    """SD-geometry UNet over the image latent; residuals from the attribute
    encoder are added to its encoder half's taps and mid output.

    forward -> img_pred (f32)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg, cfg.in_channels)
        self._add_decoder_half(cfg, cfg.out_channels)

    def forward(self, sample: torch.Tensor, t_img: torch.Tensor,
                ctx: torch.Tensor, down_residuals: Optional[Taps] = None,
                mid_residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_with_taps(sample, t_img, ctx, down_residuals,
                                      mid_residual)[0]

    def forward_with_taps(self, sample: Optional[torch.Tensor],
                          t_img: torch.Tensor, ctx: torch.Tensor,
                          down_residuals: Optional[Taps] = None,
                          mid_residual: Optional[torch.Tensor] = None,
                          cached_raw: Optional[Tuple[Taps, torch.Tensor]]
                          = None) -> Tuple[torch.Tensor, Taps, torch.Tensor]:
        """-> (img_pred, raw down taps, raw mid output): the taps before
        any residual is added, which the attribute decoder reads.
        `cached_raw` = (raw down taps, raw mid) skips conv_in and the down
        and mid blocks (`sample` is then unused): the residuals go onto
        the given taps and the decoder half runs at `t_img`."""
        temb = self.time_embed(t_img)
        if cached_raw is None:
            raw_down, raw_mid = self.encode(sample, temb, ctx)
        else:
            raw_down, raw_mid = cached_raw
        down_taps, x = raw_down, raw_mid
        if down_residuals is not None:
            down_taps = tuple(d + r.to(d.dtype)
                              for d, r in zip(down_taps, down_residuals))
        if mid_residual is not None:
            x = x + mid_residual.to(x.dtype)
        return self.decode(x, down_taps, temb, ctx), raw_down, raw_mid


class AttrEncoder(_EncoderHalf):
    """ControlNet-style copy of the UNet encoder over the 28-channel
    attribute latent; the image latent never enters it.

    forward -> (ctrl_down, ctrl_mid, raw_down, raw_mid): the zero-conv'd
    taps and mid output (the residuals into the UNet), then the raw ones
    (the attribute decoder's skips and mid input)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg, cfg.attr_channels)
        for i, ch in enumerate(down_tap_channels(cfg)):
            self.add_module(f"zero_down_{i}", ZeroConv(ch))
        self.zero_mid = ZeroConv(cfg.block_out_channels[-1])

    def forward(self, attr_latent: torch.Tensor, t_attr: torch.Tensor,
                ctx: torch.Tensor
                ) -> Tuple[Taps, torch.Tensor, Taps, torch.Tensor]:
        temb = self.time_embed(t_attr)
        down_taps, mid = self.encode(attr_latent, temb, ctx)
        ctrl_down = tuple(getattr(self, f"zero_down_{i}")(t)
                          for i, t in enumerate(down_taps))
        return ctrl_down, self.zero_mid(mid), down_taps, mid


class AttrDecoder(_Trunk, _DecoderHalf):
    """UNet-decoder copy that predicts the 28-channel attribute latent.
    Its skips are the attribute encoder's raw taps plus zero convs of the
    UNet's raw taps (`control_down_{i}`, `control_mid`): the image-to-
    attribute direction of the cross-conditioning.

    forward -> attr_pred (B, H, W, 28), f32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        for i, ch in enumerate(down_tap_channels(cfg)):
            self.add_module(f"control_down_{i}", ZeroConv(ch))
        self.control_mid = ZeroConv(cfg.block_out_channels[-1])
        self._add_decoder_half(cfg, cfg.attr_channels)

    def forward(self, enc_mid: torch.Tensor, enc_down: Taps,
                t_attr: torch.Tensor, ctx: torch.Tensor, unet_down: Taps,
                unet_mid: torch.Tensor) -> torch.Tensor:
        temb = self.time_embed(t_attr)
        skips = tuple(
            e + getattr(self, f"control_down_{i}")(u).to(e.dtype)
            for i, (e, u) in enumerate(zip(enc_down, unet_down)))
        x = enc_mid + self.control_mid(unet_mid).to(enc_mid.dtype)
        return self.decode(x, skips, temb, ctx)


class DualStreamModel(nn.Module):
    """The image UNet (`unet`), the attribute encoder (`controlnet`) and
    the attribute decoder (`controldec`)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.unet = ImageUNet(cfg)
        self.controlnet = AttrEncoder(cfg)
        self.controldec = AttrDecoder(cfg)

    def forward(self, img_latent: torch.Tensor, attr_latent: torch.Tensor,
                t_img: torch.Tensor, t_attr: torch.Tensor, ctx: torch.Tensor,
                run_decoder: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Both streams in one call (the JAX `DualStreamModel.__call__`):
        the attribute encoder's residuals into the UNet, the UNet's raw
        taps into the attribute decoder -> (img_pred (B, H, W, 4),
        attr_pred (B, H, W, 28) or None without the decoder), f32."""
        ctx = ctx.to(self.unet.conv_in.weight.dtype)
        ctrl_down, ctrl_mid, enc_down, enc_mid = self.controlnet(
            attr_latent, t_attr, ctx)
        img_pred, unet_down, unet_mid = self.unet.forward_with_taps(
            img_latent, t_img, ctx, ctrl_down, ctrl_mid)
        if not run_decoder:
            return img_pred, None
        return img_pred, self.controldec(enc_mid, enc_down, t_attr, ctx,
                                         unet_down, unet_mid)

    def encode_attr(self, attr_latent: torch.Tensor, t_attr: torch.Tensor,
                    ctx: torch.Tensor) -> Tuple[Taps, torch.Tensor]:
        dtype = self.unet.conv_in.weight.dtype
        ctrl_down, ctrl_mid, _, _ = self.controlnet(attr_latent, t_attr,
                                                    ctx.to(dtype))
        return ctrl_down, ctrl_mid

    def image_stream_with_residuals(self, img_latent: torch.Tensor,
                                    t_img: torch.Tensor, ctx: torch.Tensor,
                                    ctrl_down: Taps,
                                    ctrl_mid: torch.Tensor) -> torch.Tensor:
        dtype = self.unet.conv_in.weight.dtype
        return self.unet(img_latent, t_img, ctx.to(dtype), ctrl_down,
                         ctrl_mid)

    def image_stream_full_taps(self, img_latent: torch.Tensor,
                               t_img: torch.Tensor, ctx: torch.Tensor,
                               ctrl_down: Taps, ctrl_mid: torch.Tensor
                               ) -> Tuple[torch.Tensor, Taps, torch.Tensor]:
        """`image_stream_with_residuals` that also returns the UNet's raw
        down taps and mid output, the cache of encoder reuse."""
        dtype = self.unet.conv_in.weight.dtype
        return self.unet.forward_with_taps(img_latent, t_img, ctx.to(dtype),
                                           ctrl_down, ctrl_mid)

    def image_stream_cached(self, t_img: torch.Tensor, ctx: torch.Tensor,
                            ctrl_down: Taps, ctrl_mid: torch.Tensor,
                            cached_raw: Tuple[Taps, torch.Tensor]
                            ) -> torch.Tensor:
        """A decoder-only step from the raw taps `image_stream_full_taps`
        returned at an earlier step (encoder reuse) -> img_pred (f32)."""
        dtype = self.unet.conv_in.weight.dtype
        return self.unet.forward_with_taps(None, t_img, ctx.to(dtype),
                                           ctrl_down, ctrl_mid,
                                           cached_raw=cached_raw)[0]

    def unet_raw_taps(self, img_latent: torch.Tensor, t_img: torch.Tensor,
                      ctx: torch.Tensor) -> Tuple[Taps, torch.Tensor]:
        """The UNet's encoder half alone: its raw down taps and mid output,
        before any residual (the up blocks do not run)."""
        dtype = self.unet.conv_in.weight.dtype
        return self.unet.encode(img_latent, self.unet.time_embed(t_img),
                                ctx.to(dtype))

    def attr_streams_with_unet_taps(self, attr_latent: torch.Tensor,
                                    t_attr: torch.Tensor, ctx: torch.Tensor,
                                    unet_down: Taps,
                                    unet_mid: torch.Tensor) -> torch.Tensor:
        """Encoder then decoder over the attribute latent at `t_attr`, with
        the UNet's raw taps from `unet_raw_taps` -> attr_pred (f32)."""
        ctx = ctx.to(self.unet.conv_in.weight.dtype)
        _, _, enc_down, enc_mid = self.controlnet(attr_latent, t_attr, ctx)
        return self.controldec(enc_mid, enc_down, t_attr, ctx, unet_down,
                               unet_mid)
