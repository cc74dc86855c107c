"""Primitive layers of the dual-stream denoiser and the VAE.

Counterparts of `unirenderer_tpu/models/layers.py`, as `nn.Module`s whose
parameter names follow the flax module names, so `core/convert.py` maps a
flax path onto a state-dict key by renaming the leaf only.

Activations are NHWC at every public function, as in the JAX package.
`Conv` permutes to an NCHW view for PyTorch's convolution; an NHWC tensor
seen as NCHW is a channels_last tensor, so with channels_last weights the
convolution runs in that layout without copies.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unirenderer_tpu_torch.ops.attn_kernel import unet_flash_attention
from unirenderer_tpu_torch.ops.flash_attention import (
    flash_attention, tileable,
)
from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
from unirenderer_tpu_torch.ops.splash_attention import splash_attention

# UNIRENDER_ATTN values the port takes: "auto" (the default), "flash", and
# the two routes for tileable self-attention
ATTN_ROUTES = ("auto", "flash", "splash", "unet_flash")
# the routes without a backward, and why
NO_BACKWARD = {
    "splash": "the JAX splash route has no backward either "
              "(`_splash_kernel` gives no backward block sizes, so "
              "jax.grad raises)",
    "unet_flash": "K3 is forward-only in the JAX package too (never "
                  "selected for training there)",
}


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, SD convention: cos first
    (flip_sin_to_cos), frequency shift 0, f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Conv(nn.Conv2d):
    """2-D convolution over NHWC tensors (flax `nn.Conv` counterpart)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class TimestepEmbedMLP(nn.Module):
    """linear -> silu -> linear, 320 -> 1280 in SD geometry."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        w = self.linear_1.weight
        return self.linear_2(F.silu(self.linear_1(t_emb.to(w.dtype))))


class FusedGroupNorm(nn.Module):
    """GroupNorm with optional fused SiLU through kernel K1
    (ops/groupnorm.py).  Parameters are `weight`/`bias` (flax scale/bias)."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_groupnorm_silu(x.contiguous(), self.weight, self.bias,
                                    self.num_groups, self.eps, self.silu)


class ResnetBlock(nn.Module):
    """SD ResnetBlock2D: GN->silu->conv3x3 [+temb] ->GN->silu->conv3x3 + skip.
    `temb_dim=None` builds the VAE's variant without a time projection."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 32, eps: float = 1e-5,
                 temb_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = FusedGroupNorm(in_channels, num_groups, eps, silu=True)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_dim, out_channels)
                              if temb_dim is not None else None)
        self.norm2 = FusedGroupNorm(out_channels, num_groups, eps, silu=True)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t[:, None, None, :].to(h.dtype)
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """conv3x3 stride 2, pad 1 (SD UNet downsample)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 over NHWC: for x2, `jax.image.resize(..., "nearest")` is
    an exact repeat of every pixel."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


class Upsample(nn.Module):
    """nearest x2 + conv3x3 (SD UNet upsample)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D) + bias) V over (B, S, H, D) in f32, for the
    two attentions that were XLA on the TPU too: the VAE's single-head
    mid-block attention and CLIP's causal attention."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              is_self: bool) -> torch.Tensor:
    """The attention route, read from UNIRENDER_ATTN on every call, as the
    JAX package's `maybe_flash_attention` does: "splash" sends tileable
    self-attention (`ops.flash_attention.tileable`) to K2s, "unet_flash" to
    K3; everything else (cross-attention, the untileable levels, and every
    shape under "auto" / "flash" / unset) goes to K2.  Under autograd only
    K2 has a backward: the two routes raise there rather than fall back."""
    which = os.environ.get("UNIRENDER_ATTN", "auto")
    if which not in ATTN_ROUTES:
        raise ValueError(f"UNIRENDER_ATTN={which!r}: the port takes "
                         f"{', '.join(ATTN_ROUTES)}")
    if which in NO_BACKWARD and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(f"UNIRENDER_ATTN={which} has no backward: "
                           f"{NO_BACKWARD[which]}; train with "
                           f"UNIRENDER_ATTN=flash (or auto)")
    if is_self and which in ("splash", "unet_flash") and tileable(
            q.shape[1], k.shape[1], q.shape[-1]):
        route = splash_attention if which == "splash" else \
            unet_flash_attention
        return route(q, k, v)
    return flash_attention(q, k, v)


class Attention(nn.Module):
    """Multi-head attention, self- or cross- depending on `ctx`; SD1.x
    convention (inner dim = query dim, no bias on q/k/v).  Each call goes
    through the route `attention` picks: K2 (ops/flash_attention.py) by
    default."""

    def __init__(self, dim: int, num_heads: int,
                 ctx_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        src = dim if ctx_dim is None else ctx_dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(src, dim, bias=False)
        self.to_v = nn.Linear(src, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        src = x if ctx is None else ctx
        b, sq, inner = x.shape
        sk = src.shape[1]
        hd = inner // self.num_heads
        q = self.to_q(x).reshape(b, sq, self.num_heads, hd)
        k = self.to_k(src).reshape(b, sk, self.num_heads, hd)
        v = self.to_v(src).reshape(b, sk, self.num_heads, hd)
        out = attention(q, k, v, is_self=ctx is None)
        return self.to_out(out.reshape(b, sq, inner))


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward, expansion 4x.  The gate uses the tanh GELU, as
    `flax.linen.gelu` (approximate=True) does."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim * 8)
        self.out = nn.Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    """LN->self-attn  LN->cross-attn  LN->GEGLU-FF, each residual; LayerNorm
    eps 1e-5."""

    def __init__(self, dim: int, num_heads: int, ctx_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, ctx_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN(eps 1e-6) -> 1x1 conv in -> N blocks ->
    1x1 conv out + residual."""

    def __init__(self, channels: int, num_heads: int, ctx_dim: int,
                 num_layers: int = 1, num_groups: int = 32):
        super().__init__()
        self.norm = FusedGroupNorm(channels, num_groups, 1e-6)
        self.proj_in = Conv(channels, channels, 1)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}",
                            BasicTransformerBlock(channels, num_heads, ctx_dim))
        self.proj_out = Conv(channels, channels, 1)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        res = x
        x = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, ctx)
        return self.proj_out(x.reshape(b, h, w, c)) + res


class SelfAttention2D(nn.Module):
    """Single-head spatial self-attention of the VAE mid block (GN eps
    1e-6, no SiLU).  Its attention was XLA on the TPU and is plain PyTorch
    here (`dense_attention`)."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.norm = FusedGroupNorm(channels, num_groups, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        res = x
        x = self.norm(x).reshape(b, h * w, 1, c)
        out = dense_attention(self.to_q(x), self.to_k(x), self.to_v(x))
        out = self.to_out(out.reshape(b, h * w, c))
        return res + out.reshape(b, h, w, c)


class ZeroConv(nn.Module):
    """1x1 conv: the ControlNet residual gate (zero at the start of
    training; any value once trained)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
