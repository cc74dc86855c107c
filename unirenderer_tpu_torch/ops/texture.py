"""2D texture sampling and the split-sum FG table (counterpart of
`unirenderer_tpu/ops/texture.py`).

Lookups are plain advanced indexing into a flattened (N, C) table.  A
texture may carry a leading batch dimension (B, H, W, C); the lookup
coordinates then carry the same leading B and each element reads its own
texture.  The mip-mapped sampler weights every level by
clip(1 - |level - l|, 0, 1), which is the two-level trilinear blend.

The FG (environment BRDF) table is computed in-process from the split-sum
integral and cached for the life of the process; nothing is read from or
written to disk.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch


def _batch_offset(table_batch: Optional[int], lead: torch.Size,
                  per_item: int, device) -> Optional[torch.Tensor]:
    """Row offset of each batch element into a table of `table_batch`
    stacked items, broadcastable against lookups of leading shape `lead`."""
    if table_batch is None:
        return None
    if lead[0] != table_batch:
        raise ValueError(f"lookups lead with {lead[0]}, the table with "
                         f"{table_batch} items")
    off = torch.arange(table_batch, device=device) * per_item
    return off.reshape((table_batch,) + (1,) * (len(lead) - 1))


def gather_weighted(table: torch.Tensor, lins: Sequence[torch.Tensor],
                    weights: Sequence[torch.Tensor],
                    offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_k weights[k] * table[lins[k]] over an (N, C) table, in tap order;
    returns (..., C)."""
    acc = None
    for lin, w in zip(lins, weights):
        if offset is not None:
            lin = lin + offset
        term = table[lin] * w[..., None]
        acc = term if acc is None else acc + term
    return acc


def _bilinear_taps(h: int, w: int, uv: torch.Tensor, wrap: str):
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    wx = fx - x0
    wy = fy - y0
    if wrap == "clamp":
        def xi(x):
            return x.clamp(0, w - 1)

        def yi(y):
            return y.clamp(0, h - 1)
    elif wrap == "wrap":
        def xi(x):
            return torch.remainder(x, w)

        def yi(y):
            return torch.remainder(y, h)
    else:
        raise ValueError(wrap)
    lins = (yi(y0) * w + xi(x0), yi(y0) * w + xi(x0 + 1),
            yi(y0 + 1) * w + xi(x0), yi(y0 + 1) * w + xi(x0 + 1))
    wts = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    return lins, wts


def sample_texture2d(tex: torch.Tensor, uv: torch.Tensor,
                     wrap: str = "clamp") -> torch.Tensor:
    """Bilinear 2D sample.  tex (H, W, C), or (B, H, W, C) with uv leading
    with B; uv (..., 2) in [0, 1] (u right, v down).  Returns (..., C)."""
    batch = tex.shape[0] if tex.dim() == 4 else None
    h, w, c = tex.shape[-3:]
    lins, wts = _bilinear_taps(h, w, uv, wrap)
    off = _batch_offset(batch, uv.shape[:-1], h * w, uv.device)
    return gather_weighted(tex.reshape(-1, c), lins, wts, off)


def build_texture_mips(tex: torch.Tensor) -> List[torch.Tensor]:
    """Mip chain by 2x average pooling over the last three dims (H, W, C);
    stops when a side becomes odd or reaches 1.  Returns [base, mip1, ...]."""
    mips = [tex]
    while True:
        h, w, c = mips[-1].shape[-3:]
        if min(h, w) <= 1 or h % 2 or w % 2:
            break
        lead = mips[-1].shape[:-3]
        mips.append(mips[-1].reshape(lead + (h // 2, 2, w // 2, 2, c))
                    .mean((-4, -2)))
    return mips


def uv_mip_level(uv_deriv: torch.Tensor, width: int,
                 height: int) -> torch.Tensor:
    """Per-pixel fractional mip level from screen-space UV derivatives
    uv_deriv (..., 4) = (du/dx, dv/dx, du/dy, dv/dy):
    0.5 * log2(largest footprint in base-level texels)."""
    dx2 = (uv_deriv[..., 0] * width) ** 2 + (uv_deriv[..., 1] * height) ** 2
    dy2 = (uv_deriv[..., 2] * width) ** 2 + (uv_deriv[..., 3] * height) ** 2
    return 0.5 * torch.log2(torch.clamp(torch.maximum(dx2, dy2), min=1e-20))


def sample_texture2d_mip(mips: Sequence[torch.Tensor], uv: torch.Tensor,
                         uv_deriv: Optional[torch.Tensor] = None,
                         mip_level: Optional[torch.Tensor] = None,
                         wrap: str = "wrap") -> torch.Tensor:
    """Trilinear (linear-mipmap-linear) sample over an explicit mip chain,
    the level from `uv_deriv` (implicit LOD) or given as `mip_level`."""
    n = len(mips)
    if mip_level is None:
        if uv_deriv is None:
            mip_level = torch.zeros(uv.shape[:-1], device=uv.device)
        else:
            mip_level = uv_mip_level(uv_deriv, mips[0].shape[-2],
                                     mips[0].shape[-3])
    if n == 1:
        return sample_texture2d(mips[0], uv, wrap=wrap)
    lvl = torch.clamp(mip_level, 0.0, n - 1.0)
    out = None
    for li, m in enumerate(mips):
        w = torch.clamp(1.0 - torch.abs(lvl - li), 0.0, 1.0)[..., None]
        s = sample_texture2d(m, uv, wrap=wrap) * w
        out = s if out is None else out + s
    return out


def screen_uv_derivs(gb_texc: torch.Tensor, wrap: bool = True
                     ) -> torch.Tensor:
    """Finite-difference screen-space derivatives of an interpolated
    (..., H, W, 2) texcoord image: (..., H, W, 4) = (du/dx, dv/dx, du/dy,
    dv/dy).  `wrap` folds differences across a repeating-texture seam."""
    ddx = torch.cat([gb_texc[..., :, 1:, :] - gb_texc[..., :, :-1, :],
                     gb_texc[..., :, -1:, :] - gb_texc[..., :, -2:-1, :]],
                    dim=-2)
    ddy = torch.cat([gb_texc[..., 1:, :, :] - gb_texc[..., :-1, :, :],
                     gb_texc[..., -1:, :, :] - gb_texc[..., -2:-1, :, :]],
                    dim=-3)
    if wrap:
        ddx = ddx - torch.round(ddx)
        ddy = ddy - torch.round(ddy)
    return torch.cat([ddx, ddy], dim=-1)


# ---------------------------------------------------------------------------
# FG table (split-sum environment BRDF): (NdotV, roughness) -> (scale, bias)
# ---------------------------------------------------------------------------


def _integrate_fg(n_dot_v: torch.Tensor, roughness: torch.Tensor,
                  num_samples: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Karis split-sum BRDF integration over an (NdotV, roughness) grid."""
    from unirenderer_tpu_torch.ops.cubemap import _hammersley

    v = torch.stack([torch.sqrt(1.0 - n_dot_v * n_dot_v),
                     torch.zeros_like(n_dot_v), n_dot_v], dim=-1)
    xis = _hammersley(num_samples, n_dot_v.device)
    a_sum = torch.zeros_like(n_dot_v)
    b_sum = torch.zeros_like(n_dot_v)
    a = roughness * roughness
    k = a / 2.0                         # Smith G (Schlick-GGX), IBL k

    def g1(c):
        return c / (c * (1 - k) + k + 1e-8)

    for xi in xis:
        phi = 2.0 * math.pi * xi[0]
        cos_t = torch.sqrt((1.0 - xi[1])
                           / (1.0 + (a * a - 1.0) * xi[1] + 1e-12))
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        h = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], dim=-1)
        vh = torch.sum(v * h, -1, keepdim=True)
        l = 2.0 * vh * h - v
        n_dot_l = torch.clamp(l[..., 2], min=0.0)
        n_dot_h = torch.clamp(h[..., 2], min=0.0)
        v_dot_h = torch.clamp(torch.sum(v * h, -1), min=0.0)
        g = g1(n_dot_l) * g1(torch.clamp(n_dot_v, min=1e-4))
        g_vis = torch.where(
            n_dot_l > 0,
            g * v_dot_h / torch.clamp(
                n_dot_h * torch.clamp(n_dot_v, min=1e-4), min=1e-8),
            0.0)
        x = 1.0 - v_dot_h
        x2 = x * x
        fc = x * (x2 * x2)               # x^5 by squaring, as lax does
        a_sum = a_sum + (1.0 - fc) * g_vis
        b_sum = b_sum + fc * g_vis
    return a_sum / num_samples, b_sum / num_samples


@functools.lru_cache(maxsize=2)
def _fg_table(res: int, num_samples: int) -> torch.Tensor:
    g = (torch.arange(res, dtype=torch.float32) + 0.5) / res
    rough, n_dot_v = torch.meshgrid(g, g, indexing="ij")   # u -> NdotV
    fa, fb = _integrate_fg(n_dot_v, rough, num_samples)
    return torch.stack([fa, fb], dim=-1)[None]


def fg_lut(res: int = 256, num_samples: int = 512) -> torch.Tensor:
    """(1, res, res, 2) FG table on the CPU; axis 2 (u) is NdotV, axis 1
    (v) roughness.  Computed once per process (about a second); each call
    returns a fresh copy."""
    return _fg_table(res, num_samples).clone()
