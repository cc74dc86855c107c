"""Cubemaps: face/direction maps, seamless bilinear and trilinear lookups,
latlong conversions and the split-sum prefilters (counterpart of
`unirenderer_tpu/ops/cubemap.py`, same conventions: face order
[+x, -x, +y, -y, +z, -z], pixel centres at -1 + 1/R .. 1 - 1/R).

Taps that fall off a face edge are remapped through their 3D direction
onto the adjacent face (nearest texel there).  A cube may carry a leading
batch dimension (B, 6, R, R, C); the directions then lead with B too.
Lookups are plain advanced indexing; the mip lookup weights every level by
clip(1 - |level - l|, 0, 1).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from unirenderer_tpu_torch.ops.texture import _batch_offset, gather_weighted


# ---------------------------------------------------------------------------
# Face <-> direction mapping
# ---------------------------------------------------------------------------


def cube_to_dir(face: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x, y) in [-1, 1] on `face` -> unnormalised direction (..., 3)."""
    one = torch.ones_like(x)
    d = {0: (one, -y, -x), 1: (-one, -y, x), 2: (x, one, y),
         3: (x, -one, -y), 4: (x, -y, one), 5: (-x, -y, -one)}[face]
    return torch.stack(d, dim=-1)


def face_grid(res: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-centre grid (gy, gx), each (res, res)."""
    g = torch.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res,
                       device=device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    return gy, gx


def all_face_dirs(res: int, device=None) -> torch.Tensor:
    """(6, res, res, 3) unit direction per texel."""
    gy, gx = face_grid(res, device)
    dirs = torch.stack([cube_to_dir(s, gx, gy) for s in range(6)])
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def texel_solid_angles(res: int, device=None) -> torch.Tensor:
    """(res, res) solid angle of each texel (the same on every face)."""
    def proj(x, y):
        return torch.atan2(x * y, torch.sqrt(x * x + y * y + 1.0))
    edge = torch.linspace(-1.0, 1.0, res + 1, device=device)
    ey, ex = torch.meshgrid(edge, edge, indexing="ij")
    a = (proj(ex[1:, 1:], ey[1:, 1:]) - proj(ex[1:, :-1], ey[1:, :-1])
         - proj(ex[:-1, 1:], ey[:-1, 1:]) + proj(ex[:-1, :-1], ey[:-1, :-1]))
    return torch.abs(a)


def dir_to_cube_uv(v: torch.Tensor):
    """Directions (..., 3) -> (face index (...,), x, y in [-1, 1])."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    ax, ay, az = vx.abs(), vy.abs(), vz.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(
        is_x, torch.where(vx > 0, 0, 1),
        torch.where(is_y, torch.where(vy > 0, 2, 3),
                    torch.where(vz > 0, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                     min=1e-20)
    # per face: x = (-vz, vz, vx, vx, vx, -vx) / ma,
    #           y = (-vy, -vy, vz, -vz, -vy, -vy) / ma
    x = torch.where(is_x, torch.where(vx > 0, -vz, vz),
                    torch.where(is_y | (vz > 0), vx, -vx)) / ma
    y = torch.where(is_x, -vy,
                    torch.where(is_y, torch.where(vy > 0, vz, -vz),
                                -vy)) / ma
    return face, x, y


def cube_to_dir_vec(face: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """`cube_to_dir` with an integer tensor of faces."""
    one = torch.ones_like(x)
    dx = torch.where(face == 0, one, torch.where(
        face == 1, -one, torch.where(face == 5, -x, x)))
    dy = torch.where(face == 2, one, torch.where(face == 3, -one, -y))
    dz = torch.where(face == 0, -x, torch.where(
        face == 1, x, torch.where(face == 2, y, torch.where(
            face == 3, -y, torch.where(face == 4, one, -one)))))
    return torch.stack([dx, dy, dz], dim=-1)


def _seamless_tap_index(face: torch.Tensor, xi: torch.Tensor,
                        yi: torch.Tensor, res: int):
    """Resolve one bilinear tap (integer texel (xi, yi), possibly one texel
    off the face) to a (face, row, col) texel, crossing onto the adjacent
    face when off the edge."""
    inside = (xi >= 0) & (xi < res) & (yi >= 0) & (yi < res)
    px = (xi.float() + 0.5) * (2.0 / res) - 1.0
    py = (yi.float() + 0.5) * (2.0 / res) - 1.0
    f2, u2, v2 = dir_to_cube_uv(cube_to_dir_vec(face, px, py))
    ix2 = torch.round((u2 + 1.0) * 0.5 * res - 0.5).clamp(0, res - 1).long()
    iy2 = torch.round((v2 + 1.0) * 0.5 * res - 0.5).clamp(0, res - 1).long()
    fo = torch.where(inside, face, f2)
    xo = torch.where(inside, xi.clamp(0, res - 1), ix2)
    yo = torch.where(inside, yi.clamp(0, res - 1), iy2)
    return fo, yo, xo


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def sample_cubemap(cube: torch.Tensor, dirs: torch.Tensor,
                   seamless: bool = True) -> torch.Tensor:
    """Bilinear cubemap sample.  cube (6, R, R, C), or (B, 6, R, R, C)
    with dirs leading with B; dirs (..., 3) -> (..., C).  seamless=False
    clamps at face edges instead of crossing them."""
    batch = cube.shape[0] if cube.dim() == 5 else None
    res, c = cube.shape[-2], cube.shape[-1]
    face, x, y = dir_to_cube_uv(dirs)
    fx = (x + 1.0) * 0.5 * res - 0.5
    fy = (y + 1.0) * 0.5 * res - 0.5
    x0 = torch.floor(fx).long()              # may be -1 .. res-1
    y0 = torch.floor(fy).long()
    wx = torch.clamp(fx - x0, 0.0, 1.0)
    wy = torch.clamp(fy - y0, 0.0, 1.0)

    def lin_tap(yy, xx):
        if seamless:
            f, r, col = _seamless_tap_index(face, xx, yy, res)
            return (f * res + r) * res + col
        return ((face * res + yy.clamp(0, res - 1)) * res
                + xx.clamp(0, res - 1))

    lins = (lin_tap(y0, x0), lin_tap(y0, x0 + 1),
            lin_tap(y0 + 1, x0), lin_tap(y0 + 1, x0 + 1))
    wts = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    off = _batch_offset(batch, dirs.shape[:-1], 6 * res * res, dirs.device)
    return gather_weighted(cube.reshape(-1, c), lins, wts, off)


def sample_cubemap_mip(mips: Sequence[torch.Tensor], dirs: torch.Tensor,
                       mip_level: torch.Tensor) -> torch.Tensor:
    """Trilinear cubemap lookup at a per-pixel fractional mip level in
    [0, len(mips) - 1]; mips: list of (6, R_l, R_l, C) (or batched)."""
    n = len(mips)
    if n == 1:
        return sample_cubemap(mips[0], dirs)
    lvl = torch.clamp(mip_level, 0.0, n - 1.0)
    out = None
    for li, m in enumerate(mips):
        w = torch.clamp(1.0 - torch.abs(lvl - li), 0.0, 1.0)[..., None]
        s = sample_cubemap(m, dirs) * w
        out = s if out is None else out + s
    return out


# ---------------------------------------------------------------------------
# Latlong conversion
# ---------------------------------------------------------------------------


def latlong_to_cubemap(latlong: torch.Tensor, res: int) -> torch.Tensor:
    """(H, W, C) equirectangular -> (6, res, res, C), bilinear."""
    dirs = all_face_dirs(res, latlong.device)
    tu = torch.atan2(dirs[..., 0], -dirs[..., 2]) / (2 * math.pi) + 0.5
    tv = torch.acos(torch.clamp(dirs[..., 1], -1.0, 1.0)) / math.pi
    h, w = latlong.shape[:2]
    fx = tu * w - 0.5
    fy = tv * h - 0.5
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).clamp(0, h - 1).long()
    y1 = (y0 + 1).clamp(0, h - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0w = torch.remainder(x0, w)                   # wrap in azimuth
    x1w = torch.remainder(x0 + 1, w)
    top = latlong[y0, x0w] * (1 - wx) + latlong[y0, x1w] * wx
    bot = latlong[y1, x0w] * (1 - wx) + latlong[y1, x1w] * wx
    return top * (1 - wy) + bot * wy


def cubemap_to_latlong(cube: torch.Tensor, res) -> torch.Tensor:
    """(6, R, R, C) -> (res_h, res_w, C) equirectangular; a batched cube
    (B, 6, R, R, C) gives (B, res_h, res_w, C)."""
    rh, rw = (res, res * 2) if isinstance(res, int) else res
    dev = cube.device
    gy = torch.linspace(0.0 + 1.0 / rh, 1.0 - 1.0 / rh, rh, device=dev)
    gx = torch.linspace(-1.0 + 1.0 / rw, 1.0 - 1.0 / rw, rw, device=dev)
    gy, gx = torch.meshgrid(gy, gx, indexing="ij")
    sin_t, cos_t = torch.sin(gy * math.pi), torch.cos(gy * math.pi)
    sin_p, cos_p = torch.sin(gx * math.pi), torch.cos(gx * math.pi)
    dirs = torch.stack([sin_t * sin_p, cos_t, -sin_t * cos_p], dim=-1)
    if cube.dim() == 5:
        dirs = dirs.expand((cube.shape[0],) + dirs.shape)
    return sample_cubemap(cube, dirs)


# ---------------------------------------------------------------------------
# Prefiltering
# ---------------------------------------------------------------------------


def downsample_cubemap(cube: torch.Tensor) -> torch.Tensor:
    """2x average-pool each face of (..., 6, R, R, C)."""
    r, c = cube.shape[-2], cube.shape[-1]
    x = cube.reshape(cube.shape[:-3] + (r // 2, 2, r // 2, 2, c))
    return x.mean(dim=(-4, -2))


def diffuse_cubemap(cube: torch.Tensor) -> torch.Tensor:
    """Lambertian irradiance over the whole sphere as one (6R^2 x 6R^2)
    product; meant for a small R (16)."""
    _, r, _, c = cube.shape
    dirs = all_face_dirs(r, cube.device).reshape(-1, 3)
    sa = texel_solid_angles(r, cube.device)
    sa = sa[None].expand(6, r, r).reshape(-1)
    cosw = torch.clamp(dirs @ dirs.T, min=0.0) * sa[None, :]
    out = (cosw @ cube.reshape(-1, c)) / torch.clamp(
        torch.sum(cosw, dim=1, keepdim=True), min=1e-8)
    return out.reshape(6, r, r, c)


def _hammersley(n: int, device=None) -> torch.Tensor:
    """(n, 2) low-discrepancy sequence (van der Corput radical inverse)."""
    i = np.arange(n, dtype=np.uint32)
    bits = (i << np.uint32(16)) | (i >> np.uint32(16))
    for m1, m2, s in ((0x55555555, 0xAAAAAAAA, 1), (0x33333333, 0xCCCCCCCC, 2),
                      (0x0F0F0F0F, 0xF0F0F0F0, 4), (0x00FF00FF, 0xFF00FF00, 8)):
        bits = (((bits & np.uint32(m1)) << np.uint32(s))
                | ((bits & np.uint32(m2)) >> np.uint32(s)))
    rad = bits.astype(np.float32) * np.float32(1.0 / 4294967296.0)
    out = np.stack([i.astype(np.float32) / np.float32(n), rad], axis=-1)
    return torch.from_numpy(out).to(device)


def _ggx_sample_h(xi: torch.Tensor, roughness: float) -> torch.Tensor:
    """Importance-sample the GGX NDF around +z: xi (..., 2) -> (..., 3)."""
    a = roughness * roughness
    phi = 2.0 * math.pi * xi[..., 0]
    cos_t = torch.sqrt((1.0 - xi[..., 1])
                       / (1.0 + (a * a - 1.0) * xi[..., 1] + 1e-12))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def specular_cubemap(cube: torch.Tensor, roughness: float,
                     num_samples: int = 256, chunk: int = 32) -> torch.Tensor:
    """GGX-prefiltered cubemap at `roughness` (N = V = R), by filtered
    importance sampling, `chunk` samples at a time.  Same resolution."""
    _, r, _, c = cube.shape
    dev = cube.device
    chunk = min(chunk, num_samples)
    num_samples = (num_samples // chunk) * chunk
    n_dirs = all_face_dirs(r, dev)
    up = torch.where(n_dirs[..., 2:3].abs() < 0.999,
                     torch.tensor([0.0, 0.0, 1.0], device=dev),
                     torch.tensor([1.0, 0.0, 0.0], device=dev))
    t = torch.cross(up, n_dirs, dim=-1)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-8)
    b = torch.cross(n_dirs, t, dim=-1)
    hs = _ggx_sample_h(_hammersley(num_samples, dev), roughness)
    acc = torch.zeros((6, r, r, c), device=dev)
    wsum = torch.zeros((6, r, r), device=dev)
    v = n_dirs[..., None, :]
    for hc in hs.reshape(-1, chunk, 3):
        h = (t[..., None, :] * hc[:, 0, None]
             + b[..., None, :] * hc[:, 1, None]
             + v * hc[:, 2, None])                       # (6,R,R,S',3)
        l = 2.0 * torch.sum(v * h, -1, keepdim=True) * h - v
        ndotl = torch.clamp(torch.sum(v * l, -1), min=0.0)
        col = sample_cubemap(cube, l)
        acc = acc + torch.sum(col * ndotl[..., None], dim=-2)
        wsum = wsum + torch.sum(ndotl, dim=-1)
        del h, l, col
    return acc / torch.clamp(wsum[..., None], min=1e-6)


def build_env_mips(base_cube: torch.Tensor, min_res: int = 16,
                   min_roughness: float = 0.08, max_roughness: float = 0.5,
                   num_samples: int = 256
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Specular mip chain and diffuse map of a base cube: level l of L is
    prefiltered at roughness min_r + (max_r - min_r) * l / (L - 1); the
    diffuse map is taken from the coarsest mip.  Returns (specular mips,
    diffuse (6, m, m, C))."""
    mips = [base_cube]
    while mips[-1].shape[1] > min_res:
        mips.append(downsample_cubemap(mips[-1]))
    n = len(mips)
    spec = []
    for l, m in enumerate(mips):
        rough = min_roughness + (max_roughness - min_roughness) * (
            l / max(n - 1, 1))
        spec.append(specular_cubemap(m, float(rough),
                                     num_samples=num_samples))
    return spec, diffuse_cubemap(mips[-1])
