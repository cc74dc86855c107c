"""Split-sum PBR mesh renderer (counterpart of
`unirenderer_tpu/render/render.py`), over a batch of views at once:

  clip transform (ops.transform.xfm_points)
  -> rasterize (ops.rasterize, K4 on the card), one launch for the batch
  -> attribute interpolation
  -> bent shading normal (ops.bsdf.prepare_shading_normal)
  -> split-sum shading (shade_with_env): diffuse cube lookup, FG table,
     roughness-indexed trilinear specular cube lookup, sRGB

Outputs the 8 buffers shaded / spec_light / diff_light / gb_normal /
normal / albedo (each with alpha), depth and mask.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from unirenderer_tpu_torch.ops import bsdf
from unirenderer_tpu_torch.ops import texture as tex
from unirenderer_tpu_torch.ops.cubemap import sample_cubemap, sample_cubemap_mip
from unirenderer_tpu_torch.ops.rasterize import interpolate, rasterize
from unirenderer_tpu_torch.ops.transform import xfm_points
from unirenderer_tpu_torch.render.light import EnvLight
from unirenderer_tpu_torch.render.mesh import Mesh


def rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(
        f > 0.0031308,
        1.055 * torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) - 0.055,
        12.92 * f)


def srgb_to_rgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(
        f > 0.04045,
        torch.pow((torch.clamp(f, min=0.04045) + 0.055) / 1.055, 2.4),
        f / 12.92)


def get_mip(roughness: torch.Tensor, num_mips: int) -> torch.Tensor:
    """Roughness -> fractional specular mip level."""
    return torch.where(
        roughness < 1.0,
        (torch.clamp(roughness, 0.04, 1.0) - 0.04) / (1.0 - 0.04)
        * (num_mips - 2),
        torch.full_like(roughness, num_mips - 2.0))


def shade_with_env(gb_pos: torch.Tensor, gb_normal: torch.Tensor,
                   kd: torch.Tensor, view_pos: torch.Tensor, env: EnvLight,
                   metallic: torch.Tensor, roughness: torch.Tensor,
                   fg_lut: torch.Tensor):
    """Split-sum shading.  gb_pos / gb_normal / kd (B, H, W, 3); view_pos
    broadcastable to them; env batched (B, 6, R, R, 3); metallic and
    roughness (B, H, W, 1); fg_lut (res, res, 2).  Returns (shaded,
    spec_light, diff_light), each (B, H, W, 3), sRGB in [0, 1]."""
    wo = bsdf.safe_normalize(view_pos - gb_pos)
    spec_col = (1.0 - metallic) * 0.04 + kd * metallic
    diff_col = kd * (1.0 - metallic)
    nrm = gb_normal
    refl = bsdf.safe_normalize(bsdf.reflect(wo, nrm))

    diffuse = sample_cubemap(env.diffuse, nrm)
    diffuse_comp = diffuse * diff_col

    n_dot_v = torch.clamp(bsdf.dot(wo, nrm), min=1e-4)
    fg_uv = torch.cat([n_dot_v, roughness], dim=-1)
    fg = tex.sample_texture2d(fg_lut, fg_uv, wrap="clamp")

    mip = get_mip(roughness[..., 0], env.num_mips)
    spec = sample_cubemap_mip(list(env.specular), refl, mip)

    reflectance = spec_col * fg[..., 0:1] + fg[..., 1:2]
    shaded = spec * reflectance + diffuse_comp

    shaded = torch.clamp(rgb_to_srgb(shaded), 0.0, 1.0)
    spec_light = torch.clamp(rgb_to_srgb(spec), 0.0, 1.0)
    diff_light = torch.clamp(rgb_to_srgb(diffuse), 0.0, 1.0)
    return shaded, spec_light, diff_light


def _per_triangle(v: torch.Tensor, tri: torch.Tensor, k: int) -> torch.Tensor:
    """(B, V, C) vertex values at corner k of each (B, T, 3) triangle."""
    idx = tri[..., k].long()[..., None].expand(-1, -1, v.shape[-1])
    return torch.gather(v, 1, idx)


def render_mesh(mesh: Mesh, mvp: torch.Tensor, campos: torch.Tensor,
                env: EnvLight, metallic: torch.Tensor,
                roughness: torch.Tensor, resolution: int,
                kd_texture: Optional[torch.Tensor] = None,
                kd_const: Optional[torch.Tensor] = None, chunk: int = 256,
                fg_lut: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Render a batch of B views, one depth layer.

    mesh: tensors with a leading B (v_pos (B, V, 3), t_pos_idx (B, T, 3),
    v_nrm / v_tng (B, V, 3), v_tex (B, V, 2); every index buffer is taken
    to be t_pos_idx); mvp (B, 4, 4); campos (B, 3); env batched;
    metallic / roughness (B,), constant per object; kd from a texture
    (B, R, R, 3 or 4) or a constant colour (B, 3).  Returns (B, H, W, C)
    buffers."""
    v_pos = mesh.v_pos
    tri = mesh.t_pos_idx
    nb = v_pos.shape[0]
    dev = v_pos.device
    if fg_lut is None:
        fg_lut = tex.fg_lut()[0].to(dev)

    pos_clip = xfm_points(v_pos, mvp)
    rast = rasterize(pos_clip, tri, resolution, resolution, chunk)
    mask = (rast.tri_id > 0)[..., None].float()

    gb_pos, _ = interpolate(v_pos, rast, tri)
    # normals and tangents are interpolated with the position topology
    # (preprocessed meshes share one index buffer)
    v_nrm = mesh.v_nrm if mesh.v_nrm is not None else v_pos
    gb_normal_sm, _ = interpolate(v_nrm, rast, tri)
    v_tng = mesh.v_tng if mesh.v_tng is not None else v_pos
    gb_tangent, _ = interpolate(v_tng, rast, tri)

    # geometric (face) normal
    p0, p1, p2 = (_per_triangle(v_pos, tri, k) for k in range(3))
    face_nrm = bsdf.safe_normalize(torch.cross(p1 - p0, p2 - p0, dim=-1))
    t = tri.shape[1]
    tid = torch.clamp(rast.tri_id.long() - 1, min=0)
    tid = tid + (torch.arange(nb, device=dev) * t)[:, None, None]
    gb_geom_nrm = face_nrm.reshape(nb * t, 3)[tid]

    # albedo
    if kd_texture is not None:
        # trilinear mip sampling with the level from screen-space UV
        # derivatives
        gb_texc, texc_mask = interpolate(mesh.v_tex, rast, tri)
        mips = tex.build_texture_mips(kd_texture)
        uv_dr = tex.screen_uv_derivs(gb_texc, wrap=True) * texc_mask
        kd = tex.sample_texture2d_mip(mips, gb_texc, uv_deriv=uv_dr,
                                      wrap="wrap")
    elif kd_const is not None:
        kd = kd_const[:, None, None, :].expand(gb_pos.shape[:-1]
                                               + kd_const.shape[-1:])
    else:
        kd = torch.full_like(gb_pos, 0.8)
    alpha = kd[..., 3:4] if kd.shape[-1] == 4 else mask
    kd = torch.clamp(kd[..., :3], 0.0, 1.0)

    view = campos[:, None, None, :]
    gb_normal = bsdf.prepare_shading_normal(
        gb_pos, view, None, gb_normal_sm, gb_tangent, gb_geom_nrm,
        two_sided_shading=True, opengl=True)

    shape = (nb, resolution, resolution, 1)
    met = metallic.reshape(nb, 1, 1, 1).float().expand(shape)
    rough = roughness.reshape(nb, 1, 1, 1).float().expand(shape)
    shaded, spec_light, diff_light = shade_with_env(
        gb_pos, gb_normal, kd, view, env, met, rough, fg_lut)

    alpha = alpha * mask
    return {
        "shaded": torch.cat([shaded, alpha], -1),
        "spec_light": torch.cat([spec_light, alpha], -1),
        "diff_light": torch.cat([diff_light, alpha], -1),
        "gb_normal": torch.cat([gb_normal, alpha], -1),
        "normal": torch.cat([gb_normal_sm, alpha], -1),
        "albedo": torch.cat([kd, alpha], -1),
        "depth": rast.z[..., None],
        "mask": mask,
    }


def composite_background(buffer: torch.Tensor, bg_value: float = 1.0
                         ) -> torch.Tensor:
    """Alpha-composite a (..., 4) buffer over a constant background."""
    rgb, a = buffer[..., :3], buffer[..., 3:4]
    return rgb * a + bg_value * (1.0 - a)
