"""Prefiltered split-sum environment light (counterpart of
`unirenderer_tpu/render/light.py`): the container, the latlong prefilter,
the spec/diff conditioning maps of a normal map (relighting) and the
random trainable cubemap base."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from unirenderer_tpu_torch.ops import cubemap as cm


@dataclasses.dataclass
class EnvLight:
    """GGX specular mip chain (descending R) and diffuse irradiance, each
    (6, R, R, 3), or (B, 6, R, R, 3) for a batch of views."""
    specular: Tuple[torch.Tensor, ...]
    diffuse: torch.Tensor

    @property
    def num_mips(self) -> int:
        return len(self.specular)


def env_from_latlong(latlong: torch.Tensor, res: int = 512,
                     min_res: int = 16, num_samples: int = 256) -> EnvLight:
    """HDR latlong (H, W, 3) -> prefiltered EnvLight, on its device."""
    base = cm.latlong_to_cubemap(latlong, res)
    spec, diff = cm.build_env_mips(base, min_res=min_res,
                                   num_samples=num_samples)
    return EnvLight(specular=tuple(spec), diffuse=diff)


def conditioning_light_maps(env: EnvLight, normal_img: torch.Tensor,
                            roughness, view_dir=(0.0, 0.0, 1.0)):
    """Split-sum spec/diff conditioning maps rebuilt from a normal map
    (B, H, W, 3) in [-1, 1], with a distant camera along `view_dir`:
    diffuse irradiance at the normal, the specular mip chain at the
    reflected view direction and the mip level of `roughness` (a scalar
    or (B,)) -> (spec_light, diff_light), sRGB in [0, 1]."""
    from unirenderer_tpu_torch.ops import bsdf
    from unirenderer_tpu_torch.render.render import get_mip, rgb_to_srgb

    nrm = bsdf.safe_normalize(normal_img)
    wo = torch.as_tensor(view_dir, dtype=normal_img.dtype,
                         device=normal_img.device)
    refl = bsdf.safe_normalize(bsdf.reflect(wo.expand(nrm.shape), nrm))
    diff = cm.sample_cubemap(env.diffuse, nrm)
    rough = torch.as_tensor(roughness, dtype=normal_img.dtype,
                            device=normal_img.device)
    rough = rough.reshape(rough.shape + (1,) * (nrm.dim() - 1 - rough.dim()))
    mip = get_mip(rough.expand(nrm.shape[:-1]), env.num_mips)
    spec = cm.sample_cubemap_mip(list(env.specular), refl, mip)
    return (torch.clamp(rgb_to_srgb(spec), 0.0, 1.0),
            torch.clamp(rgb_to_srgb(diff), 0.0, 1.0))


def trainable_env(generator: torch.Generator, base_res: int = 512,
                  scale: float = 0.5, bias: float = 0.25) -> torch.Tensor:
    """Random cubemap base (6, R, R, 3), uniform in [bias, bias + scale),
    drawn on the generator's device; prefilter it with
    `ops.cubemap.build_env_mips`."""
    return torch.rand((6, base_res, base_res, 3), generator=generator,
                      device=generator.device) * scale + bias
