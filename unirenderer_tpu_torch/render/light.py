"""Prefiltered split-sum environment light (counterpart of the parts of
`unirenderer_tpu/render/light.py` the renderer and data path use)."""

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
