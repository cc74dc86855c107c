"""Material container (counterpart of `unirenderer_tpu/render/material.py`):
kd is a constant colour (3,) or a texture (H, W, 3|4); metallic and
roughness are per-object constants.  A dataclass of tensors."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from unirenderer_tpu_torch.data.obj_io import parse_mtl
from unirenderer_tpu_torch.ops.texture import sample_texture2d


def _scalar(value: float):
    return dataclasses.field(
        default_factory=lambda: torch.tensor(value, dtype=torch.float32))


@dataclasses.dataclass
class Material:
    kd: torch.Tensor                    # (3,) constant or (H, W, 3|4)
    metallic: torch.Tensor = _scalar(0.0)
    roughness: torch.Tensor = _scalar(0.5)

    @property
    def has_texture(self) -> bool:
        return self.kd.dim() == 3

    @classmethod
    def from_mtl(cls, path: str, name: Optional[str] = None,
                 device="cuda") -> "Material":
        """The first (or the named) material of an .mtl file on `device`:
        its map_Kd image in [0, 1] (RGB, as stored: no sRGB decoding) when
        it has one that Pillow reads, else its Kd colour; 0.8 grey when
        the file has no material."""
        mats = parse_mtl(path)
        if not mats:
            return cls(kd=torch.full((3,), 0.8, device=device))
        m = mats[name] if name else next(iter(mats.values()))
        kd = m["kd"]
        if "map_kd" in m:
            from PIL import Image
            try:
                with Image.open(m["map_kd"]) as img:
                    kd = np.asarray(img.convert("RGB"), np.float32) / 255.0
            except OSError:
                pass                    # unreadable texture: the Kd colour
        return cls(kd=torch.from_numpy(np.ascontiguousarray(kd)).to(device))

    def sample_kd(self, uv: torch.Tensor) -> torch.Tensor:
        """kd at texcoords uv (..., 2): the texture sampled bilinearly with
        wrap, or the constant broadcast."""
        if self.has_texture:
            return sample_texture2d(self.kd, uv, wrap="wrap")
        return self.kd.expand(uv.shape[:-1] + (3,))
