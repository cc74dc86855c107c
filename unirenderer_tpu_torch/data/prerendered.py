"""Pre-rendered dataset loader (the port's numpy copy of
`unirenderer_tpu/data/prerendered.py`): Blender-rendered folders, one per
modality (rgba / metallic / roughness / normal / ... and an optional
fixed environment image), read with Pillow into numpy arrays in [-1, 1].
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """(H, W, C) float32 in [0, 1]."""
    from PIL import Image
    with Image.open(path) as img:
        if size is not None:
            img = img.resize((size, size), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


class PreRenderedDataset:
    """Folder-per-modality loader.

    Layout: root/<modality>/<frame>.png with a shared frame naming across
    modalities (the blendGen convention).  `fixed_env` optionally points at
    one environment image used for every sample (the reference's fixed env
    variants, blendGen.py:368 etc.).
    """

    MODALITIES = ("rgba", "metallic", "roughness", "normal", "albedo",
                  "spec_light", "diff_light", "mask")

    def __init__(self, root: str,
                 modalities: Sequence[str] = ("rgba", "metallic",
                                              "roughness", "normal"),
                 resolution: int = 512,
                 fixed_env: Optional[str] = None,
                 white_background: bool = True):
        self.root = root
        self.modalities = tuple(modalities)
        self.resolution = resolution
        self.white_background = white_background
        self.fixed_env = fixed_env
        base = os.path.join(root, self.modalities[0])
        self.frames: List[str] = sorted(
            os.path.splitext(f)[0] for f in os.listdir(base)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        self._env_cache: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.frames)

    def _frame_path(self, modality: str, frame: str) -> str:
        d = os.path.join(self.root, modality)
        for ext in (".png", ".jpg", ".jpeg", ".webp"):
            p = os.path.join(d, frame + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"{modality}/{frame}")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        frame = self.frames[idx]
        out: Dict[str, np.ndarray] = {}
        for m in self.modalities:
            img = _load_image(self._frame_path(m, frame), self.resolution)
            if m == "rgba" and img.shape[-1] == 4:
                rgb, a = img[..., :3], img[..., 3:4]
                if self.white_background:
                    rgb = rgb * a + (1.0 - a)     # composite to white
                out["image"] = rgb * 2 - 1
                out["mask"] = np.repeat(a, 3, -1) * 2 - 1
            else:
                if img.shape[-1] == 1:
                    img = np.repeat(img, 3, -1)
                out[m] = img[..., :3] * 2 - 1
        if self.fixed_env:
            if self._env_cache is None:
                self._env_cache = _load_image(self.fixed_env,
                                              self.resolution) * 2 - 1
            out["env"] = self._env_cache[..., :3]
        return out


def collate_prerendered(items: List[Dict[str, np.ndarray]]
                        ) -> Dict[str, np.ndarray]:
    keys = items[0].keys()
    return {k: np.stack([i[k] for i in items]) for k in keys}
