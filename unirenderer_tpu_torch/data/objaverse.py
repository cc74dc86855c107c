"""Objaverse-style dataset and the render collate (counterpart of
`unirenderer_tpu/data/objaverse.py`).

The host side stays numpy (mesh loading and padding, camera and material
sampling with `random.Random(seed)`, env selection); `collate_render`
then renders the whole batch on the device in one `render_mesh` call (one
rasterizer launch for all views) and assembles the 8 training maps in
[-1, 1].  A missing or unreadable mesh resamples another index.
"""

from __future__ import annotations

import functools
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unirenderer_tpu_torch.core.config import DataConfig
from unirenderer_tpu_torch.ops import texture as tex
from unirenderer_tpu_torch.ops.cubemap import cubemap_to_latlong
from unirenderer_tpu_torch.ops.rasterize import ssaa_downsample
from unirenderer_tpu_torch.render import camera as cam
from unirenderer_tpu_torch.render.light import EnvLight
from unirenderer_tpu_torch.render.mesh import Mesh
from unirenderer_tpu_torch.render.render import (
    composite_background, render_mesh,
)


def material_grid(n: int = 11) -> List[Tuple[float, float]]:
    """The n x n (metallic, roughness) grid."""
    vals = np.linspace(0.0, 1.0, n)
    return [(float(m), float(r)) for m in vals for r in vals]


def _resize_bilinear(img: np.ndarray, r: int) -> np.ndarray:
    """Host-side bilinear resize of an (H, W, 3) float image to (r, r, 3)."""
    h, w = img.shape[:2]
    yi = np.linspace(0, h - 1, r)
    xi = np.linspace(0, w - 1, r)
    y0 = np.clip(yi.astype(int), 0, h - 2)
    x0 = np.clip(xi.astype(int), 0, w - 2)
    fy = (yi - y0)[:, None, None]
    fx = (xi - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x0 + 1]
    c = img[y0 + 1][:, x0]
    d = img[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx).astype(np.float32)


def load_mesh_npz(path: str) -> Dict[str, np.ndarray]:
    """Load a preprocessed mesh (.npz)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def pad_mesh(m: Dict[str, np.ndarray], v_pad: int, t_pad: int
             ) -> Dict[str, np.ndarray]:
    """Pad to static (v_pad, t_pad) sizes; padding triangles are
    degenerate (all-zero indices), so the rasterizer ignores them."""
    out = dict(m)
    v = m["v_pos"].shape[0]
    t = m["t_idx"].shape[0]
    if v > v_pad or t > t_pad:
        raise ValueError(f"mesh exceeds pad sizes: V={v}>{v_pad} or "
                         f"T={t}>{t_pad}")
    for k in ("v_pos", "v_nrm", "v_tex", "v_tng"):
        if k in out:
            pad = np.zeros((v_pad - v,) + out[k].shape[1:], out[k].dtype)
            out[k] = np.concatenate([out[k], pad])
    out["t_idx"] = np.concatenate(
        [m["t_idx"], np.zeros((t_pad - t, 3), np.int32)])
    return out


class ObjaverseData:
    """Train split: a preprocessed mesh (.npz), a random prefiltered env
    dir, (metallic, roughness) from the grid and a camera pose (pinned at
    az = 0, el = 90 unless `cfg.random_camera` or test mode)."""

    def __init__(self, cfg: DataConfig, mesh_paths: Sequence[str],
                 env_dirs: Sequence[str], seed: int = 0,
                 v_pad: Optional[int] = None, t_pad: Optional[int] = None,
                 test_mode: bool = False):
        self.cfg = cfg
        self.mesh_paths = list(mesh_paths)
        self.env_dirs = list(env_dirs)
        self.rng = random.Random(seed)
        self.grid = material_grid(cfg.material_grid)
        self.v_pad = v_pad if v_pad is not None else cfg.v_pad
        self.t_pad = t_pad if t_pad is not None else cfg.t_pad
        self.test_mode = test_mode
        self._env_cache: Dict[str, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return len(self.mesh_paths)

    def _load_env(self, d: str) -> Dict[str, np.ndarray]:
        if d not in self._env_cache:
            files = {}
            i = 0
            while os.path.exists(os.path.join(d, f"specular_{i}.npy")):
                files[f"specular_{i}"] = np.load(
                    os.path.join(d, f"specular_{i}.npy"))
                i += 1
            files["diffuse"] = np.load(os.path.join(d, "diffuse.npy"))
            if i == 0:
                raise FileNotFoundError(f"no specular mips in {d}")
            self._env_cache[d] = files
        return self._env_cache[d]

    def __getitem__(self, idx: int) -> Dict:
        for _attempt in range(64):
            try:
                return self._get(idx)
            except (FileNotFoundError, ValueError, OSError):
                idx = self.rng.randrange(len(self.mesh_paths))
        raise RuntimeError("too many unreadable samples")

    def _load_kd_texture(self, mesh: Dict, mesh_path: str) -> np.ndarray:
        """(R, R, 3) linear-space albedo texture: an embedded `kd_tex`, the
        mesh's map_Kd image (sRGB, converted to linear) or the constant kd
        colour tiled."""
        r = self.cfg.texture_res
        if "kd_tex" in mesh:
            t = np.asarray(mesh["kd_tex"], np.float32)
            if t.shape[0] != r or t.shape[1] != r:
                t = _resize_bilinear(t, r)
            return t
        path = str(mesh.get("kd_map", ""))
        if path and not os.path.isabs(path):
            path = os.path.join(os.path.dirname(mesh_path), path)
        if path and os.path.exists(path):
            from PIL import Image
            img = np.asarray(Image.open(path).convert("RGB").resize(
                (r, r), Image.BILINEAR), np.float32) / 255.0
            lin = np.where(img > 0.04045,
                           ((img + 0.055) / 1.055) ** 2.4, img / 12.92)
            return lin.astype(np.float32)
        kd = np.asarray(mesh.get("kd",
                                 np.array([0.8, 0.8, 0.8], np.float32)))
        return np.broadcast_to(kd.astype(np.float32), (r, r, 3)).copy()

    def _get(self, idx: int) -> Dict:
        raw = load_mesh_npz(self.mesh_paths[idx])
        kd_tex = self._load_kd_texture(raw, self.mesh_paths[idx])
        mesh = pad_mesh(raw, self.v_pad, self.t_pad)
        mesh["kd_tex"] = kd_tex
        env_dir = self.rng.choice(self.env_dirs)
        env = self._load_env(env_dir)
        metallic, roughness = self.rng.choice(self.grid)
        if self.cfg.random_camera or self.test_mode:
            az = self.rng.uniform(0, 360)
            el = self.rng.uniform(30, 150)
        else:
            az, el = 0.0, 90.0                      # the train split's pin
        return dict(mesh=mesh, env=env, metallic=metallic,
                    roughness=roughness, azimuth=az, elevation=el,
                    distance=self.cfg.camera_distance)


class ObjaverseDataTest(ObjaverseData):
    """Test split: random cameras."""

    def __init__(self, *a, **kw):
        kw["test_mode"] = True
        super().__init__(*a, **kw)


# ---------------------------------------------------------------------------
# Collate: batch -> rendered training maps on the device
# ---------------------------------------------------------------------------


def stack_scene(items: List[Dict]) -> Dict[str, np.ndarray]:
    """Host side of the collate: stack the raw scene arrays of a batch (no
    rendering).  Keys: v_pos / t_idx / v_nrm / v_tng / v_tex (padded
    mesh), mvps / camposes / nrots (camera), spec_0 .. spec_{n-1} /
    diffuse (env mips), metallics / roughnesses, kds (albedo textures)."""
    def stack(key):
        return np.stack([np.asarray(i["mesh"][key]) for i in items])

    scene = {"v_pos": stack("v_pos"), "t_idx": stack("t_idx"),
             "v_nrm": stack("v_nrm"), "v_tng": stack("v_tng"),
             "v_tex": stack("v_tex"), "kds": stack("kd_tex")}
    mvps, camposes, nrots = [], [], []
    for i in items:
        mvp, cp = cam.spherical_camera(i["azimuth"], i["elevation"],
                                       i["distance"])
        mvps.append(mvp.numpy())
        camposes.append(cp.numpy())
        nrots.append(cam.canonical_normal_rotation(
            i["azimuth"], i["elevation"]).numpy())
    scene["mvps"] = np.stack(mvps)
    scene["camposes"] = np.stack(camposes)
    scene["nrots"] = np.stack(nrots)
    n_mips = len([k for k in items[0]["env"] if k.startswith("specular")])
    for l in range(n_mips):
        scene[f"spec_{l}"] = np.stack(
            [np.asarray(i["env"][f"specular_{l}"]) for i in items])
    scene["diffuse"] = np.stack(
        [np.asarray(i["env"]["diffuse"]) for i in items])
    scene["metallics"] = np.asarray([i["metallic"] for i in items],
                                    np.float32)
    scene["roughnesses"] = np.asarray([i["roughness"] for i in items],
                                      np.float32)
    return scene


@functools.lru_cache(maxsize=None)
def _fg_table(device: torch.device) -> torch.Tensor:
    """The FG table (res, res, 2) on `device`, uploaded once per device
    (read-only: `render_mesh` only samples it)."""
    return tex.fg_lut()[0].to(device)


def collate_from_scene(scene: Dict[str, torch.Tensor], resolution: int,
                       ssaa: int = 2, bg: float = 1.0
                       ) -> Dict[str, torch.Tensor]:
    """Render a stacked scene (tensors on one device) at `resolution` x
    `ssaa` and assemble the training maps: composite over `bg`, SSAA
    average-pool, map to [-1, 1]; the masked [m, m, r] material image; the
    canonical-frame normal map; the env image (the diffuse cube as a
    latlong)."""
    n_mips = len([k for k in scene if k.startswith("spec_")])
    dev = scene["v_pos"].device
    t_idx = scene["t_idx"]
    mesh = Mesh(v_pos=scene["v_pos"], t_pos_idx=t_idx,
                v_nrm=scene["v_nrm"], t_nrm_idx=t_idx,
                v_tng=scene["v_tng"], t_tng_idx=t_idx,
                v_tex=scene["v_tex"], t_tex_idx=t_idx)
    env = EnvLight(specular=tuple(scene[f"spec_{l}"] for l in range(n_mips)),
                   diffuse=scene["diffuse"])
    metallics, roughnesses = scene["metallics"], scene["roughnesses"]
    bufs = render_mesh(mesh, scene["mvps"], scene["camposes"], env,
                       metallics, roughnesses, resolution * ssaa,
                       kd_texture=scene["kds"], fg_lut=_fg_table(dev))

    def down(x):
        return ssaa_downsample(x, ssaa) if ssaa > 1 else x

    def to_train(x4):                      # composite, downsample, [-1, 1]
        return down(composite_background(x4, bg)) * 2.0 - 1.0

    mask = down(bufs["mask"])              # fractional coverage at edges
    met_img = metallics[:, None, None, None] * mask
    rgh_img = roughnesses[:, None, None, None] * mask
    material = torch.cat([met_img, met_img, rgh_img], -1) * 2 - 1
    env_img = cubemap_to_latlong(scene["diffuse"], (resolution, resolution))
    env_img = torch.clamp(env_img, 0.0, 1.0) * 2 - 1
    normal = torch.einsum("bij,bhwj->bhwi", scene["nrots"],
                          bufs["gb_normal"][..., :3]) * bufs["mask"]
    return {
        "image": to_train(bufs["shaded"]),
        "mask": mask.expand(mask.shape[:-1] + (3,)) * 2 - 1,
        "material": material,
        "normal": down(normal),                          # already [-1, 1]
        "albedo": to_train(bufs["albedo"]),
        "spec_light": to_train(bufs["spec_light"]),
        "diff_light": to_train(bufs["diff_light"]),
        "env": env_img,
        "metallic": metallics,
        "roughness": roughnesses,
    }


def collate_render(items: List[Dict], resolution: int = 512,
                   bg: float = 1.0, ssaa: int = 2,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Render a batch of dataset items on `device` and return the 8
    training maps (B, resolution, resolution, 3) in [-1, 1] plus the
    'metallic' / 'roughness' scalars (B,).  Geometry buffers are rendered
    at `ssaa` x the resolution and average-pooled (antialiasing; ssaa=1
    disables)."""
    scene = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in stack_scene(items).items()}
    return collate_from_scene(scene, resolution, ssaa=ssaa, bg=bg)
