"""The scene bank: every mesh, albedo texture and env of a synthetic set
stacked into tensors that live on the device, and fresh random scenes
drawn from it every step (counterpart of
`unirenderer_tpu/data/scene_bank.py`).

A fixed pool of pre-rendered batches overfits (the image stream memorises
it); drawing new scenes from the bank every step, with augmentations,
gives an unbounded stream at no per-step upload.  Bank layout:

    v_pos / v_nrm / v_tng (M, V, 3) f32, v_tex (M, V, 2), t_idx (M, T, 3)
    int32, kds (M, R, R, 3), spec_0 .. spec_{L-1} (E, 6, r_l, r_l, 3),
    diffuse (E, 6, rd, rd, 3)

Meshes are padded to the set's largest (V, T), rounded up to 128 (the JAX
package's rule, kept: it sets the padded T and so the rasterizer's work);
padding triangles are degenerate and cover nothing.

Sampling is split as the train step's draws are: `draw_scenes` takes
every random number of a batch of scenes from a host `torch.Generator`
(mesh and env indices, the material grid, camera azimuth and elevation,
and the augmentations' scale, channel permutation, gain, env intensity
and tint, rotation quaternions), and `scenes_from_draws` builds the
scenes from them deterministically, as tensor operations on the bank's
device.  Its output is `data/objaverse.stack_scene`'s layout, so it
feeds `collate_from_scene` unchanged.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from unirenderer_tpu_torch.core.config import DataConfig

BANK_MESH_KEYS = ("v_pos", "v_nrm", "v_tng", "v_tex", "t_idx")

# the 6 channel permutations of an RGB albedo texture
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`; a host tensor goes to the card through pinned
    memory without blocking (a pageable copy would wait for the card's
    queue to drain: one host sync per small tensor)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _round_up(n: int, m: int = 128) -> int:
    return n + (-n) % m


def stack_bank(meshes: Sequence[Mapping[str, np.ndarray]],
               kds: Sequence[np.ndarray],
               envs: Sequence[Mapping[str, np.ndarray]]
               ) -> Dict[str, np.ndarray]:
    """Stack unpadded meshes ({v_pos, v_nrm, v_tng, v_tex, t_idx}), their
    (R, R, 3) albedo textures and envs ({specular_l, diffuse}) into a bank,
    the meshes padded to the largest (V, T) rounded up to 128."""
    from unirenderer_tpu_torch.data.objaverse import pad_mesh
    v_pad = _round_up(max(m["v_pos"].shape[0] for m in meshes))
    t_pad = _round_up(max(m["t_idx"].shape[0] for m in meshes))
    padded = [pad_mesh(dict(m), v_pad, t_pad) for m in meshes]
    bank = {k: np.stack([np.asarray(m[k]) for m in padded])
            for k in BANK_MESH_KEYS}
    bank["kds"] = np.stack([np.asarray(k, np.float32) for k in kds])
    n_mips = len([k for k in envs[0] if k.startswith("specular_")])
    for l in range(n_mips):
        bank[f"spec_{l}"] = np.stack([np.asarray(e[f"specular_{l}"])
                                      for e in envs])
    bank["diffuse"] = np.stack([np.asarray(e["diffuse"]) for e in envs])
    return bank


def load_scene_bank(mesh_dir: str, env_dir: str, cfg: DataConfig,
                    max_meshes: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
    """Every preprocessed mesh (`<mesh_dir>/*.npz`, sorted) and env mip
    directory (`<env_dir>/*/`, sorted) as one bank of numpy arrays."""
    from unirenderer_tpu_torch.data.objaverse import (
        ObjaverseData, load_mesh_npz,
    )
    paths = sorted(glob.glob(os.path.join(mesh_dir, "*.npz")))
    if max_meshes:
        paths = paths[:max_meshes]
    if not paths:
        raise FileNotFoundError(f"no meshes under {mesh_dir}")
    env_dirs = sorted(d for d in glob.glob(os.path.join(env_dir, "*"))
                      if os.path.isdir(d))
    if not env_dirs:
        raise FileNotFoundError(f"no env dirs under {env_dir}")
    helper = ObjaverseData(cfg, paths, env_dirs)    # texture and env loader
    raws = [load_mesh_npz(p) for p in paths]
    kds = [helper._load_kd_texture(r, p) for r, p in zip(raws, paths)]
    meshes = [{k: r[k] for k in BANK_MESH_KEYS} for r in raws]
    return stack_bank(meshes, kds, [helper._load_env(d) for d in env_dirs])


def synthetic_bank(cfg: DataConfig, n_mesh: int = 3, n_env: int = 2,
                   v_pad: int = 1024, t_pad: int = 2048,
                   env_res: int = 8) -> Dict[str, np.ndarray]:
    """A tiny in-memory bank (scaled spheres, constant envs) for tests and
    smoke runs: no data files."""
    from unirenderer_tpu_torch.data.objaverse import pad_mesh
    from unirenderer_tpu_torch.render.mesh import make_sphere
    prng = np.random.default_rng(0)
    sphere = make_sphere(8)
    base = {"v_pos": np.asarray(sphere.v_pos),
            "t_idx": np.asarray(sphere.t_pos_idx),
            "v_nrm": np.asarray(sphere.v_nrm),
            "v_tex": np.asarray(sphere.v_tex),
            "v_tng": np.asarray(sphere.v_tng)}
    meshes, kds = [], []
    for i in range(n_mesh):
        m = dict(base)
        m["v_pos"] = base["v_pos"] * prng.uniform(0.7, 1.0)
        meshes.append(pad_mesh(m, v_pad, t_pad))
        kds.append(np.full((cfg.texture_res, cfg.texture_res, 3),
                           0.3 + 0.1 * i, np.float32))
    bank = {k: np.stack([m[k] for m in meshes]) for k in BANK_MESH_KEYS}
    bank["kds"] = np.stack(kds)
    for l, r in enumerate((env_res, env_res // 2)):
        bank[f"spec_{l}"] = np.stack(
            [np.full((6, r, r, 3), 0.7 - 0.2 * e, np.float32)
             for e in range(n_env)])
    bank["diffuse"] = np.stack(
        [np.full((6, env_res // 2, env_res // 2, 3), 0.4, np.float32)
         for _ in range(n_env)])
    return bank


def bank_to_device(bank: Mapping[str, np.ndarray],
                   device) -> Dict[str, torch.Tensor]:
    """The bank's arrays as tensors on `device`, uploaded once (a
    blocking copy)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in bank.items()}


def bank_sizes(bank: Mapping) -> Tuple[int, int]:
    """(meshes, envs) of a bank."""
    return int(bank["v_pos"].shape[0]), int(bank["diffuse"].shape[0])


def bank_bytes(bank: Mapping) -> int:
    return int(sum(v.numel() * v.element_size() if isinstance(
        v, torch.Tensor) else v.nbytes for v in bank.values()))


@dataclasses.dataclass
class SceneDraws:
    """Every random number of one batch of scenes (the JAX sampler's
    `split(rng, 12)`, key by key): mesh and env indices, material grid
    indices, camera azimuth and elevation in degrees, and the
    augmentations' anisotropic scale, rotation quaternion (unnormalised
    gaussian), albedo channel permutation index and gain, and env
    intensity and tint."""
    midx: torch.Tensor          # (B,) int64                   key 0
    eidx: torch.Tensor          # (B,)                         key 1
    metallic: torch.Tensor      # (B,) grid index              key 2
    roughness: torch.Tensor     # (B,) grid index              key 3
    az: torch.Tensor            # (B,) U(0, 360)               key 4
    el: torch.Tensor            # (B,) U(30, 150)              key 5
    scale: torch.Tensor         # (B, 1, 3) U(0.7, 1.1)        key 6
    perm: torch.Tensor          # (B,) in [0, 6)               key 7
    gain: torch.Tensor          # (B, 1, 1, 3) U(0.55, 1.0)    key 8
    intensity: torch.Tensor     # (B, 1, 1, 1, 1) U(0.6, 1.4)  key 9
    tint: torch.Tensor          # (B, 1, 1, 1, 3) U(0.8, 1.25) key 10
    quat: torch.Tensor          # (B, 4) N(0, 1)               key 11

    def to(self, device) -> "SceneDraws":
        return SceneDraws(**{f.name: host_to_device(getattr(self, f.name),
                                                    device)
                             for f in dataclasses.fields(self)})


def draw_scenes(generator: torch.Generator, sizes: Tuple[int, int],
                batch: int, cfg: DataConfig) -> SceneDraws:
    """The random numbers of `batch` scenes from a bank of `sizes`
    (meshes, envs), drawn on the host in the order of the JAX sampler's
    keys."""
    n_mesh, n_env = sizes
    g = cfg.material_grid

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    def index(n):
        return torch.randint(0, n, (batch,), generator=generator)

    return SceneDraws(
        midx=index(n_mesh), eidx=index(n_env), metallic=index(g),
        roughness=index(g), az=uniform((batch,), 0.0, 360.0),
        el=uniform((batch,), 30.0, 150.0),
        scale=uniform((batch, 1, 3), 0.7, 1.1), perm=index(len(PERMS)),
        gain=uniform((batch, 1, 1, 3), 0.55, 1.0),
        intensity=uniform((batch, 1, 1, 1, 1), 0.6, 1.4),
        tint=uniform((batch, 1, 1, 1, 3), 0.8, 1.25),
        quat=torch.randn((batch, 4), generator=generator))


def _renorm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                    keepdim=True), min=1e-8)


def quaternion_rotations(q: torch.Tensor) -> torch.Tensor:
    """(B, 4) gaussian quaternions -> (B, 3, 3) rotations, uniform over
    SO(3) (normalised, then Shoemake's matrix)."""
    q = _renorm(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=1)


def _lookat_origin(eye: torch.Tensor) -> torch.Tensor:
    """(B, 3) eyes -> (B, 4, 4) view matrices looking at the origin with
    +y up (`render/camera.lookat`, batched)."""
    up = host_to_device(torch.tensor([0.0, 1.0, 0.0]),
                        eye.device).expand_as(eye)
    f = -eye
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    r = torch.linalg.cross(f, up)
    r = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    u = torch.linalg.cross(r, f)

    def dot(a, b):
        return (a * b).sum(-1, keepdim=True)

    bottom = host_to_device(torch.tensor([0.0, 0.0, 0.0, 1.0]),
                            eye.device).expand(eye.shape[0], 4)
    return torch.stack([torch.cat([r, -dot(r, eye)], -1),
                        torch.cat([u, -dot(u, eye)], -1),
                        torch.cat([-f, dot(f, eye)], -1), bottom], dim=1)


def _eye_dirs(az_deg: torch.Tensor, el_deg: torch.Tensor) -> torch.Tensor:
    az, el = torch.deg2rad(az_deg), torch.deg2rad(el_deg)
    return torch.stack([torch.sin(el) * torch.cos(az), torch.cos(el),
                        torch.sin(el) * torch.sin(az)], -1)


def spherical_cameras(az_deg: torch.Tensor, el_deg: torch.Tensor,
                      distance: float, fovy_deg: float = 30.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`render/camera.spherical_camera` and `canonical_normal_rotation`
    over a batch of poses, on the poses' device -> (mvps (B, 4, 4),
    camposes (B, 3), nrots (B, 3, 3))."""
    from unirenderer_tpu_torch.render import camera as cam
    dev = az_deg.device
    dirs = _eye_dirs(az_deg, el_deg)
    eye = distance * dirs
    proj = host_to_device(cam.perspective(math.radians(fovy_deg)), dev)
    mvps = torch.matmul(proj, _lookat_origin(eye))
    r0 = host_to_device(cam.view_rotation(0.0, 90.0), dev)
    nrots = torch.matmul(r0.T, _lookat_origin(dirs)[:, :3, :3])
    return mvps, eye, nrots


def scenes_from_draws(bank: Mapping[str, torch.Tensor], draws: SceneDraws,
                      cfg: DataConfig, augment: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """A batch of scenes from the bank and the draws, on the bank's device
    (the draws are moved there): mesh and env gathered by index, the
    material from the grid, a spherical camera; with `augment` the
    anisotropic mesh scale (normals by the inverse transpose), with
    `cfg.rotation_augment` a random rotation of the object, the albedo's
    channel permutation and gain (clipped to [0, 1]), and the env's
    intensity and tint on every mip.  Deterministic given the draws."""
    dev = bank["v_pos"].device
    d = draws.to(dev)
    g = cfg.material_grid
    n_mips = len([k for k in bank if k.startswith("spec_")])
    v_pos = bank["v_pos"][d.midx]
    v_nrm = bank["v_nrm"][d.midx]
    v_tng = bank["v_tng"][d.midx]
    kd = bank["kds"][d.midx]
    spec = [bank[f"spec_{l}"][d.eidx] for l in range(n_mips)]
    diffuse = bank["diffuse"][d.eidx]
    if augment:
        v_pos = v_pos * d.scale
        v_nrm = _renorm(v_nrm / d.scale)
        v_tng = _renorm(v_tng * d.scale)
        if cfg.rotation_augment:
            rot = quaternion_rotations(d.quat)              # (B, 3, 3)
            v_pos = torch.einsum("bvc,bdc->bvd", v_pos, rot)
            v_nrm = torch.einsum("bvc,bdc->bvd", v_nrm, rot)
            v_tng = torch.einsum("bvc,bdc->bvd", v_tng, rot)
        perm = host_to_device(torch.tensor(PERMS), dev)[d.perm]  # (B, 3)
        kd = torch.gather(kd, -1, perm[:, None, None, :].expand_as(kd))
        kd = torch.clamp(kd * d.gain, 0.0, 1.0)
        spec = [m * d.intensity * d.tint for m in spec]
        diffuse = diffuse * d.intensity * d.tint
    scene = {"v_pos": v_pos, "v_nrm": v_nrm, "v_tng": v_tng,
             "v_tex": bank["v_tex"][d.midx], "t_idx": bank["t_idx"][d.midx],
             "kds": kd}
    for l, m in enumerate(spec):
        scene[f"spec_{l}"] = m
    scene["diffuse"] = diffuse
    scene["metallics"] = d.metallic.float() / (g - 1.0)
    scene["roughnesses"] = d.roughness.float() / (g - 1.0)
    scene["mvps"], scene["camposes"], scene["nrots"] = spherical_cameras(
        d.az.float(), d.el.float(), cfg.camera_distance)
    return scene
