"""Synthetic preprocessed dataset: meshes and prefiltered envs in the
on-disk layout the data path reads (counterpart of
`tools/make_synthetic_data.py`, with the same numpy random call sequence,
so one seed gives the same meshes and textures; the env prefilter goes
through `ops/cubemap.py`).

  * geometry: sphere-topology meshes deformed by radial harmonic fields
    (bumps, lobes, creases), p-norm box/diamond shaping, superquadric
    exponents, anisotropic scale and twist; normals recomputed from the
    deformed surface (area-weighted).
  * albedo: procedural textures (checker, stripes, blob noise, gradients,
    dots, constant) embedded in the mesh .npz as `kd_tex`.
  * envs: 1-6 random directional lobes over an ambient or sky-gradient
    base, occasionally saturated colours.

Usage:
  python -m unirenderer_tpu_torch.data.synthetic --out DIR [--n-mesh 8] \
      [--n-env 4] [--env-res 64] [--env-min-res 8] [--tex-res 64] \
      [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from unirenderer_tpu_torch.ops.cubemap import (
    build_env_mips, latlong_to_cubemap,
)
from unirenderer_tpu_torch.render.mesh import (
    auto_normals, compute_tangents, make_sphere, unit_normalize_mesh,
)


# ---------------------------------------------------------------------------
# Geometry: deformed-sphere family (sphere topology, recomputed normals)
# ---------------------------------------------------------------------------


def _radial_field(d: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Smooth random radius multiplier r(d) >= 0.35 over unit directions."""
    r = np.ones(d.shape[0], np.float32)
    # cosine harmonics: r += a * cos(f * (d.axis) + phase)
    for _ in range(rng.integers(0, 4)):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        f = rng.uniform(1.5, 6.0)
        a = rng.uniform(0.03, 0.22)
        r += a * np.cos(f * (d @ axis) * np.pi + rng.uniform(0, 2 * np.pi))
    # localized bumps / dents
    for _ in range(rng.integers(0, 5)):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        sharp = rng.uniform(6.0, 40.0)
        a = rng.uniform(-0.25, 0.35)
        r += a * np.maximum(d @ axis, 0.0) ** sharp
    # crease: |d.axis|^p ridge (non-smooth normal signal)
    if rng.random() < 0.35:
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        r += rng.uniform(0.05, 0.2) * np.abs(d @ axis) ** rng.uniform(1, 3)
    return np.maximum(r, 0.35).astype(np.float32)


def make_shape(base_v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One random deformed-sphere body from the unit-sphere vertices."""
    d = base_v / np.maximum(np.linalg.norm(base_v, axis=-1, keepdims=True),
                            1e-8)
    v = d * _radial_field(d, rng)[:, None]

    style = rng.random()
    if style < 0.30:                      # p-norm shaping: box <- p>2, diamond <- p<2
        p = rng.uniform(1.3, 8.0)
        pn = (np.abs(d) ** p).sum(-1) ** (1.0 / p)
        v = v / np.maximum(pn, 1e-6)[:, None]
    elif style < 0.45:                    # superquadric exponent per axis
        e = rng.uniform(0.5, 1.6, size=3)
        v = np.sign(v) * np.abs(v) ** e

    v = v * rng.uniform(0.5, 1.0, size=3)           # anisotropic scale
    if rng.random() < 0.3:                          # twist around y
        ang = rng.uniform(-1.2, 1.2) * v[:, 1]
        c, s = np.cos(ang), np.sin(ang)
        x, z = v[:, 0].copy(), v[:, 2].copy()
        v[:, 0], v[:, 2] = c * x - s * z, s * x + c * z
    return v.astype(np.float32)


# ---------------------------------------------------------------------------
# Procedural albedo textures (linear space, embedded as kd_tex)
# ---------------------------------------------------------------------------


def _rand_color(rng, lo=0.05, hi=0.95):
    return rng.uniform(lo, hi, size=3).astype(np.float32)


def make_texture(res: int, rng: np.random.Generator) -> np.ndarray:
    u, v = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                       indexing="xy")
    c1, c2 = _rand_color(rng), _rand_color(rng)
    kind = rng.random()
    if kind < 0.18:                                   # constant
        tex = np.broadcast_to(c1, (res, res, 3)).copy()
    elif kind < 0.40:                                 # checker
        n = int(rng.integers(2, 9))
        m = ((u * n).astype(int) + (v * n).astype(int)) % 2
        tex = np.where(m[..., None] > 0, c1, c2)
    elif kind < 0.58:                                 # stripes
        n = rng.uniform(2, 12)
        ang = rng.uniform(0, np.pi)
        t = np.sin(2 * np.pi * n * (u * np.cos(ang) + v * np.sin(ang)))
        w = (t > rng.uniform(-0.5, 0.5)).astype(np.float32)
        tex = w[..., None] * c1 + (1 - w[..., None]) * c2
    elif kind < 0.80:                                 # blob noise (upsampled)
        k = int(rng.integers(3, 9))
        lo = rng.random((k, k, 3)).astype(np.float32)
        ui = np.clip((u * (k - 1)), 0, k - 1)
        vi = np.clip((v * (k - 1)), 0, k - 1)
        u0, v0 = ui.astype(int), vi.astype(int)
        u1, v1 = np.minimum(u0 + 1, k - 1), np.minimum(v0 + 1, k - 1)
        fu, fv = (ui - u0)[..., None], (vi - v0)[..., None]
        tex = (lo[v0, u0] * (1 - fu) * (1 - fv) + lo[v0, u1] * fu * (1 - fv)
               + lo[v1, u0] * (1 - fu) * fv + lo[v1, u1] * fu * fv)
        tex = c1 * tex + c2 * (1 - tex)
    elif kind < 0.92:                                 # gradient
        t = (u * rng.uniform(-1, 1) + v * rng.uniform(-1, 1))
        t = (t - t.min()) / max(float(np.ptp(t)), 1e-6)
        tex = t[..., None] * c1 + (1 - t[..., None]) * c2
    else:                                             # dots
        n = int(rng.integers(3, 8))
        fu = (u * n) % 1.0 - 0.5
        fv = (v * n) % 1.0 - 0.5
        m = (fu ** 2 + fv ** 2 < rng.uniform(0.04, 0.16)).astype(np.float32)
        tex = m[..., None] * c1 + (1 - m[..., None]) * c2
    return np.clip(tex, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Environments
# ---------------------------------------------------------------------------


def make_env_latlong(rng: np.random.Generator, h: int = 32,
                     w: int = 64) -> np.ndarray:
    th = np.linspace(0, np.pi, h)
    ph = np.linspace(-np.pi, np.pi, w)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    d = np.stack([np.sin(tt) * np.sin(pp), np.cos(tt),
                  -np.sin(tt) * np.cos(pp)], -1)
    if rng.random() < 0.5:                      # sky gradient base
        top = rng.uniform(0.2, 0.8, size=3)
        bot = rng.uniform(0.02, 0.3, size=3)
        t = (d[..., 1:2] + 1) / 2
        img = (t * top + (1 - t) * bot).astype(np.float32)
    else:                                       # flat ambient
        img = np.full((h, w, 3), rng.uniform(0.05, 0.4), np.float32)
    for _ in range(rng.integers(1, 7)):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        color = rng.uniform(0.3, 3.0, size=3)
        if rng.random() < 0.3:                  # saturated colored light
            color *= rng.dirichlet(np.ones(3)) * 3.0
        sharp = rng.uniform(2.0, 50.0)
        lobe = np.maximum(d @ axis, 0.0) ** sharp
        img += (lobe[..., None] * color).astype(np.float32)
    return img


# ---------------------------------------------------------------------------


def write_dataset(out: str, n_mesh: int = 8, n_env: int = 4,
                  env_res: int = 64, env_min_res: int = 8,
                  env_samples: int = 64, sphere_res: int = 32,
                  tex_res: int = 64, seed: int = 0, device="cuda",
                  log=print) -> None:
    """Write `n_mesh` meshes to out/meshes/mNNN.npz and `n_env` env dirs
    to out/envs/eNN/ (specular_<l>.npy, diffuse.npy), the envs
    prefiltered on `device`."""
    rng = np.random.default_rng(seed)
    mesh_dir = os.path.join(out, "meshes")
    env_root = os.path.join(out, "envs")
    os.makedirs(mesh_dir, exist_ok=True)
    os.makedirs(env_root, exist_ok=True)

    base = make_sphere(sphere_res)
    base_v = np.asarray(base.v_pos)
    t_idx = np.asarray(base.t_pos_idx, np.int32)
    uv = np.asarray(base.v_tex, np.float32)
    for i in range(n_mesh):
        v = make_shape(base_v, rng)
        v = unit_normalize_mesh(v)
        n = auto_normals(v, t_idx)
        tng = compute_tangents(v, t_idx, uv, t_idx, n, t_idx)
        tex = make_texture(tex_res, rng)
        np.savez(os.path.join(mesh_dir, f"m{i:03d}.npz"),
                 v_pos=v.astype(np.float32),
                 t_idx=t_idx,
                 v_nrm=n.astype(np.float32),
                 v_tex=uv,
                 v_tng=tng.astype(np.float32),
                 kd=tex.mean(axis=(0, 1)),
                 kd_tex=tex)
    log(f"wrote {n_mesh} meshes to {mesh_dir}")

    for e in range(n_env):
        img = make_env_latlong(rng)
        cube = latlong_to_cubemap(torch.from_numpy(img).to(device), env_res)
        spec, diff = build_env_mips(cube, min_res=env_min_res,
                                    num_samples=env_samples)
        d_out = os.path.join(env_root, f"e{e:02d}")
        os.makedirs(d_out, exist_ok=True)
        for l, m in enumerate(spec):
            np.save(os.path.join(d_out, f"specular_{l}.npy"),
                    m.float().cpu().numpy())
        np.save(os.path.join(d_out, "diffuse.npy"),
                diff.float().cpu().numpy())
        if (e + 1) % 8 == 0 or e == n_env - 1:
            log(f"wrote env {e + 1}/{n_env}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-mesh", type=int, default=8)
    ap.add_argument("--n-env", type=int, default=4)
    ap.add_argument("--env-res", type=int, default=64)
    ap.add_argument("--env-min-res", type=int, default=8)
    ap.add_argument("--env-samples", type=int, default=64)
    ap.add_argument("--sphere-res", type=int, default=32)
    ap.add_argument("--tex-res", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    write_dataset(args.out, args.n_mesh, args.n_env, args.env_res,
                  args.env_min_res, args.env_samples, args.sphere_res,
                  args.tex_res, args.seed, args.device)


if __name__ == "__main__":
    main()
