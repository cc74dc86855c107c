"""Held-out VAE reconstruction eval (counterpart of `tools/eval_vae.py`):
encode (one posterior sample) -> decode -> clip -> PSNR per modality.

The VAE's reconstruction bounds every decoded map's PSNR in the quality
harness (`eval/quality.py`).  Scored on the held-out render set, per
modality (image, normal, albedo, spec and diff light) plus the flat
material image [m, m, r] * 2 - 1 under the mask, and their mean:

    python -m unirenderer_tpu_torch.eval.vae_recon [--vae-ckpt NPZ_OR_DIR]
        [--mesh-dir D/meshes --env-dir D/envs] [--config small] [--n 32]
        [--out VAE_RECON.json] [--device cuda]

Without --mesh-dir / --env-dir it writes the seed-99 held-out set of
`tools/make_data_r05.sh` (32 meshes, 8 envs, `eval.quality.HELD_OUT`) to
a temporary directory first.  The VAE is `artifacts/r04/vae_small.npz`
by default (a params npz, or a directory of checkpoints as
`python -m unirenderer_tpu_torch.train.vae` writes them).  As in the JAX
tool: items from `ObjaverseDataTest(seed=1234)`, collated in batches of
8 at the VAE's resolution; the batch starting at item `start` draws one
posterior noise that all six modalities share (JAX's
`jax.random.key(start)`; here a generator seeded `start` on the device,
or any draw handed in, so that a test can give it JAX's); PSNR of
(clip(decoded) + 1) / 2 against (image + 1) / 2 over the batch, averaged
over the batches.  It computes in f32 (cuDNN and cuBLAS without TF32),
on the card by default, and prints and writes the JAX tool's JSON
(`psnr`, `psnr_mean`, `n`, `ckpt`, `ckpt_step`) with the device.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from unirenderer_tpu_torch.data.objaverse import (
    ObjaverseDataTest, collate_render,
)
from unirenderer_tpu_torch.eval.metrics import psnr
from unirenderer_tpu_torch.eval.quality import (
    HELD_OUT, ITEM_SEED, VAE_NPZ, held_out_paths,
)
from unirenderer_tpu_torch.pipelines import material_image

MODALITIES = ("image", "normal", "albedo", "spec_light", "diff_light",
              "material")
BATCH = 8

# (batch start, latent shape, device) -> the posterior noise of that batch
Draws = Callable[[int, Tuple[int, ...], torch.device], torch.Tensor]


def seeded_draws(start: int, shape, device) -> torch.Tensor:
    """The default posterior noise: N(0, 1) from a generator seeded
    `start` on `device` (the JAX tool's `jax.random.key(start)`)."""
    gen = torch.Generator(device=device).manual_seed(start)
    return torch.randn(shape, generator=gen, device=device)


def vae_pipeline(cfg, ckpt: str, device):
    """A pipeline of `cfg` on `device` in f32 whose VAE is loaded strictly
    from `ckpt` (a params npz, or a checkpoint directory), as the JAX tool
    creates its pipeline and swaps in the VAE's parameters -> (pipeline,
    checkpoint step)."""
    from unirenderer_tpu_torch.core.checkpoint import (
        CheckpointManager, load_params_npz,
    )
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    if ckpt.endswith(".npz"):
        flat, step = load_params_npz(ckpt)
    else:
        cm = CheckpointManager(ckpt)
        flat, step = cm.restore_params(), cm.restored_step()
        if flat is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt}")
    pipe = UniRendererPipeline.create(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        dtype=torch.float32)
    pipe.load_flax(vae=flat)
    return pipe, step


def recon_batches(cfg, mesh_paths: Sequence[str], env_dirs: Sequence[str],
                  n: int, device) -> Iterator[Tuple[int, Dict]]:
    """(start, {modality: (B, H, W, 3) in [-1, 1]}) of `n` held-out items
    in batches of 8 at the VAE's resolution, collated on `device`."""
    ds = ObjaverseDataTest(cfg.data, list(mesh_paths), list(env_dirs),
                           seed=ITEM_SEED)
    for start in range(0, n, BATCH):
        items = [ds[i % len(ds)] for i in range(start, min(start + BATCH,
                                                          n))]
        batch = collate_render(items, resolution=cfg.vae.sample_size,
                               device=device)
        images = {k: batch[k] for k in MODALITIES[:-1]}
        images["material"] = material_image(batch["mask"], batch["metallic"],
                                            batch["roughness"])
        yield start, images


def latent_shape(cfg, images: torch.Tensor) -> Tuple[int, ...]:
    """(B, h, w, latent channels) of the posterior of (B, H, W, 3)."""
    b, h, w, _ = images.shape
    f = cfg.vae.downscale
    return (b, h // f, w // f, cfg.vae.latent_channels)


def reconstruct(pipe, images, noise) -> np.ndarray:
    """clip(decode(encode(images) with the posterior `noise`)) to [-1, 1]
    on the pipeline's device (f32 without TF32 there), as numpy."""
    dec = pipe.decode_latents(pipe.encode_images(images, noise))
    return torch.clamp(dec, -1.0, 1.0).cpu().numpy()


def reconstruction_psnr(pipe, mesh_paths: Sequence[str],
                        env_dirs: Sequence[str], n: int = 32,
                        draws: Optional[Draws] = None,
                        log=None) -> Dict:
    """PSNR of each modality's reconstruction by the pipeline's VAE on `n`
    held-out items, averaged over the batches, and their mean: {"psnr":
    {modality: dB}, "psnr_mean": dB, "n": n}.  `draws(start, latent
    shape, device)` gives each batch's posterior noise (`seeded_draws` by
    default)."""
    cfg = pipe.cfg
    draws = draws or seeded_draws
    scores = {m: [] for m in MODALITIES}
    for start, images in recon_batches(cfg, mesh_paths, env_dirs, n,
                                       pipe.device):
        noise = draws(start, latent_shape(cfg, images["image"]),
                      pipe.device)
        for name in MODALITIES:
            dec = reconstruct(pipe, images[name], noise)
            gt = (images[name].float().cpu().numpy() + 1) / 2
            scores[name].append(psnr((dec + 1) / 2, gt))
        if log is not None:
            log(f"batch at {start}: " + ", ".join(
                f"{m} {scores[m][-1]:.2f}" for m in MODALITIES))
    out = {"psnr": {k: float(np.mean(v)) for k, v in scores.items()}}
    out["psnr_mean"] = float(np.mean(list(out["psnr"].values())))
    out["n"] = n
    return out


def held_out_reconstruction(pipe, n: int = 32,
                            draws: Optional[Draws] = None, log=None) -> Dict:
    """`reconstruction_psnr` on the seed-99 held-out set, written to a
    temporary directory first (envs prefiltered on the pipeline's
    device)."""
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    with tempfile.TemporaryDirectory(prefix="held_out_") as root:
        write_dataset(root, device=pipe.device, log=lambda msg: None,
                      **HELD_OUT)
        meshes, envs = held_out_paths(root)
        return reconstruction_psnr(pipe, meshes, envs, n=n, draws=draws,
                                   log=log)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh-dir", help="default: the seed-99 held-out set, "
                                       "written to a temporary directory")
    ap.add_argument("--env-dir")
    ap.add_argument("--vae-ckpt", default=VAE_NPZ,
                    help="params npz or checkpoint directory")
    ap.add_argument("--config", default="small")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--out", default="VAE_RECON.json")
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    args = ap.parse_args(argv)
    if bool(args.mesh_dir) != bool(args.env_dir):
        ap.error("give both --mesh-dir and --env-dir, or neither")
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.utils.runtime import (
        disable_tf32, setup_runtime,
    )
    device = setup_runtime(args.device)
    disable_tf32()
    pipe, step = vae_pipeline(getattr(config, args.config)(),
                              args.vae_ckpt, device)
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    if args.mesh_dir:
        from unirenderer_tpu_torch.train.__main__ import data_paths
        meshes, envs = data_paths(args.mesh_dir, args.env_dir)
        rep = reconstruction_psnr(pipe, meshes, envs, n=args.n, log=log)
    else:
        rep = held_out_reconstruction(pipe, n=args.n, log=log)
    rep.update(ckpt=args.vae_ckpt, ckpt_step=int(step or 0),
               device=str(device), dtype="float32")
    print(json.dumps(rep, indent=1), flush=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main()
