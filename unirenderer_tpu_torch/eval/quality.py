"""The forward leg of the held-out quality harness (counterpart of
`tools/eval_quality.py`'s forward rendering): render the held-out maps
with the render collate, forward-render them with the pipeline, and score
PSNR against the rendered image.

    python -m unirenderer_tpu_torch.eval.quality [--device cuda]
        [--dtype bfloat16] [--n 32] [--steps 20] [--noise-seeds 1000]
        [--text-seed 0]

writes the seed-99 held-out set of `tools/make_data_r05.sh` (32 meshes, 8
envs; ~2 MB) to a temporary directory with `data/synthetic.py`, loads the
trained small() weights (`artifacts/r05/dual_small.npz`,
`artifacts/r04/vae_small.npz`) and prints one JSON line with the forward
PSNR per noise seed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from unirenderer_tpu_torch.data.objaverse import (
    ObjaverseDataTest, collate_render,
)
from unirenderer_tpu_torch.eval.metrics import psnr

BATCH = 4
ITEM_SEED = 1234          # ObjaverseDataTest's item sampler
# the held-out set of tools/make_data_r05.sh (the generator's defaults
# for the rest: 64 env samples, sphere 32, 64^2 textures)
HELD_OUT = dict(n_mesh=32, n_env=8, env_res=32, env_min_res=8, seed=99)
DUAL_NPZ = "artifacts/r05/dual_small.npz"
VAE_NPZ = "artifacts/r04/vae_small.npz"


def held_out_paths(root: str):
    """(sorted mesh .npz paths, sorted env dirs) of a dataset written by
    `data/synthetic.py`."""
    meshes = sorted(glob.glob(os.path.join(root, "meshes", "*.npz")))
    envs = sorted(d for d in glob.glob(os.path.join(root, "envs", "*"))
                  if os.path.isdir(d))
    if not meshes or not envs:
        raise FileNotFoundError(f"no meshes or envs under {root}")
    return meshes, envs


def forward_psnr(pipe, mesh_paths: List[str], env_dirs: List[str],
                 n: int = 32, num_steps: int = 20, noise_seed: int = 1000,
                 log=None) -> Dict:
    """Mean over batches of PSNR((fwd + 1) / 2, (gt + 1) / 2) of `n`
    held-out items (ObjaverseDataTest with seed 1234, batches of 4 at the
    VAE's resolution), each forward-rendered from its rendered maps with
    `material_image_encode=True`.  Batch i draws its noise from a
    generator seeded `noise_seed + i` on the pipeline's device; the
    forward image is scored unclipped."""
    cfg = pipe.cfg
    res = cfg.vae.sample_size
    ds = ObjaverseDataTest(cfg.data, mesh_paths, env_dirs, seed=ITEM_SEED)
    items = [ds[i % len(ds)] for i in range(n)]
    scores = []
    for bi, start in enumerate(range(0, n, BATCH)):
        batch = collate_render(items[start:start + BATCH], resolution=res,
                               device=pipe.device)
        gen = torch.Generator(device=pipe.device).manual_seed(
            noise_seed + bi)
        fwd = pipe.mask2image_3mod_albedo(
            normal=batch["normal"], albedo=batch["albedo"],
            spec_light=batch["spec_light"], diff_light=batch["diff_light"],
            env=batch["env"], mask=batch["mask"],
            metallic=batch["metallic"], roughness=batch["roughness"],
            generator=gen, num_steps=num_steps, material_image_encode=True)
        scores.append(psnr((fwd.float().cpu().numpy() + 1) / 2,
                           (batch["image"].float().cpu().numpy() + 1) / 2))
        if log is not None:
            log(f"batch {bi}: psnr_fwd={scores[-1]:.2f}")
    return dict(psnr_forward_render=float(np.mean(scores)),
                per_batch=scores, n_objects=n, steps=num_steps,
                noise_seed=noise_seed)


def small_trained_pipeline(device="cuda", dtype=torch.bfloat16,
                           root: str = ".", text_seed: int = 0):
    """The small() pipeline with the repo's trained weights.  They carry no
    text encoder, so the CLIP weights are random, drawn on the CPU from
    `text_seed` whatever the device: the blank-prompt context they give
    shapes the render, and the CPU and the card must see the same one."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder
    from unirenderer_tpu_torch.pipelines import (
        UniRendererPipeline, fill_random_,
    )
    cfg = config.small()
    pipe = UniRendererPipeline.create(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        dtype=dtype)
    text = CLIPTextEncoder(cfg.text)
    fill_random_(text, torch.Generator().manual_seed(text_seed))
    pipe.text.load_state_dict(text.state_dict())
    dual, _ = load_params_npz(os.path.join(root, DUAL_NPZ))
    vae, _ = load_params_npz(os.path.join(root, VAE_NPZ))
    pipe.load_flax(dual=dual, vae=vae)
    return pipe


def held_out_psnr(pipe, n: int = 32, num_steps: int = 20,
                  noise_seeds: Sequence[int] = (1000,), log=None) -> Dict:
    """Write the held-out set to a temporary directory (env prefilter on the
    pipeline's device), then `forward_psnr` once per noise seed."""
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    with tempfile.TemporaryDirectory(prefix="held_out_") as root:
        t = time.perf_counter()
        write_dataset(root, device=pipe.device,
                      log=log or (lambda msg: None), **HELD_OUT)
        gen_s = time.perf_counter() - t
        meshes, envs = held_out_paths(root)
        runs = []
        for seed in noise_seeds:
            t = time.perf_counter()
            r = forward_psnr(pipe, meshes, envs, n=n, num_steps=num_steps,
                             noise_seed=seed, log=log)
            r["seconds"] = time.perf_counter() - t
            runs.append(r)
    vals = [r["psnr_forward_render"] for r in runs]
    return dict(psnr_forward_render=float(np.mean(vals)),
                per_seed=vals, runs=runs, generate_seconds=gen_s,
                held_out=HELD_OUT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="bfloat16 on the card (the kernels take nothing "
                         "else); float32 by default on the CPU")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--noise-seeds", default="1000")
    ap.add_argument("--text-seed", type=int, default=0,
                    help="seed of the random CLIP text encoder")
    args = ap.parse_args(argv)
    on_cpu = torch.device(args.device).type == "cpu"
    args.dtype = args.dtype or ("float32" if on_cpu else "bfloat16")
    if args.dtype != "bfloat16" and not on_cpu:
        ap.error("the card's kernels take bfloat16 only")
    pipe = small_trained_pipeline(args.device, getattr(torch, args.dtype),
                                  text_seed=args.text_seed)
    out = held_out_psnr(pipe, args.n, args.steps,
                        [int(s) for s in args.noise_seeds.split(",")],
                        log=lambda msg: print(msg, flush=True))
    out.update(device=args.device, dtype=args.dtype,
               text_seed=args.text_seed, torch=torch.__version__)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
