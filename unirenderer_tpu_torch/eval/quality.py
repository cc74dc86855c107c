"""The held-out quality harness (counterpart of `tools/eval_quality.py`):
render the held-out maps with the render collate, forward-render them with
the pipeline and score PSNR against the rendered image; with `--inverse`,
also inverse-render the rendered image and score the maps it gives back
(per-map PSNR, the normal angle, the masked metallic/roughness error).

    python -m unirenderer_tpu_torch.eval.quality [--device cuda]
        [--dtype float32] [--n 32] [--steps 20] [--noise-seeds 1000]
        [--inverse] [--ensemble 1] [--lpips] [--fid]
        [--lpips-weights VGG16_FEATURES.pt LPIPS_VGG.pt]
        [--inception-weights INCEPTION_V3.pt]

writes the seed-99 held-out set of `tools/make_data_r05.sh` (32 meshes, 8
envs; ~2 MB) to a temporary directory with `data/synthetic.py`, loads the
trained small() weights (`artifacts/r05/dual_small.npz`,
`artifacts/r04/vae_small.npz`) and the text encoder the JAX harness scores
with (`artifacts/r05/text_small.npz`, written by
`tools/export_text_params_r05.py`), and prints one JSON line with the
scores per noise seed.  `--lpips` / `--fid` add LPIPS and FID of the
forward images against the rendered ones (`perceptual_scores`, f32 on the
device); without weight files the backbones are seeded random ones and
the report says `lpips_calibrated` / `fid_calibrated` false.  The harness
computes in f32 by default on either device, as tools/eval_quality.py
scores small(): on the card the f32 kernels, with cuDNN and cuBLAS
without TF32; `--dtype bfloat16` runs the bf16 kernels.
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
from unirenderer_tpu_torch.eval import metrics as M
from unirenderer_tpu_torch.eval.metrics import NormalMetric, masked_mean, psnr

BATCH = 4
ITEM_SEED = 1234          # ObjaverseDataTest's item sampler
# the held-out set of tools/make_data_r05.sh (the generator's defaults
# for the rest: 64 env samples, sphere 32, 64^2 textures)
HELD_OUT = dict(n_mesh=32, n_env=8, env_res=32, env_min_res=8, seed=99)
DUAL_NPZ = "artifacts/r05/dual_small.npz"
VAE_NPZ = "artifacts/r04/vae_small.npz"
TEXT_NPZ = "artifacts/r05/text_small.npz"
INVERSE_MAPS = ("normal", "albedo", "spec_light", "diff_light")


def held_out_paths(root: str):
    """(sorted mesh .npz paths, sorted env dirs) of a dataset written by
    `data/synthetic.py`."""
    meshes = sorted(glob.glob(os.path.join(root, "meshes", "*.npz")))
    envs = sorted(d for d in glob.glob(os.path.join(root, "envs", "*"))
                  if os.path.isdir(d))
    if not meshes or not envs:
        raise FileNotFoundError(f"no meshes or envs under {root}")
    return meshes, envs


def _held_out_batches(pipe, mesh_paths: List[str], env_dirs: List[str],
                      n: int):
    """`n` held-out items (ObjaverseDataTest with seed 1234) collated in
    batches of 4 at the VAE's resolution on the pipeline's device."""
    res = pipe.cfg.vae.sample_size
    ds = ObjaverseDataTest(pipe.cfg.data, mesh_paths, env_dirs,
                           seed=ITEM_SEED)
    items = [ds[i % len(ds)] for i in range(n)]
    for start in range(0, n, BATCH):
        yield collate_render(items[start:start + BATCH], resolution=res,
                             device=pipe.device)


def _numpy(x) -> np.ndarray:
    return x.float().cpu().numpy()


def forward_psnr(pipe, mesh_paths: List[str], env_dirs: List[str],
                 n: int = 32, num_steps: int = 20, noise_seed: int = 1000,
                 log=None, keep_images: bool = False) -> Dict:
    """Mean over batches of PSNR((fwd + 1) / 2, (gt + 1) / 2) of `n`
    held-out items (ObjaverseDataTest with seed 1234, batches of 4 at the
    VAE's resolution), each forward-rendered from its rendered maps with
    `material_image_encode=True`.  Batch i draws its noise from a
    generator seeded `noise_seed + i` on the pipeline's device; the
    forward image is scored unclipped.  `keep_images`: the result's
    "images" holds per batch (gt, clip(fwd)) in [0, 1], numpy, as
    `perceptual_scores` takes them."""
    scores, images = [], []
    for bi, batch in enumerate(_held_out_batches(pipe, mesh_paths,
                                                 env_dirs, n)):
        gen = torch.Generator(device=pipe.device).manual_seed(
            noise_seed + bi)
        fwd = pipe.mask2image_3mod_albedo(
            normal=batch["normal"], albedo=batch["albedo"],
            spec_light=batch["spec_light"], diff_light=batch["diff_light"],
            env=batch["env"], mask=batch["mask"],
            metallic=batch["metallic"], roughness=batch["roughness"],
            generator=gen, num_steps=num_steps, material_image_encode=True)
        gt01 = (_numpy(batch["image"]) + 1) / 2
        scores.append(psnr((_numpy(fwd) + 1) / 2, gt01))
        if keep_images:
            images.append((gt01, (np.clip(_numpy(fwd), -1, 1) + 1) / 2))
        if log is not None:
            log(f"batch {bi}: psnr_fwd={scores[-1]:.2f}")
    out = dict(psnr_forward_render=float(np.mean(scores)),
               per_batch=scores, n_objects=n, steps=num_steps,
               noise_seed=noise_seed)
    if keep_images:
        out["images"] = images
    return out


def perceptual_scores(images, device="cuda", lpips: bool = True,
                      fid: bool = True, lpips_weights=None,
                      inception_weights=None) -> Dict:
    """LPIPS and FID of forward images against ground truth (the
    `--lpips` / `--fid` legs of `tools/eval_quality.py`), f32 on
    `device`.  `images`: per batch (gt, fwd) (B, H, W, 3) in [0, 1].
    LPIPS is the mean over images of LPIPS(gt * 2 - 1, fwd * 2 - 1); FID
    (only with 8 images or more) is over all of them, 4 a call through
    InceptionV3.  Without weight files (`lpips_weights`: the VGG16
    features and the lpips heads; `inception_weights`) the backbones are
    the seeded random ones and `*_calibrated` is false."""
    from unirenderer_tpu_torch.eval import inception as inc
    from unirenderer_tpu_torch.eval import lpips as lp
    out = {}
    gts = [g for g, _ in images]
    fwds = [f for _, f in images]
    if lpips:
        model = (lp.lpips_from_files(*lpips_weights, device=device)
                 if lpips_weights else lp.random_lpips(device=device))
        fn, _ = lp.make_lpips_fn(model)
        out["lpips_forward_vs_gt"] = float(np.concatenate(
            [fn(g * 2 - 1, f * 2 - 1) for g, f in images]).mean())
        out["lpips_calibrated"] = bool(lpips_weights)
    if fid and sum(len(g) for g in gts) >= 8:
        model = (inc.inception_from_file(inception_weights, device=device)
                 if inception_weights else inc.random_inception(
                     device=device))
        feat = inc.make_feature_fn(model, batch=4)
        out["fid_forward_vs_gt"] = M.fid(np.concatenate(gts),
                                         np.concatenate(fwds), feat)
        out["fid_calibrated"] = bool(inception_weights)
    return out


def inverse_scores(pipe, mesh_paths: List[str], env_dirs: List[str],
                   n: int = 32, num_steps: int = 20, noise_seed: int = 1000,
                   ensemble: int = 1, log=None) -> Dict:
    """The inverse leg of `tools/eval_quality.py` over the same `n` items:
    each rendered image and its mask through `real_image2mask_3mod_albedo`
    (`ensemble` members, batch i's noise from a generator seeded
    `noise_seed + i`); per-map PSNR of normal, albedo, spec_light and
    diff_light (mean over batches), the normal angle inside the mask over
    all pixels (`NormalMetric`), and the mean over batches of the masked
    metallic/roughness MAE."""
    maps = {k: [] for k in INVERSE_MAPS}
    normal = NormalMetric()
    mr_mae = []
    for bi, batch in enumerate(_held_out_batches(pipe, mesh_paths,
                                                 env_dirs, n)):
        gen = torch.Generator(device=pipe.device).manual_seed(
            noise_seed + bi)
        inv = pipe.real_image2mask_3mod_albedo(
            image=batch["image"], mask=batch["mask"], generator=gen,
            num_steps=num_steps, ensemble=ensemble)
        for k in INVERSE_MAPS:
            maps[k].append(psnr((_numpy(inv[k]) + 1) / 2,
                                (_numpy(batch[k]) + 1) / 2))
        mask01 = (_numpy(batch["mask"])[..., 0] + 1) / 2 > 0.5
        normal.update(_numpy(inv["normal"]), _numpy(batch["normal"]), mask01)
        m_pred = masked_mean(_numpy(inv["metallic"]), mask01)
        r_pred = masked_mean(_numpy(inv["roughness"]), mask01)
        mr_mae.append(float(
            np.abs(m_pred - _numpy(batch["metallic"])).mean()
            + np.abs(r_pred - _numpy(batch["roughness"])).mean()) / 2)
        if log is not None:
            log(f"batch {bi}: inverse psnr normal={maps['normal'][-1]:.2f} "
                f"albedo={maps['albedo'][-1]:.2f} mr_mae={mr_mae[-1]:.3f}")
    return dict(psnr_maps={k: float(np.mean(v)) for k, v in maps.items()},
                normal_angle=normal.summary(),
                metal_rough_mae=float(np.mean(mr_mae)), n_objects=n,
                steps=num_steps, ensemble=ensemble, noise_seed=noise_seed)


def small_trained_pipeline(device="cuda", dtype=torch.bfloat16,
                           root: str = "."):
    """The small() pipeline with the repo's trained weights and the text
    encoder the JAX harness scores with (the r05 weights carry none: the
    JAX harness draws it from `UniRendererPipeline.create(small(),
    key(0), f32)`, and `tools/export_text_params_r05.py` wrote it out)."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    pipe = UniRendererPipeline.create(
        config.small(), torch.Generator(device=device).manual_seed(0),
        device=device, dtype=dtype)
    dual, _ = load_params_npz(os.path.join(root, DUAL_NPZ))
    vae, _ = load_params_npz(os.path.join(root, VAE_NPZ))
    text, _ = load_params_npz(os.path.join(root, TEXT_NPZ))
    pipe.load_flax(dual=dual, vae=vae, text=text)
    return pipe


def held_out_scores(pipe, n: int = 32, num_steps: int = 20,
                    noise_seeds: Sequence[int] = (1000,),
                    inverse: bool = False, ensemble: int = 1,
                    log=None, keep_images: bool = False) -> Dict:
    """Write the held-out set to a temporary directory (env prefilter on the
    pipeline's device), then `forward_psnr` once per noise seed, and with
    `inverse` `inverse_scores` once per noise seed.  `keep_images`: each
    forward run keeps its images (`forward_psnr`)."""
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    with tempfile.TemporaryDirectory(prefix="held_out_") as root:
        t = time.perf_counter()
        write_dataset(root, device=pipe.device,
                      log=log or (lambda msg: None), **HELD_OUT)
        gen_s = time.perf_counter() - t
        meshes, envs = held_out_paths(root)
        runs, inv_runs = [], []
        for seed in noise_seeds:
            t = time.perf_counter()
            r = forward_psnr(pipe, meshes, envs, n=n, num_steps=num_steps,
                             noise_seed=seed, log=log,
                             keep_images=keep_images)
            r["seconds"] = time.perf_counter() - t
            runs.append(r)
            if inverse:
                t = time.perf_counter()
                r = inverse_scores(pipe, meshes, envs, n=n,
                                   num_steps=num_steps, noise_seed=seed,
                                   ensemble=ensemble, log=log)
                r["seconds"] = time.perf_counter() - t
                inv_runs.append(r)
    vals = [r["psnr_forward_render"] for r in runs]
    out = dict(psnr_forward_render=float(np.mean(vals)), per_seed=vals,
               runs=runs, generate_seconds=gen_s, held_out=HELD_OUT)
    if inverse:
        out["inverse"] = dict(
            psnr_maps={k: float(np.mean([r["psnr_maps"][k]
                                         for r in inv_runs]))
                       for k in INVERSE_MAPS},
            normal_angle_mean=float(np.mean(
                [r["normal_angle"]["mean"] for r in inv_runs])),
            metal_rough_mae=float(np.mean(
                [r["metal_rough_mae"] for r in inv_runs])),
            ensemble=ensemble, runs=inv_runs)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="compute type; default float32, as "
                         "tools/eval_quality.py scores small()")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--noise-seeds", default="1000")
    ap.add_argument("--inverse", action="store_true",
                    help="also score the inverse leg")
    ap.add_argument("--ensemble", type=int, default=None,
                    help="inverse ensemble members (small(): 1)")
    ap.add_argument("--lpips", action="store_true",
                    help="also LPIPS(forward, rendered), per noise seed")
    ap.add_argument("--fid", action="store_true",
                    help="also FID(forward, rendered), per noise seed "
                         "(needs n >= 8)")
    ap.add_argument("--lpips-weights", nargs=2,
                    metavar=("VGG16_FEATURES.pt", "LPIPS_VGG.pt"),
                    help="torchvision VGG16 features and lpips heads "
                         "state_dicts; a random backbone otherwise")
    ap.add_argument("--inception-weights",
                    help="torchvision inception_v3 state_dict; a random "
                         "backbone otherwise")
    args = ap.parse_args(argv)
    from unirenderer_tpu_torch.utils.runtime import (
        disable_tf32, setup_runtime,
    )
    args.device = str(setup_runtime(args.device))
    args.dtype = args.dtype or "float32"
    if args.dtype == "float32":
        disable_tf32()
    pipe = small_trained_pipeline(args.device, getattr(torch, args.dtype))
    ensemble = args.ensemble or pipe.cfg.sampler.ensemble
    out = held_out_scores(pipe, args.n, args.steps,
                          [int(s) for s in args.noise_seeds.split(",")],
                          inverse=args.inverse, ensemble=ensemble,
                          log=lambda msg: print(msg, flush=True),
                          keep_images=args.lpips or args.fid)
    for run in out["runs"]:
        images = run.pop("images", None)
        if images is not None:
            run.update(perceptual_scores(
                images, args.device, lpips=args.lpips, fid=args.fid,
                lpips_weights=args.lpips_weights,
                inception_weights=args.inception_weights))
    out.update(device=args.device, dtype=args.dtype, torch=torch.__version__)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
