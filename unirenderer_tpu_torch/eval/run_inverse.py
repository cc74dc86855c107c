#!/usr/bin/env python
"""Single-image inverse rendering CLI (counterpart of
`unirenderer_tpu/eval/run_inverse.py`): an image (+ a mask) -> ensemble
inverse rendering -> one folder per map.

    python -m unirenderer_tpu_torch.eval.run_inverse --image in.png \\
        --out outdir [--mask mask.png|mask.npy] [--box x0,y0,x1,y1] \\
        [--point x,y[,x,y...]] [--ckpt dir] [--steps 20] [--ensemble 5] \\
        [--size 512] [--tiny] [--relight-env env.hdr|env.npy] \\
        [--device cuda]

The mask: `--mask` takes any external segmenter's file (the MASK FILE
CONTRACT of `eval/segmentation.py`), `--box` / `--point` run the prompt
heuristics, and by default the white-background heuristic runs.  Writes
`<out>/{normal,albedo,spec_light,diff_light,env,metallic,roughness}/0.png`
and, with `--relight-env` (a Radiance .hdr or a linear float .npy
latlong), `<out>/relit/0.png`.  flagship() (bf16 on the card, f32 on the
CPU) with random weights from a generator seeded 0, or the dual-stream
params of the newest checkpoint under `--ckpt`; `--tiny` for a smoke run
at tiny()'s resolution.  The inverse pass draws from a generator seeded
1, the relight from one seeded 2, on the device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from unirenderer_tpu_torch.eval.segmentation import (
    auto_mask, box_prompt_mask, load_mask, point_prompt_mask,
)

MAP_FOLDERS = ("normal", "albedo", "spec_light", "diff_light", "env",
               "metallic", "roughness")


def load_image(path: str, size: int) -> np.ndarray:
    """RGB float32 in [0, 1] at (size, size) (Pillow's bilinear filter)."""
    from PIL import Image
    with Image.open(path) as img:
        img = img.convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def save_image(path: str, arr01: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(
        (np.clip(arr01, 0, 1) * 255).astype(np.uint8)).save(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--mask", help="external mask file (png/npy), see "
                    "eval/segmentation.py MASK FILE CONTRACT")
    ap.add_argument("--box", help="x0,y0,x1,y1 box-prompt heuristic mask")
    ap.add_argument("--point", help="x,y[,x,y...] click-prompt heuristic "
                    "mask (negative pair = background click)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", help="checkpoint dir (trained params)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ensemble", type=int, default=5)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random model (smoke only)")
    ap.add_argument("--relight-env",
                    help="HDR latlong (.hdr RGBE or .npy linear float): "
                    "also re-light the object under it and save "
                    "relit/0.png")
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    args = ap.parse_args(argv)

    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import CheckpointManager
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    from unirenderer_tpu_torch.utils.runtime import setup_runtime

    dev = setup_runtime(args.device)
    cfg = config.tiny() if args.tiny else config.flagship()
    size = cfg.vae.sample_size if args.tiny else args.size
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    pipe = UniRendererPipeline.create(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=dtype)
    if args.ckpt:
        restored = CheckpointManager(args.ckpt).restore_params()
        if restored is not None:
            pipe.load_flax(dual=restored)

    img01 = load_image(args.image, size)
    if args.mask:
        mask01 = load_mask(args.mask, size)
    elif args.box:
        mask01 = box_prompt_mask(img01, [int(v) for v in args.box.split(",")])
    elif args.point:
        mask01 = point_prompt_mask(img01,
                                   [int(v) for v in args.point.split(",")])
    else:
        mask01 = auto_mask(img01)

    image = torch.from_numpy(img01 * 2 - 1)[None]
    mask = torch.from_numpy(mask01 * 2 - 1)[None]
    out = pipe.real_image2mask_3mod_albedo(
        image=image, mask=mask,
        generator=torch.Generator(device=dev).manual_seed(1),
        num_steps=args.steps, ensemble=args.ensemble)
    maps = {k: v[0].float().cpu().numpy() for k, v in out.items()}
    for name in MAP_FOLDERS:
        x = maps[name]
        img = (np.repeat(x[..., None], 3, -1) if x.ndim == 2
               else (x + 1) / 2)
        save_image(os.path.join(args.out, name, "0.png"), img)
    print(f"saved maps to {args.out}  metallic~{maps['metallic'].mean():.3f}"
          f" roughness~{maps['roughness'].mean():.3f}", flush=True)

    if args.relight_env:
        if args.relight_env.endswith(".npy"):
            env_img = np.load(args.relight_env).astype(np.float32)
        else:
            from unirenderer_tpu_torch.data.hdr import read_hdr
            env_img = read_hdr(args.relight_env)
        relit = pipe.relight(
            image=image, mask=mask, new_env=torch.from_numpy(env_img),
            generator=torch.Generator(device=dev).manual_seed(2),
            num_steps=args.steps, decomposed=out)
        save_image(os.path.join(args.out, "relit", "0.png"),
                   (relit[0].float().cpu().numpy() + 1) / 2)
        print(f"saved relit image under {args.relight_env}", flush=True)


if __name__ == "__main__":
    main()
