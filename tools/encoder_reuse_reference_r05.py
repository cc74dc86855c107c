#!/usr/bin/env python
"""The JAX package's held-out forward PSNR under encoder reuse: the
reference the PyTorch port's encoder reuse is held to.

    python tools/encoder_reuse_reference_r05.py
        [--out artifacts/r05/encoder_reuse_small.json] [--reuse 1,2]

Writes the seed-99 held-out set of `tools/make_data_r05.sh` (32 meshes, 8
envs) to a temporary directory with `tools/make_synthetic_data.py`, loads
the trained small() weights (`artifacts/r05/dual_small.npz`,
`artifacts/r04/vae_small.npz`) into `UniRendererPipeline.create(small(),
key(0), f32)` (whose text encoder is the one the harness scores with), and
runs the forward leg of `tools/eval_quality.py` (the same items, batches
of 4, batch i's key 1000 + i, 20 steps, `material_image_encode`) once per
`SamplerConfig.encoder_reuse` value.  Reuse 1 is the exact sampler, the
setting of QUALITY_r05_fixed.json.  Writes one small JSON; JAX runs on the
CPU only (~1 min for the two default settings).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

HELD_OUT = ["--n-mesh", "32", "--n-env", "8", "--env-res", "32",
            "--env-min-res", "8", "--seed", "99"]
DUAL_NPZ = "artifacts/r05/dual_small.npz"
VAE_NPZ = "artifacts/r04/vae_small.npz"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="artifacts/r05/encoder_reuse_small.json")
    ap.add_argument("--reuse", default="1,2")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import make_synthetic_data
    from unirenderer_tpu.core import config
    from unirenderer_tpu.core.checkpoint import load_params_npz
    from unirenderer_tpu.data.objaverse import (
        ObjaverseDataTest, collate_render,
    )
    from unirenderer_tpu.eval import metrics as M
    from unirenderer_tpu.pipelines import UniRendererPipeline

    cfg = config.small()
    pipe = UniRendererPipeline.create(cfg, jax.random.key(0), jnp.float32)
    pipe.dual_params = jax.tree.map(jnp.asarray, load_params_npz(DUAL_NPZ)[0])
    pipe.vae_params = jax.tree.map(jnp.asarray, load_params_npz(VAE_NPZ)[0])
    res = cfg.vae.sample_size
    out = dict(n_objects=args.n, steps=args.steps, keys="1000 + batch",
               held_out="tools/make_synthetic_data.py " + " ".join(HELD_OUT),
               weights=[DUAL_NPZ, VAE_NPZ], jax=jax.__version__,
               psnr_forward_render={}, per_batch={}, seconds={})
    with tempfile.TemporaryDirectory(prefix="held_out_") as root:
        make_synthetic_data.main(["--out", root] + HELD_OUT)
        meshes = sorted(glob.glob(os.path.join(root, "meshes", "*.npz")))
        envs = sorted(d for d in glob.glob(os.path.join(root, "envs", "*"))
                      if os.path.isdir(d))
        ds = ObjaverseDataTest(cfg.data, meshes, envs, seed=1234)
        items = [ds[i % len(ds)] for i in range(args.n)]
        batches = [collate_render(items[i:i + 4], resolution=res)
                   for i in range(0, args.n, 4)]
        for k in (int(x) for x in args.reuse.split(",")):
            pipe.cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
                cfg.sampler, encoder_reuse=k))
            t = time.perf_counter()
            scores = []
            for bi, batch in enumerate(batches):
                fwd = pipe.mask2image_3mod_albedo(
                    normal=batch["normal"], albedo=batch["albedo"],
                    spec_light=batch["spec_light"],
                    diff_light=batch["diff_light"], env=batch["env"],
                    mask=batch["mask"], metallic=batch["metallic"],
                    roughness=batch["roughness"],
                    rng=jax.random.key(1000 + bi), num_steps=args.steps,
                    material_image_encode=True)
                scores.append(M.psnr((np.asarray(fwd) + 1) / 2,
                                     (np.asarray(batch["image"]) + 1) / 2))
            out["psnr_forward_render"][str(k)] = float(np.mean(scores))
            out["per_batch"][str(k)] = [float(s) for s in scores]
            out["seconds"][str(k)] = time.perf_counter() - t
            print(f"encoder_reuse={k}: held-out forward PSNR "
                  f"{np.mean(scores):.4f} dB", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
