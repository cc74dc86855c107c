"""VAE pre-training CLI of the port (counterpart of `tools/train_vae.py`):

    python -m unirenderer_tpu_torch.train.vae --workdir runs/vae \\
        --synthetic --tiny --steps 50 --device cpu
    python -m unirenderer_tpu_torch.train.vae --workdir runs/vae \\
        --mesh-dir D/meshes --env-dir D/envs --steps 20000 \\
        [--config small] [--batch 8] [--scene-bank]

Trains the VAE on the 8 rendered maps of each batch (`train/vae_train.py`)
and writes <workdir>/vae_checkpoints/checkpoint-<step> (the params npz is
the frozen VAE that `python -m unirenderer_tpu_torch.train --vae-ckpt`
takes) and vae_metrics.jsonl; a run resumes from its newest checkpoint.
`--device` defaults to $UNIRENDER_PLATFORM, else cuda, and raises
without a card.  The step computes in f32, as tools/train_vae.py does
(the card's f32 kernels, cuDNN without TF32).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unirenderer_tpu_torch.train.vae",
        description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--mesh-dir")
    ap.add_argument("--env-dir")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4,
                    help="scenes per batch (x8 maps = the VAE's batch)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr-schedule", choices=("constant", "cosine"),
                    default="constant")
    ap.add_argument("--lr-warmup", type=int, default=500)
    ap.add_argument("--kl-weight", type=float, default=1e-6)
    ap.add_argument("--config", choices=("tiny", "small", "flagship"),
                    default="flagship")
    ap.add_argument("--tiny", action="store_true",
                    help="alias for --config tiny")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--resolution", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=1000)
    ap.add_argument("--cache-batches", type=int,
                    help="render N batches once and train from that pool")
    ap.add_argument("--cache-dir",
                    help="persist / reuse the pre-rendered pool here")
    ap.add_argument("--init-params",
                    help="warm-start from a params .npz; a checkpoint in "
                         "--workdir still wins")
    ap.add_argument("--scene-bank", action="store_true",
                    help="draw and render fresh scenes from a device-"
                         "resident bank inside every step")
    ap.add_argument("--no-augment", action="store_true",
                    help="disable the scene-bank augmentations")
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    args = ap.parse_args(argv)
    if args.scene_bank and (args.synthetic or args.cache_batches):
        ap.error("--scene-bank excludes --synthetic/--cache-batches (it "
                 "draws fresh scenes from the device bank)")
    if not args.synthetic and not (args.mesh_dir and args.env_dir):
        ap.error("give --mesh-dir and --env-dir, or --synthetic")

    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.train.__main__ import data_paths
    from unirenderer_tpu_torch.train.trainer import synthetic_batches
    from unirenderer_tpu_torch.train.vae_train import train_vae
    from unirenderer_tpu_torch.utils.runtime import (
        disable_tf32, kernel_launches, setup_runtime,
    )

    device = setup_runtime(args.device)
    disable_tf32()
    name = "tiny" if args.tiny else args.config
    cfg = getattr(config, name)()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="float32"))     # tools/train_vae.py's
    res = args.resolution or cfg.vae.sample_size
    bank = None
    batches = None
    if args.scene_bank:
        from unirenderer_tpu_torch.data.scene_bank import (
            bank_bytes, bank_sizes, load_scene_bank,
        )
        if args.resolution:
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, resolution=args.resolution))
        bank = load_scene_bank(args.mesh_dir, args.env_dir, cfg.data)
        n_m, n_e = bank_sizes(bank)
        print(f"[vae] scene bank: {n_m} meshes, {n_e} envs, "
              f"{bank_bytes(bank) / 1e6:.0f} MB device-resident", flush=True)
    elif args.synthetic:
        batches = synthetic_batches(cfg, args.batch, seed=args.seed,
                                    device=device)
    else:
        from unirenderer_tpu_torch.data.objaverse import ObjaverseData
        from unirenderer_tpu_torch.train.trainer import rendered_batches
        meshes, envs = data_paths(args.mesh_dir, args.env_dir)
        if not (meshes and envs):
            ap.error("no preprocessed meshes/envs found")
        batches = rendered_batches(ObjaverseData(cfg.data, meshes, envs),
                                   args.batch, res, cfg.data.ssaa,
                                   device=device)
    if args.cache_batches:
        from unirenderer_tpu_torch.data.input_pipeline import (
            cached_batch_source,
        )
        batches = cached_batch_source(batches, args.cache_batches,
                                      cache_dir=args.cache_dir,
                                      seed=args.seed,
                                      expect_batch=args.batch,
                                      expect_resolution=res)

    state = train_vae(cfg, batches, args.workdir, args.steps, lr=args.lr,
                      kl_weight=args.kl_weight, seed=args.seed,
                      checkpoint_every=args.checkpoint_every,
                      lr_schedule=args.lr_schedule, lr_warmup=args.lr_warmup,
                      init_params=args.init_params or "", scene_bank=bank,
                      bank_batch=args.batch, augment=not args.no_augment,
                      device=device,
                      log=lambda msg: print(msg, flush=True))
    print(f"finished at step {state.step} (target {args.steps}); "
          f"checkpoints in {args.workdir}/vae_checkpoints", flush=True)
    print(f"[vae] kernel launches {json.dumps(kernel_launches())}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
