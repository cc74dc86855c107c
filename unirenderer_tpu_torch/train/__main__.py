"""Training CLI of the port (counterpart of `tools/train.py`, the flags this
slice supports):

    # synthetic smoke (no data), on the CPU:
    python -m unirenderer_tpu_torch.train --workdir runs/smoke --tiny \\
        --synthetic --steps 3 --device cpu

    # preprocessed meshes and envs (tools/obj2mesh.py, tools/light2map.py),
    # rendered by the collate on the card:
    python -m unirenderer_tpu_torch.train --workdir runs/exp1 \\
        --mesh-dir data/meshes --env-dir data/envs --steps 1000

`--device` defaults to cuda and raises without a card.  Writes
<workdir>/metrics.jsonl and <workdir>/checkpoints/params_<step>.npz (the
JAX package's params format: `tools/train.py --init-params` reads it).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unirenderer_tpu_torch.train",
        description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--config", choices=("tiny", "small", "flagship"),
                    default="flagship")
    ap.add_argument("--tiny", action="store_true",
                    help="alias for --config tiny")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--batch-per-device", type=int)
    ap.add_argument("--lr", type=float)
    ap.add_argument("--lr-schedule", choices=("constant", "cosine"))
    ap.add_argument("--lr-warmup", type=int, help="warmup steps (0 = none)")
    ap.add_argument("--lr-decay-steps", type=int,
                    help="cosine horizon; defaults to --steps")
    ap.add_argument("--checkpoint-every", type=int)
    ap.add_argument("--synthetic", action="store_true",
                    help="random maps instead of rendered scenes")
    ap.add_argument("--mesh-dir")
    ap.add_argument("--env-dir")
    ap.add_argument("--resolution", type=int,
                    help="render resolution (default: the config's)")
    ap.add_argument("--init-params",
                    help="warm-start the dual-stream params from a params "
                         ".npz; the optimizer starts fresh")
    ap.add_argument("--vae-ckpt",
                    help="the frozen VAE from a params .npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.train.trainer import (
        Trainer, rendered_batches, synthetic_batches,
    )

    name = "tiny" if args.tiny else args.config
    cfg = getattr(config, name)()
    over = {}
    if args.batch_per_device:
        over["batch_size_per_device"] = args.batch_per_device
    if args.lr:
        over["learning_rate"] = args.lr
    if args.lr_schedule:
        over["lr_schedule"] = args.lr_schedule
        if args.lr_schedule == "cosine":
            over["lr_decay_steps"] = (args.lr_decay_steps or args.steps
                                      or cfg.train.max_steps)
    if args.lr_warmup is not None:
        over["lr_warmup_steps"] = args.lr_warmup
    if args.checkpoint_every:
        over["checkpoint_every"] = args.checkpoint_every
    if over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **over))
    if args.resolution:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          resolution=args.resolution))
    if not args.synthetic and not (args.mesh_dir and args.env_dir):
        ap.error("give --mesh-dir and --env-dir, or --synthetic")

    trainer = Trainer(cfg, args.workdir, device=args.device)
    if args.vae_ckpt:
        vae_flat, vstep = load_params_npz(args.vae_ckpt)
        trainer.install_vae(vae_flat)
        print(f"[train] frozen VAE from {args.vae_ckpt} step {vstep}")
    if args.init_params:
        dual_flat, pstep = load_params_npz(args.init_params)
        trainer.install_dual(dual_flat)
        print(f"[train] warm-start dual params from {args.init_params} "
              f"(step {pstep})")

    batch = cfg.train.batch_size_per_device
    if args.synthetic:
        batches = synthetic_batches(cfg, batch, device=trainer.device)
    else:
        from unirenderer_tpu_torch.data.objaverse import ObjaverseData
        meshes = sorted(glob.glob(os.path.join(args.mesh_dir, "*.npz")))
        envs = sorted(d for d in glob.glob(os.path.join(args.env_dir, "*"))
                      if os.path.isdir(d))
        if not (meshes and envs):
            ap.error("no preprocessed meshes/envs found")
        batches = rendered_batches(
            ObjaverseData(cfg.data, meshes, envs), batch,
            cfg.data.resolution, cfg.data.ssaa, device=trainer.device)

    state = trainer.train(batches, max_steps=args.steps)
    print(f"finished at step {state.step}; metrics in "
          f"{trainer.metrics_path}, params in {trainer.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
