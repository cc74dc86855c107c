"""Training CLI of the port (counterpart of `tools/train.py`):

    # synthetic smoke (no data), on the CPU:
    python -m unirenderer_tpu_torch.train --workdir runs/smoke --tiny \\
        --synthetic --steps 3 --device cpu

    # preprocessed meshes and envs (python -m
    # unirenderer_tpu_torch.data.obj2mesh --src objs --dst data/meshes;
    # python -m unirenderer_tpu_torch.data.light2map --src hdrs
    # --dst data/envs), rendered by the collate on the card before each
    # step:
    python -m unirenderer_tpu_torch.train --workdir runs/exp1 \\
        --mesh-dir data/meshes --env-dir data/envs --steps 1000

    # fresh scenes every step from a device-resident scene bank (the
    # recipe of the r05 weights):
    python -m unirenderer_tpu_torch.train --workdir runs/bank \\
        --mesh-dir data/meshes --env-dir data/envs --scene-bank

    # data-parallel over N ranks (one per card), masters and optimizer
    # state sharded (FSDP), from the SD-v1.4 diffusers weights; with
    # `--optimizer adafactor` the lowest-memory recipe (Adafactor's
    # factored statistics whole on every rank):
    torchrun --nproc_per_node N -m unirenderer_tpu_torch.train \\
        --workdir runs/sd --synthetic --fsdp --sd-unet unet.bin \\
        --sd-vae vae.bin --sd-text text_encoder.bin [--optimizer adafactor]

`--device` defaults to $UNIRENDER_PLATFORM, else cuda, and raises without
a card.  The step computes in the type tools/train.py picks: bfloat16 for
flagship, float32 (the card's f32 kernels, cuDNN without TF32) for small
and tiny, on either device.  Under torchrun every rank loads, renders and
trains on its own rows of the global batch (--batch-per-device x ranks),
NCCL on the card, gloo with `--device cpu`; rank 0 logs, checkpoints and
validates, and each rank keeps its own --cache-dir pool
(`rank<r>-of-<n>`).  A run
resumes from the newest checkpoint in <workdir>/checkpoints
(checkpoint-<step>: the params npz in the JAX package's format, read by
`tools/train.py --init-params`, and the optimizer, counters and
generator state; full tensors, so a run resumes at any number of
ranks).  Writes <workdir>/metrics.jsonl and
phases.jsonl, and with --validation maps and PSNRs under
<workdir>/validation.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys


def data_paths(mesh_dir: str, env_dir: str):
    """(sorted mesh .npz paths, sorted env dirs)."""
    meshes = sorted(glob.glob(os.path.join(mesh_dir, "*.npz")))
    envs = sorted(d for d in glob.glob(os.path.join(env_dir, "*"))
                  if os.path.isdir(d))
    return meshes, envs


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
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"),
                    help="adamw (default) or adafactor (factored second "
                         "moments, optax's update)")
    ap.add_argument("--checkpoint-every", type=int)
    ap.add_argument("--validation-every", type=int)
    ap.add_argument("--synthetic", action="store_true",
                    help="random maps instead of rendered scenes")
    ap.add_argument("--mesh-dir")
    ap.add_argument("--env-dir")
    ap.add_argument("--resolution", type=int,
                    help="render resolution (default: the config's)")
    ap.add_argument("--random-camera", action="store_true")
    ap.add_argument("--render-in-step", action="store_true",
                    help="render the stacked scenes inside the train step "
                         "(the input pipeline feeds raw scene tensors)")
    ap.add_argument("--scene-bank", action="store_true",
                    help="load every mesh and env onto the device once and "
                         "draw and render fresh scenes inside every step")
    ap.add_argument("--no-augment", action="store_true",
                    help="disable the scene-bank augmentations")
    ap.add_argument("--validation", action="store_true",
                    help="inverse-render one held-out scene every "
                         "validation_every steps; maps and PSNRs under "
                         "<workdir>/validation")
    ap.add_argument("--cache-batches", type=int,
                    help="render N batches once and train from that pool")
    ap.add_argument("--cache-dir",
                    help="persist / reuse the pre-rendered pool here")
    ap.add_argument("--report-to", default="jsonl",
                    help="comma list: jsonl,tensorboard")
    ap.add_argument("--init-params",
                    help="warm-start the dual-stream params from a params "
                         ".npz; the optimizer starts fresh; a checkpoint in "
                         "--workdir still wins")
    ap.add_argument("--vae-ckpt",
                    help="the frozen VAE: a params .npz, or a directory of "
                         "checkpoints (python -m "
                         "unirenderer_tpu_torch.train.vae's vae_checkpoints)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the dual-stream masters and optimizer state "
                         "over the ranks (FSDP)")
    ap.add_argument("--sd-unet", help="diffusers UNet state_dict (.bin, "
                                      ".safetensors)")
    ap.add_argument("--sd-vae", help="diffusers VAE state_dict")
    ap.add_argument("--sd-text", help="CLIP text-encoder state_dict")
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    args = ap.parse_args(argv)

    if args.render_in_step and (args.synthetic or args.cache_batches):
        ap.error("--render-in-step renders inside the train step; it needs "
                 "--mesh-dir/--env-dir and excludes --synthetic and "
                 "--cache-batches")
    if args.scene_bank and (args.synthetic or args.cache_batches
                            or args.render_in_step):
        ap.error("--scene-bank subsumes --render-in-step and excludes "
                 "--synthetic/--cache-batches (it draws fresh scenes from "
                 "the device-resident bank every step)")
    if not args.synthetic and not (args.mesh_dir and args.env_dir):
        ap.error("give --mesh-dir and --env-dir, or --synthetic")
    sd_files = (args.sd_unet, args.sd_vae, args.sd_text)
    if any(sd_files) and not all(sd_files):
        ap.error("--sd-unet requires --sd-vae and --sd-text (the port "
                 "installs all three stacks together)")

    from unirenderer_tpu_torch.parallel.mesh import initialize_distributed
    from unirenderer_tpu_torch.utils.runtime import (
        disable_tf32, kernel_launches, setup_runtime,
    )
    device = setup_runtime(args.device)
    initialize_distributed(device=device)

    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import (
        CheckpointManager, load_params_npz,
    )
    from unirenderer_tpu_torch.train.trainer import (
        Trainer, rendered_batches, synthetic_batches,
    )

    name = "tiny" if args.tiny else args.config
    cfg = getattr(config, name)()
    # tools/train.py's type
    dtype = "bfloat16" if name == "flagship" else "float32"
    if dtype == "float32":
        disable_tf32()
    print(f"[train] compute {dtype} on {device}", flush=True)
    over = {"compute_dtype": dtype}
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
    if args.optimizer:
        over["optimizer"] = args.optimizer
    if args.checkpoint_every:
        over["checkpoint_every"] = args.checkpoint_every
    if args.validation_every:
        over["validation_every"] = args.validation_every
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **over))
    data_over = {}
    if args.random_camera:
        data_over["random_camera"] = True
    if args.resolution:        # the in-step render reads cfg.data.resolution
        data_over["resolution"] = args.resolution
    if data_over:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, **data_over))

    meshes = envs = None
    if not args.synthetic:
        meshes, envs = data_paths(args.mesh_dir, args.env_dir)
        if not (meshes and envs):
            ap.error("no preprocessed meshes/envs found")
    bank = None
    if args.scene_bank:
        from unirenderer_tpu_torch.data.scene_bank import (
            bank_bytes, bank_sizes, load_scene_bank,
        )
        bank = load_scene_bank(args.mesh_dir, args.env_dir, cfg.data)
        n_m, n_e = bank_sizes(bank)
        print(f"[train] scene bank: {n_m} meshes, {n_e} envs, "
              f"{bank_bytes(bank) / 1e6:.0f} MB device-resident")

    trainer = Trainer(cfg, args.workdir, device=device,
                      report_to=tuple(args.report_to.split(",")),
                      render_in_step=args.render_in_step, scene_bank=bank,
                      bank_augment=not args.no_augment, fsdp=args.fsdp)
    if args.vae_ckpt:
        if args.vae_ckpt.endswith(".npz"):
            vae_flat, vstep = load_params_npz(args.vae_ckpt)
        else:
            vcm = CheckpointManager(args.vae_ckpt)
            vae_flat, vstep = vcm.restore_params(), vcm.restored_step()
            if vae_flat is None:
                ap.error(f"no checkpoint under {args.vae_ckpt}")
        trainer.install_vae(vae_flat)
        print(f"[train] frozen VAE from {args.vae_ckpt} step {vstep}")
    if args.init_params:
        dual_flat, pstep = load_params_npz(args.init_params)
        trainer.install_dual(dual_flat)
        print(f"[train] warm-start dual params from {args.init_params} "
              f"(step {pstep})")
    if args.sd_unet:
        from unirenderer_tpu_torch.models import surgery
        ported = surgery.port_sd_checkpoint(
            *(surgery.load_torch_state_dict(f) for f in sd_files), cfg,
            device=trainer.device)
        trainer.install_ported(*ported)
        del ported
        print(f"[train] SD weights ported from {', '.join(sd_files)}")

    # the global batch; each rank makes and trains on its own rows
    from unirenderer_tpu_torch.parallel.mesh import host_local_batch_slice
    batch = cfg.train.batch_size_per_device * trainer.dp
    rows = host_local_batch_slice(batch, trainer.mesh)
    res = args.resolution or cfg.data.resolution
    batches = None
    if args.synthetic:
        batches = synthetic_batches(cfg, batch, device=trainer.device,
                                    rows=rows)
    elif not args.scene_bank:
        from unirenderer_tpu_torch.data.objaverse import (
            ObjaverseData, stack_scene,
        )
        ds = ObjaverseData(cfg.data, meshes, envs)
        if args.render_in_step:
            from unirenderer_tpu_torch.data.input_pipeline import (
                input_pipeline,
            )
            batches = input_pipeline(
                ds, cfg.train.batch_size_per_device, collate=stack_scene,
                process_index=trainer.rank, process_count=trainer.dp)
        else:
            # the collate in the loop: a prefetch thread measured no
            # faster at flagship width (the step's host work and the
            # collate's share one interpreter)
            batches = rendered_batches(ds, batch, res, cfg.data.ssaa,
                                       device=trainer.device, rows=rows)
    if args.cache_batches:
        from unirenderer_tpu_torch.data.input_pipeline import (
            cached_batch_source,
        )
        cache_dir = args.cache_dir
        if cache_dir and trainer.dp > 1:
            cache_dir = os.path.join(cache_dir,
                                     f"rank{trainer.rank}-of-{trainer.dp}")
        batches = cached_batch_source(batches, args.cache_batches,
                                      cache_dir=cache_dir,
                                      expect_batch=rows.stop - rows.start,
                                      expect_resolution=res)

    validation_fn = None
    if args.validation:
        from unirenderer_tpu_torch.eval.validation import make_validation_fn
        if args.synthetic:
            val_batch = next(synthetic_batches(cfg, 1, seed=999,
                                               device=trainer.device))
        else:
            from unirenderer_tpu_torch.data.objaverse import (
                ObjaverseDataTest, collate_render,
            )
            vds = ObjaverseDataTest(cfg.data, meshes, envs, seed=4321)
            val_batch = collate_render([vds[0]], resolution=res,
                                       ssaa=cfg.data.ssaa,
                                       device=trainer.device)
        validation_fn = make_validation_fn(
            trainer, val_batch, os.path.join(args.workdir, "validation"),
            num_steps=10, ensemble=1, logger=trainer.logger)

    start = trainer.maybe_resume()
    if start:
        print(f"[train] resumed from step {start}")
    state = trainer.train(batches, max_steps=args.steps,
                          validation_fn=validation_fn)
    print(f"finished at step {state.step}; metrics in "
          f"{trainer.metrics_path}, checkpoints in {trainer.ckpt_dir}")
    print(f"[train] kernel launches {json.dumps(kernel_launches())}",
          flush=True)
    if trainer.mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
