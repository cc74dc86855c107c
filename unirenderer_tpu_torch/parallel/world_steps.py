"""Train steps of the dual stream under each sharding of
`parallel/mesh.py`, one process a card, at the world size torchrun gives:

    torchrun --nproc_per_node 4 \\
        -m unirenderer_tpu_torch.parallel.world_steps [--out world4.json] \\
        [--optimizer adafactor]

    # a rehearsal on the CPU (gloo), tiny() widths:
    torchrun --nproc_per_node 4 \\
        -m unirenderer_tpu_torch.parallel.world_steps --config tiny \\
        --device cpu

Every variant trains on the same global batch (2 samples x the world)
from the same seeded weights, smooth maps and draws: DP and FSDP over
every rank, and on an even world TP and TP+FSDP on a (world / 2, 2)
mesh.  For each: a forward and an inverse step, each from the initial
weights, whose loss is held against one process's loss of the same global
batch (no gradient) and whose gradient norm against DP's, both within
1e-3 relative; then `--warm` rounds of both branches, of which the best
s/step of each is kept (the slowest rank's wall a step); and the largest
peak memory of any rank.  Rank 0 prints one JSON object as its last line
(and writes it to `--out`); a disagreement exits non-zero.  On the card
the step is the flagship recipe's: bf16 compute, remat, AdamW, or with
`--optimizer adafactor` Adafactor (its factored statistics whole on every
rank, summed over the split dimension's group).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

REL = 1e-3           # loss vs one process, gradient norm vs DP
SEED = 14
BATCH_PER_RANK = 2   # the flagship recipe's batch a card


def smooth_maps(batch: int, res: int, seed: int, device):
    """The 8 training maps, smooth fields in [-1, 1], the same on every
    rank."""
    from unirenderer_tpu_torch.train.train_step import BATCH_KEYS
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k in BATCH_KEYS:
        z = torch.randn((batch, 3, 16, 16), generator=gen)
        z = F.interpolate(z, size=(res, res), mode="bilinear",
                          align_corners=False)
        out[k] = torch.tanh(z).permute(0, 2, 3, 1).contiguous().to(device)
    return out


def _max_over_ranks(x: float, device) -> float:
    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("tiny", "small", "flagship"),
                    default="flagship")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"),
                    default="adamw")
    ap.add_argument("--device", help="default: $UNIRENDER_PLATFORM, else "
                                     "cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule
    from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
    from unirenderer_tpu_torch.models.vae import AutoencoderKL
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.train_step import (
        draw, make_loss_fn, make_train_step,
    )
    from unirenderer_tpu_torch.train.trainer import (
        _build, resolve_compute_dtype,
    )
    from unirenderer_tpu_torch.utils.runtime import setup_runtime

    device = setup_runtime(args.device)
    if not pm.initialize_distributed(device=device):
        print("run under torchrun", file=sys.stderr)
        return 2
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = getattr(config, args.config)()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer=args.optimizer))
    dtype = resolve_compute_dtype(cfg.train, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.device("meta"):
        vae = AutoencoderKL(cfg.vae)
    vae = _build(vae, device, dtype, gen).eval()
    vae.requires_grad_(False)
    ctx = torch.randn((1, cfg.text.max_length, cfg.unet.cross_attention_dim),
                      generator=gen, device=device).to(dtype)
    schedule = DiffusionSchedule.create(cfg.diffusion, device)
    res = cfg.vae.sample_size
    h = res // cfg.vae.downscale
    b = BATCH_PER_RANK * world
    kinds = (False, True) + (False, True) * args.warm
    batches = [smooth_maps(b, res, SEED + i, device)
               for i in range(len(kinds))]
    draws = [draw(torch.Generator().manual_seed(SEED + i), b, (h, h),
                  cfg.diffusion.num_train_timesteps, inv).to(device)
             for i, inv in enumerate(kinds)]

    def fresh_dual():
        with torch.device("meta"):
            dual = DualStreamModel(cfg.unet)
        return _build(dual, device, torch.float32, torch.Generator(
            device=device).manual_seed(SEED)).train()

    # one process's loss of each compared step's global batch
    dual = fresh_dual()
    loss_fn = make_loss_fn(cfg, dual, vae, schedule)
    with torch.no_grad():
        compute = {n: p.to(dtype) for n, p in dual.named_parameters()}
        ref_loss = [float(loss_fn(compute, batches[i], ctx, draws[i])[0])
                    for i in range(2)]
    del dual, compute, loss_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()

    variants = [("dp", None, False), ("fsdp", None, True)]
    if world % 2 == 0:
        variants += [("tp", (world // 2, 2), False),
                     ("tp_fsdp", (world // 2, 2), True)]
    out, ok = {}, True
    for name, shape, fsdp in variants:
        t = time.perf_counter()
        dual = fresh_dual()
        base = make_train_step(cfg, dual, vae, schedule, dtype)
        if shape is None:
            step, state = pm.make_sharded_train_step(
                cfg, dual, base, pm.make_mesh(), fsdp=fsdp)
        else:
            step, state = pm.make_tp_train_step(
                cfg, dual, base, pm.make_mesh_2d(*shape), fsdp=fsdp)
        init = {n: p.detach().to("cpu", copy=True)
                for n, p in state.params.items()}
        tp_linears = sum(isinstance(m, (pm.ColumnParallelLinear,
                                        pm.RowParallelLinear))
                         for m in dual.modules())
        build_s = _max_over_ranks(time.perf_counter() - t, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rows = []
        for i, inverse in enumerate(kinds):
            if i < 2:                   # the compared steps: same weights
                with torch.no_grad():
                    for n, p in state.params.items():
                        p.copy_(init[n])
            dist.barrier()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step(state, ctx, batches[i], draws[i])
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = _max_over_ranks(time.perf_counter() - t, device)
            rows.append(dict(inverse=inverse, wall_s=wall, loss=loss,
                             grad_norm=gnorm))
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        peak = _max_over_ranks(float(peak), device)
        loss_rel = max(abs(r["loss"] - q) / abs(q)
                       for r, q in zip(rows[:2], ref_loss))
        dp_rows = out["dp"]["steps"] if out else rows
        gnorm_rel = max(abs(r["grad_norm"] - q["grad_norm"]) / q["grad_norm"]
                        for r, q in zip(rows[:2], dp_rows[:2]))
        warm = {kind: min(r["wall_s"] for r in rows[2:]
                          if r["inverse"] == (kind == "inverse"))
                for kind in ("forward", "inverse")} if args.warm else {}
        good = (all(math.isfinite(r["loss"]) for r in rows)
                and loss_rel <= REL and gnorm_rel <= REL)
        ok = ok and good
        out[name] = dict(mesh=list(shape) if shape else [world],
                         fsdp=fsdp, sharded=len(state.sharding.layout),
                         tp_linears=tp_linears, build_s=build_s,
                         loss_rel_vs_one_process=loss_rel,
                         grad_norm_rel_vs_dp=gnorm_rel,
                         warm_forward_s=warm.get("forward"),
                         warm_inverse_s=warm.get("inverse"),
                         peak_gib=peak / 2 ** 30, ok=good, steps=rows)
        if rank == 0:
            print(f"[world_steps] {name}: {json.dumps(out[name])}",
                  flush=True)
        del dual, base, step, state, metrics, init
        if device.type == "cuda":
            torch.cuda.empty_cache()
    result = dict(world=world, config=args.config, optimizer=args.optimizer,
                  global_batch=b, reference_loss=ref_loss, variants=out,
                  ok=ok)
    if rank == 0:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        print(json.dumps(result), flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
