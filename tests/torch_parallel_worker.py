"""The ranks of tests/test_torch_parallel.py: every multi-rank case of one
world layout runs in one `torch.multiprocessing` spawn of gloo CPU ranks
at one torch thread each; each rank writes its results to
`<out>/rank<r>.pt` and the tests read them.  No JAX here: the ranks
import the port only.

`single_process_cases` computes the same cases in one process (no
process group), the reference the tests hold the ranks to.
"""

from __future__ import annotations

import os

import numpy as np
import torch

STEP_CASES = {2: ("dp", "fsdp", "tp", "tp_fsdp"), 4: ("tp_fsdp_2x2",)}
BRANCHES = ("forward", "inverse")
GLOBAL_BATCH = 4
FSDP_MIN_SIZE = 256
SERVE_BATCH = 4


def tiny_models(seed: int = 0):
    """The tiny() config, its dual stream (f32 masters), VAE and a context,
    filled from a seeded generator: the same numbers in every process."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
    from unirenderer_tpu_torch.models.vae import AutoencoderKL
    from unirenderer_tpu_torch.pipelines import fill_random_
    cfg = config.tiny()
    gen = torch.Generator().manual_seed(seed)
    dual, vae = DualStreamModel(cfg.unet), AutoencoderKL(cfg.vae)
    fill_random_(dual, gen)
    fill_random_(vae, gen)
    vae.requires_grad_(False)
    ctx = torch.randn((1, cfg.text.max_length, cfg.unet.cross_attention_dim),
                      generator=gen)
    return cfg, dual, vae, ctx


def step_inputs(cfg, is_inverse: bool, seed: int = 5):
    """The global batch (uniform maps) and the step's draws."""
    from unirenderer_tpu_torch.train.train_step import BATCH_KEYS, draw
    rng = np.random.default_rng(seed)
    hw = cfg.vae.sample_size
    batch = {k: torch.from_numpy(rng.uniform(
        -1, 1, (GLOBAL_BATCH, hw, hw, 3)).astype(np.float32))
        for k in BATCH_KEYS}
    h = hw // cfg.vae.downscale
    draws = draw(torch.Generator().manual_seed(seed), GLOBAL_BATCH, (h, h),
                 cfg.diffusion.num_train_timesteps, is_inverse)
    return batch, draws


def _record_grads(state):
    """Make `state`'s optimizer record the gradients it is handed (after
    the clip; on a rank its masters' pieces) -> the list they go to."""
    seen = []
    step = state.optimizer.step

    def recording_step(*args, **kwargs):
        seen.extend(p.grad.detach().clone() for p in state.params.values())
        return step(*args, **kwargs)

    state.optimizer.step = recording_step
    return seen


def _step(kind: str, is_inverse: bool):
    """One train step of `kind` ("single" without a process group) ->
    (loss, grad norm, the full updated masters, the full gradients the
    optimizer was handed, as floats and numpy; the number of
    tensor-parallel linears in the model)."""
    from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.train_step import (
        create_train_state, make_train_step,
    )
    cfg, dual, vae, ctx = tiny_models()
    schedule = DiffusionSchedule.create(cfg.diffusion)
    base = make_train_step(cfg, dual, vae, schedule, torch.float32)
    if kind == "single":
        step, state = base, create_train_state(cfg, dual)
    elif kind in ("dp", "fsdp"):
        step, state = pm.make_sharded_train_step(
            cfg, dual, base, pm.make_mesh(), fsdp=kind == "fsdp")
    else:
        world = torch.distributed.get_world_size()
        dp, mp = {"tp": (1, world), "tp_fsdp": (world, 1),
                  "tp_fsdp_2x2": (2, 2)}[kind]
        step, state = pm.make_tp_train_step(
            cfg, dual, base, pm.make_mesh_2d(dp, mp), fsdp=kind != "tp")
    batch, draws = step_inputs(cfg, is_inverse)
    grads = _record_grads(state)
    metrics = step(state, ctx, batch, draws)
    sh = state.sharding
    params = state.params if sh is None else sh.full_params(state.params)
    if sh is not None:
        grads = [sh.gather(n, g) for n, g in zip(sh.names, grads)]
    tp_linears = sum(isinstance(m, (pm.ColumnParallelLinear,
                                    pm.RowParallelLinear))
                     for m in dual.modules())
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            {k: v.detach().numpy().copy() for k, v in params.items()},
            {k: g.numpy().copy() for k, g in zip(params, grads)},
            tp_linears)


def _serve(mesh_kind: str):
    """A forward request of the tiny() pipeline, 2 steps, batch 4."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    cfg = config.tiny()
    pipe = UniRendererPipeline.create(cfg, torch.Generator().manual_seed(0),
                                      device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    s = cfg.vae.sample_size
    maps = {k: torch.from_numpy(rng.uniform(-1, 1, (SERVE_BATCH, s, s, 3))
                                .astype(np.float32))
            for k in ("normal", "albedo", "spec_light", "diff_light", "env",
                      "mask")}
    kwargs = dict(**maps, metallic=torch.full((SERVE_BATCH,), 0.4),
                  roughness=torch.full((SERVE_BATCH,), 0.6),
                  generator=torch.Generator().manual_seed(2), num_steps=2)
    call = lambda method, **kw: method(**kw)            # noqa: E731
    if mesh_kind == "dp":
        call = pm.shard_pipeline(pipe, pm.make_mesh())
    elif mesh_kind == "tp":
        world = torch.distributed.get_world_size()
        call = pm.shard_pipeline(pipe, pm.make_mesh_2d(1, world))
    return call(pipe.mask2image_3mod_albedo, **kwargs).numpy()


def _bank_step(workdir: str, world: int = 1):
    """One scene-bank step of a tiny() Trainer on a global batch of 4
    (`batch_size_per_device` 4 / world; DP over the ranks under a process
    group: the bank whole on every rank, the drawn scenes split) ->
    (loss, grad norm)."""
    import dataclasses

    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.data.scene_bank import synthetic_bank
    from unirenderer_tpu_torch.train.trainer import Trainer
    cfg = config.tiny()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size_per_device=GLOBAL_BATCH // world))
    tr = Trainer(cfg, workdir, device="cpu",
                 scene_bank=synthetic_bank(cfg.data))
    m = tr.step()
    return float(m["loss"]), float(m["grad_norm"])


def _trainer_steps(workdir: str, fsdp: bool = False):
    """2 synthetic steps of a tiny() Trainer over global batches of 4, each
    rank given only its rows of them (`host_local_batch_slice`) -> (the
    losses, the Trainer)."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.trainer import (
        Trainer, synthetic_batches,
    )
    cfg = config.tiny()
    tr = Trainer(cfg, workdir, device="cpu", fsdp=fsdp)
    batches = synthetic_batches(cfg, GLOBAL_BATCH, device="cpu",
                                rows=pm.host_local_batch_slice(GLOBAL_BATCH))
    losses = [float(tr.step(next(batches))["loss"]) for _ in range(2)]
    return losses, tr


def _fsdp_checkpoint(workdir: str):
    """A Trainer with FSDP, 2 synthetic steps, saved -> the losses and the
    full state it saved (params and optimizer state)."""
    losses, tr = _trainer_steps(workdir, fsdp=True)
    tr.save(blocking=True)
    params = {k: v.detach().numpy().copy()
              for k, v in tr.full_params().items()}
    st = tr.resume_state()
    sharded = sum(1 for n in tr.state.sharding.layout)
    return params, st, sharded, losses


def run(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from unirenderer_tpu_torch.parallel import mesh as pm
    pm.FSDP_MIN_SIZE = FSDP_MIN_SIZE        # FSDP splits tiny()'s tensors
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    res = {}
    try:
        for kind in STEP_CASES[world]:
            for branch in BRANCHES:
                res[(kind, branch)] = _step(kind, branch == "inverse")
        if world == 2:
            for mesh_kind in ("dp", "tp"):
                res[("serve", mesh_kind)] = _serve(mesh_kind)
            res["checkpoint"] = _fsdp_checkpoint(os.path.join(out, "ckpt"))
            res["bank"] = _bank_step(os.path.join(out, "bank"), world)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def single_process_cases():
    """The single-process references: each branch's step, a request, a
    scene-bank Trainer step and two synthetic Trainer steps."""
    import tempfile
    res = {("single", b): _step("single", b == "inverse") for b in BRANCHES}
    res[("serve", "single")] = _serve("single")
    with tempfile.TemporaryDirectory() as tmp:
        res["bank"] = _bank_step(os.path.join(tmp, "bank"))
        res["trainer"] = _trainer_steps(os.path.join(tmp, "trainer"))[0]
    return res
