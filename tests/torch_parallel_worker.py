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
# the sharded cases again with Adafactor, 2 steps each, at a learning
# rate whose updates stand well above the parameters' 1e-5 tolerance
ADAFACTOR_CASES = {2: ("fsdp", "tp", "tp_fsdp"), 4: ("tp_fsdp_2x2",)}
ADAFACTOR_STEPS = 2
ACCUMULATION = 2        # FSDP + Adafactor under MultiSteps: 2 calls, 1 update
ADAFACTOR_LR = 1e-3
BRANCHES = ("forward", "inverse")
GLOBAL_BATCH = 4
FSDP_MIN_SIZE = 256
SERVE_BATCH = 4

# the sharded Adafactor alone: name -> (torch shape, flax permutation,
# torch dimension cut over the world or None, blocks)
OPT_TENSORS = {
    # flax (256, 384) factors (d1, d0) = (0, 1): cut on d0, then on d1
    "kernel_d0": ((384, 256), (1, 0), 0, 1),
    "kernel_d1": ((384, 256), (1, 0), 1, 1),
    # flax (3, 3, 320, 640) factors (2, 3); a quarter, (3, 3, 320, 160),
    # would factor (3, 2)
    "conv": ((640, 320, 3, 3), (2, 3, 1, 0), 0, 1),
    # flax (3, 3, 256, 384): a half, (3, 3, 256, 192), would factor (3, 2);
    # a quarter, (3, 3, 256, 96), not at all
    "conv_flip": ((384, 256, 3, 3), (2, 3, 1, 0), 0, 1),
    # flax (64, 512): the second largest under 128, a full `v`
    "unfactored": ((512, 64), (1, 0), 0, 1),
    "vector": ((1024,), None, 0, 1),
    # TP's GEGLU proj (flax (256, 1024)) and its bias: 2 blocks
    "geglu_proj": ((1024, 256), (1, 0), 0, 2),
    "geglu_bias": ((1024,), None, 0, 2),
    "replicated": ((200, 300), (1, 0), None, 1),
}
OPT_STEPS = 3
OPT_LR = 0.05
OPT_WD = 1e-3
OPT_CLIP = 0.5           # below the updates' RMS: the clip is active
OPT_CHUNKS = (None, 1 << 14)   # the default; chunks of 2^14 local elements


def optimizer_case_tensors(seed: int = 3):
    """The full parameters (torch layout) and each step's full gradients,
    with row and column scales so the factors matter: the same numbers in
    every process."""
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(shape).astype(np.float32)
              for n, (shape, *_) in OPT_TENSORS.items()}
    grads = []
    for _ in range(OPT_STEPS):
        g = {}
        for n, (shape, *_) in OPT_TENSORS.items():
            z = rng.standard_normal(shape)
            z *= np.exp(rng.standard_normal((shape[0],) + (1,) * (
                len(shape) - 1)))
            z *= np.exp(rng.standard_normal(shape[-1]))
            g[n] = z.astype(np.float32)
        grads.append(g)
    return params, grads


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


def with_optimizer(cfg, optimizer: str, accumulation: int = 1):
    """`cfg` training with `optimizer` (Adafactor at ADAFACTOR_LR) and
    `accumulation` micro-steps an update."""
    import dataclasses
    over = dict(optimizer=optimizer, gradient_accumulation_steps=accumulation)
    if optimizer == "adafactor":
        over["learning_rate"] = ADAFACTOR_LR
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **over))


def _step(kind: str, is_inverse: bool, optimizer: str = "adamw",
          steps: int = 1, accumulation: int = 1):
    """`steps` train steps of `kind` ("single" without a process group),
    each on a batch and draws of its own, `accumulation` an update ->
    (the last step's loss and grad norm, the full updated masters, the
    full gradients the optimizer was handed last, as floats and numpy;
    the number of tensor-parallel linears in the model; every step's
    (loss, grad norm, the full gradients the optimizer was handed in it
    or None))."""
    from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.train_step import (
        create_train_state, make_train_step,
    )
    cfg, dual, vae, ctx = tiny_models()
    cfg = with_optimizer(cfg, optimizer, accumulation)
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
    seen = _record_grads(state)
    sh = state.sharding
    history = []
    for i in range(steps):
        batch, draws = step_inputs(cfg, is_inverse, seed=5 + i)
        handed = len(seen)
        metrics = step(state, ctx, batch, draws)
        grads = None
        if len(seen) > handed:
            grads = seen[handed:]
            if sh is not None:
                grads = [sh.gather(n, g) for n, g in zip(sh.names, grads)]
            grads = {k: g.numpy().copy() for k, g in zip(state.params, grads)}
        history.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                        grads))
    params = state.params if sh is None else sh.full_params(state.params)
    tp_linears = sum(isinstance(m, (pm.ColumnParallelLinear,
                                    pm.RowParallelLinear))
                     for m in dual.modules())
    loss, gnorm, grads = history[-1]
    return (loss, gnorm,
            {k: v.detach().numpy().copy() for k, v in params.items()},
            grads, tp_linears, history)


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


def _trainer_steps(workdir: str, fsdp: bool = False,
                   optimizer: str = "adamw", steps: int = 2, skip: int = 0,
                   save_after: int = 0):
    """`steps` synthetic steps of a tiny() Trainer over global batches of 4
    (after `skip` batches; saved after step `save_after`), each rank given
    only its rows of them (`host_local_batch_slice`), after resuming from
    `workdir`'s newest checkpoint -> (the losses, the Trainer)."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.trainer import (
        Trainer, synthetic_batches,
    )
    cfg = with_optimizer(config.tiny(), optimizer)
    tr = Trainer(cfg, workdir, device="cpu", fsdp=fsdp)
    tr.maybe_resume()
    batches = synthetic_batches(cfg, GLOBAL_BATCH, device="cpu",
                                rows=pm.host_local_batch_slice(GLOBAL_BATCH))
    for _ in range(skip):
        next(batches)
    losses = []
    for i in range(steps):
        losses.append(float(tr.step(next(batches))["loss"]))
        if i + 1 == save_after:
            tr.save(blocking=True)
    return losses, tr


def _full_params(tr):
    return {k: v.detach().numpy().copy() for k, v in tr.full_params().items()}


def _fsdp_checkpoint(workdir: str, optimizer: str = "adamw"):
    """A Trainer with FSDP, 2 synthetic steps, saved -> the losses and the
    full state it saved (params and optimizer state)."""
    losses, tr = _trainer_steps(workdir, fsdp=True, optimizer=optimizer,
                                save_after=2)
    st = tr.resume_state()
    sharded = sum(1 for n in tr.state.sharding.layout)
    return _full_params(tr), st, sharded, losses


def _world_one_run(workdir: str):
    """Before the process group: a tiny() Adafactor Trainer of one process
    takes 3 steps, saving after the second -> (its third loss, the masters
    after it)."""
    losses, tr = _trainer_steps(workdir, optimizer="adafactor", steps=3,
                                save_after=2)
    return losses[2], _full_params(tr)


def _resume_at_world_two(workdir: str):
    """The third step of `_world_one_run`, resumed from its checkpoint by
    FSDP ranks -> (its loss, the masters after it)."""
    losses, tr = _trainer_steps(workdir, fsdp=True, optimizer="adafactor",
                                steps=1, skip=2)
    assert tr.state.step == 3
    return losses[0], _full_params(tr)


def _gather_full(local: torch.Tensor, dim: int, blocks: int) -> torch.Tensor:
    """The whole tensor of every rank's piece along `dim` (world)."""
    from unirenderer_tpu_torch.parallel import mesh as pm
    pieces = [torch.empty_like(local) for _ in range(
        torch.distributed.get_world_size())]
    torch.distributed.all_gather(pieces, local.contiguous())
    return pm.join_blocks(pieces, dim, blocks)


def _sharded_adafactor(chunk):
    """OPT_STEPS updates of `train/adafactor.Adafactor` on this rank's
    pieces of OPT_TENSORS (chunks of `chunk` elements, None: the default)
    -> {name: (the full parameter, its statistics: v_row and v_col as the
    rank holds them, v gathered)}, numpy, flax layout for the
    statistics."""
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train import adafactor as af
    world, rank = torch.distributed.get_world_size(), \
        torch.distributed.get_rank()
    full, grads = optimizer_case_tensors()

    def cut(name, t):
        _, _, dim, blocks = OPT_TENSORS[name]
        return t if dim is None else pm.split_blocks(t, dim, blocks, world,
                                                     rank)

    params = {n: torch.nn.Parameter(cut(n, torch.from_numpy(v)).clone())
              for n, v in full.items()}
    splits = {n: None if dim is None else af.Split(dim, world, rank, None,
                                                   blocks)
              for n, (_, _, dim, blocks) in OPT_TENSORS.items()}
    default = af.CHUNK_ELEMENTS
    af.CHUNK_ELEMENTS = chunk or default
    try:
        opt = af.Adafactor([(p, OPT_TENSORS[n][1], splits[n])
                            for n, p in params.items()], lr=OPT_LR,
                           weight_decay_rate=OPT_WD,
                           clipping_threshold=OPT_CLIP)
        for g in grads:
            for n, p in params.items():
                p.grad = cut(n, torch.from_numpy(g[n]))
            opt.step()
    finally:
        af.CHUNK_ELEMENTS = default
    out = {}
    for n, p in params.items():
        _, perm, dim, blocks = OPT_TENSORS[n]
        p = p.detach()
        st = dict(opt.state[params[n]])
        if dim is not None:
            p = _gather_full(p, dim, blocks)
            if "v" in st:
                fdim = dim if perm is None else perm.index(dim)
                st["v"] = _gather_full(st["v"], fdim, blocks)
        out[n] = (p.numpy().copy(), {k: v.numpy().copy() for k, v in
                                     st.items() if k != "step"})
    return out


def run(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from unirenderer_tpu_torch.parallel import mesh as pm
    pm.FSDP_MIN_SIZE = FSDP_MIN_SIZE        # FSDP splits tiny()'s tensors
    if world == 2:          # each rank its own copy of one process's run
        one_dir = os.path.join(out, f"world_one_rank{rank}")
        one = _world_one_run(one_dir)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    res = {}
    try:
        for chunk in OPT_CHUNKS:
            res[("optimizer", chunk)] = _sharded_adafactor(chunk)
        for kind in STEP_CASES[world]:
            for branch in BRANCHES:
                res[(kind, branch)] = _step(kind, branch == "inverse")
        for kind in ADAFACTOR_CASES[world]:
            for branch in BRANCHES:
                res[(kind, branch, "adafactor")] = _step(
                    kind, branch == "inverse", "adafactor", ADAFACTOR_STEPS)
        if world == 2:
            res["accumulation"] = _step("fsdp", False, "adafactor",
                                        ACCUMULATION, ACCUMULATION)
            for mesh_kind in ("dp", "tp"):
                res[("serve", mesh_kind)] = _serve(mesh_kind)
            res["checkpoint"] = _fsdp_checkpoint(os.path.join(out, "ckpt"))
            res["checkpoint_adafactor"] = _fsdp_checkpoint(
                os.path.join(out, "ckpt_adafactor"), "adafactor")
            res["world_one"] = one
            res["resumed"] = _resume_at_world_two(one_dir)
            res["bank"] = _bank_step(os.path.join(out, "bank"), world)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def single_process_cases():
    """The single-process references: each branch's step (AdamW, and 2
    Adafactor steps), a request, a scene-bank Trainer step and two
    synthetic Trainer steps with each optimizer."""
    import tempfile
    res = {("single", b): _step("single", b == "inverse") for b in BRANCHES}
    for b in BRANCHES:
        res[("single", b, "adafactor")] = _step(
            "single", b == "inverse", "adafactor", ADAFACTOR_STEPS)
    res["accumulation"] = _step("single", False, "adafactor", ACCUMULATION,
                                ACCUMULATION)
    res[("serve", "single")] = _serve("single")
    with tempfile.TemporaryDirectory() as tmp:
        res["bank"] = _bank_step(os.path.join(tmp, "bank"))
        res["trainer"] = _trainer_steps(os.path.join(tmp, "trainer"))[0]
        res["trainer_adafactor"] = _trainer_steps(
            os.path.join(tmp, "trainer_adafactor"), optimizer="adafactor")[0]
    return res
