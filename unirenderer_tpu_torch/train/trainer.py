"""The training loop (counterpart of `unirenderer_tpu/train/trainer.py`
`Trainer`).

The dual-stream model is built on the device as f32 masters from seeded
random weights (every tensor filled, the zero convs too, as
`pipelines.fill_random_` does); the VAE and the text encoder are frozen in
the compute type; the blank-prompt context is computed once.  A step's
batch comes from one of three places:

  * rendered maps from an iterator (`rendered_batches`: the render
    collate, optionally prefetched on a side stream; `synthetic_batches`;
    a cached pool);
  * `render_in_step`: stacked scenes from an iterator, rendered inside the
    step (`train_step.make_render_train_step`);
  * `scene_bank`: fresh scenes drawn every step from a bank uploaded to
    the device once (`train_step.make_bank_train_step`).

Every random number of a step (the scenes' and the step's) is drawn from
one host generator seeded from `TrainConfig.seed`.  `train` resumes from
the newest checkpoint in `<workdir>/checkpoints` (params, optimizer
state, step counters and the generator's state: a resumed run continues
the same draws), logs `metrics.jsonl` at its first step and every
`LOG_EVERY` steps (the only host reads of the metrics; `AnomalyGuard`
checks them), checkpoints every `checkpoint_every` steps through the
asynchronous saver (rotation to `checkpoints_total_limit`) and at the
end, runs `validation_fn` every `validation_every` steps, and appends
the phase timer's totals to `phases.jsonl`.

Under a process group (`parallel/mesh.initialize_distributed`, e.g. the
CLI under `torchrun`) the trainer is one rank of data-parallel training
(`fsdp=True`: FSDP) over every rank: `step` takes this rank's rows of
the global batch (`parallel/mesh.host_local_batch_slice`: each rank
renders only its own), every rank draws the global batch's random
numbers from the same generator and keeps its slice, and the step equals
the single-process step over the global batch.  The scene bank stays
whole on every rank and the drawn scenes are split.  Rank 0 logs, writes
the checkpoints, which hold the full tensors (FSDP slices gathered), so a
run resumes at any world size, and runs the validation sampling.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from unirenderer_tpu_torch.core.checkpoint import AsyncSaver, CheckpointManager
from unirenderer_tpu_torch.core.config import SystemConfig, TrainConfig
from unirenderer_tpu_torch.core.convert import (
    flax_permutations, load_flax, state_dict_from_flax,
)
from unirenderer_tpu_torch.core.debug import AnomalyGuard
from unirenderer_tpu_torch.core.tracing import MetricLogger, PhaseTimer
from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule
from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder, blank_ids
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.models.vae import AutoencoderKL
from unirenderer_tpu_torch.parallel import mesh as pmesh
from unirenderer_tpu_torch.pipelines import fill_random_
from unirenderer_tpu_torch.train.train_step import (
    BATCH_KEYS, TrainState, create_train_state, draw, make_bank_train_step,
    make_optimizer, make_render_train_step, make_train_step,
)
from unirenderer_tpu_torch.utils.runtime import resolve_device

# steps between two logged (host-read) metrics records, as the JAX loop
LOG_EVERY = 10


def _build(module: torch.nn.Module, device, dtype,
           generator: torch.Generator) -> torch.nn.Module:
    module.to(dtype=dtype).to_empty(device=device)
    module.to(memory_format=torch.channels_last)
    fill_random_(module, generator)
    return module


# the compute types the card's kernels take (f16 and f64: no JAX entry
# point computes in them)
CARD_DTYPES = ("bfloat16", "float32")


def resolve_compute_dtype(cfg: TrainConfig,
                          device: torch.device) -> torch.dtype:
    """TrainConfig.compute_dtype on `device`: None gives bf16 on the card
    (the JAX Trainer's default) and f32 on the CPU; the card takes bf16 and
    f32, the types of its kernels, and raises on any other."""
    if cfg.compute_dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    dtype = getattr(torch, cfg.compute_dtype)
    if device.type == "cuda" and cfg.compute_dtype not in CARD_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} on the card: "
                         f"its kernels take {' or '.join(CARD_DTYPES)}")
    return dtype


class Trainer:
    """Owns the models, the train state and the step loop on one device
    (one rank of a process group, when one is initialised); the step
    computes in `resolve_compute_dtype(cfg.train, device)`.  `fsdp`:
    shard the masters and optimizer state of every tensor of at least
    `mesh.FSDP_MIN_SIZE` elements over the ranks
    (`mesh.fsdp_param_sharding`; one process holds every slice)."""

    def __init__(self, cfg: SystemConfig, workdir: str, device="cuda",
                 report_to=("jsonl",), render_in_step: bool = False,
                 scene_bank: Optional[Mapping[str, np.ndarray]] = None,
                 bank_augment: bool = True, fsdp: bool = False):
        if render_in_step and scene_bank is not None:
            raise ValueError("scene_bank renders in the step already; "
                             "give render_in_step or scene_bank")
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype = resolve_compute_dtype(
            cfg.train, self.device)
        self.render_in_step = render_in_step
        os.makedirs(workdir, exist_ok=True)
        seed = cfg.train.seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.device("meta"):
            dual = DualStreamModel(cfg.unet)
            vae = AutoencoderKL(cfg.vae)
            text = CLIPTextEncoder(cfg.text)
        self.dual = _build(dual, self.device, torch.float32, gen).train()
        self.vae = _build(vae, self.device, compute_dtype, gen).eval()
        self.text = _build(text, self.device, compute_dtype, gen).eval()
        self.vae.requires_grad_(False)
        self.text.requires_grad_(False)
        self.ctx = self._blank_ctx()
        self.schedule = DiffusionSchedule.create(cfg.diffusion, self.device)
        self.mesh = None
        self.dp, self.rank = 1, 0
        if dist.is_available() and dist.is_initialized():
            self.mesh = pmesh.make_mesh()
            self.dp, self.rank = dist.get_world_size(), dist.get_rank()
            plan = pmesh.fsdp_plan(self.dual, self.dp) if fsdp else None
            self.state: TrainState = pmesh.shard_train_state(
                cfg, self.dual, self.mesh, plan)
        else:
            self.state = create_train_state(cfg, self.dual)
        args = (cfg, self.dual, self.vae, self.schedule, compute_dtype)
        self._step = self._sharded(make_train_step(*args))
        self.bank = None
        if scene_bank is not None:
            from unirenderer_tpu_torch.data.scene_bank import bank_to_device
            self.bank = bank_to_device(scene_bank, self.device)
            self._bank_step = self._sharded(
                make_bank_train_step(*args, augment=bank_augment),
                replicate_batch=True)
        elif render_in_step:
            self._render_step = self._sharded(make_render_train_step(*args))
        # every step's random numbers, drawn on the host
        self.generator = torch.Generator().manual_seed(seed)
        self.metrics_path = os.path.join(workdir, "metrics.jsonl")
        self.ckpt_dir = os.path.join(workdir, "checkpoints")
        self.ckpt = CheckpointManager(self.ckpt_dir,
                                      cfg.train.checkpoints_total_limit)
        self.logger = (MetricLogger(self.metrics_path, report_to=report_to)
                       if self.rank == 0 else None)
        self.timer = PhaseTimer(self.device)
        self.guard = AnomalyGuard()
        self._saver = AsyncSaver(self.ckpt)

    # ------------------------------------------------------------------
    def _sharded(self, step, replicate_batch: bool = False):
        return step if self.mesh is None else pmesh.shard_step(
            step, self.mesh, replicate_batch=replicate_batch)

    def _blank_ctx(self) -> torch.Tensor:
        """The constant ' ' prompt's context (1, L, D), computed once."""
        with torch.no_grad():
            return self.text(blank_ids(self.cfg.text, self.device))

    def install_dual(self, flat: Mapping[str, np.ndarray]) -> int:
        """Warm-start the dual-stream masters from flax params (a params
        npz); the optimizer starts fresh.  A checkpoint in the workdir
        still wins (`train` resumes from it)."""
        n = self._load_masters(state_dict_from_flax(flat))
        self._fresh_optimizer()
        return n

    def install_ported(self, dual: torch.nn.Module, vae: torch.nn.Module,
                       text: torch.nn.Module) -> None:
        """Install ported SD weights (`models/surgery.port_sd_checkpoint`)
        for all three stacks: the dual-stream masters (the optimizer starts
        fresh), the frozen VAE and the text encoder, and recompute the
        blank-prompt context from the ported encoder."""
        self._load_masters(dict(dual.named_parameters()))
        self._fresh_optimizer()
        with torch.no_grad():
            self.vae.load_state_dict(vae.state_dict(), strict=True)
            self.text.load_state_dict(text.state_dict(), strict=True)
        self.ctx = self._blank_ctx()

    def _load_masters(self, full: Mapping[str, torch.Tensor]) -> int:
        """The masters <- full tensors by parameter name, strictly."""
        own = dict(self.dual.named_parameters())
        missing, unused = sorted(set(own) - set(full)), sorted(
            set(full) - set(own))
        if missing or unused:
            raise KeyError(f"{len(missing)} missing {missing[:5]}, "
                           f"{len(unused)} unused {unused[:5]}")
        for k, v in full.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} vs "
                                 f"{tuple(own[k].shape)}")
        sh = self.state.sharding
        with torch.no_grad():
            if sh is None:
                for k, p in own.items():
                    p.copy_(full[k])
            else:
                sh.load_full_(self.state.params, full)
        return len(full)

    def _fresh_optimizer(self) -> None:
        s = self.state
        opt = (make_optimizer(self.cfg, s.params, flax_permutations(self.dual))
               if s.sharding is None
               else s.sharding.optimizer(self.cfg, s.params))
        self.state = TrainState(s.params, opt, sharding=s.sharding)

    def install_vae(self, flat: Mapping[str, np.ndarray]) -> int:
        """The frozen VAE from flax params."""
        with torch.no_grad():
            return load_flax(self.vae, flat)

    def install_text(self, flat: Mapping[str, np.ndarray]) -> int:
        """The text encoder from flax params; recomputes the context."""
        with torch.no_grad():
            n = load_flax(self.text, flat)
        self.ctx = self._blank_ctx()
        return n

    # ------------------------------------------------------------------
    def _latent_hw(self, resolution: int):
        ds = self.cfg.vae.downscale
        return resolution // ds, resolution // ds

    def step(self, batch: Optional[Mapping] = None,
             is_inverse: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """One train step; `is_inverse` forces the branch of the dual
        timestep draw.  `batch`: the 8 maps (moved to the device); with
        `render_in_step` a stacked scene; with a scene bank nothing (the
        step draws its scenes).  Over several ranks, this rank's rows of
        the global batch (`batch_size_per_device` x ranks; the draws are
        the global batch's)."""
        T = self.cfg.diffusion.num_train_timesteps
        if self.bank is not None:
            from unirenderer_tpu_torch.data.scene_bank import (
                bank_sizes, draw_scenes,
            )
            b = self.cfg.train.batch_size_per_device * self.dp
            scene_draws = draw_scenes(self.generator, bank_sizes(self.bank),
                                      b, self.cfg.data)
            draws = draw(self.generator, b,
                         self._latent_hw(self.cfg.data.resolution), T,
                         is_inverse)
            return self._bank_step(self.state, self.ctx, self.bank,
                                   scene_draws, draws.to(self.device))
        if self.render_in_step:
            scene = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            b = scene["v_pos"].shape[0] * self.dp
            draws = draw(self.generator, b,
                         self._latent_hw(self.cfg.data.resolution), T,
                         is_inverse)
            return self._render_step(self.state, self.ctx, scene,
                                     draws.to(self.device))
        batch = {k: torch.as_tensor(batch[k]).to(self.device)
                 for k in BATCH_KEYS}
        b, h, w, _ = batch["image"].shape
        draws = draw(self.generator, b * self.dp, self._latent_hw(h), T,
                     is_inverse)
        return self._step(self.state, self.ctx, batch,
                          draws.to(self.device))

    # ------------------------------------------------------------------
    def resume_state(self) -> Dict:
        """Everything of the training state but the params, as a
        checkpoint's `state.pt` holds it (sharded tensors gathered full: a
        collective over the ranks)."""
        s, sh = self.state, self.state.sharding
        opt, acc = s.optimizer.state_dict(), s.acc
        if sh is not None:
            opt = sh.full_optimizer_state(opt)
            acc = None if acc is None else [
                sh.gather(n, a) for n, a in zip(sh.names, acc)]
        return dict(optimizer=opt, step=s.step, updates=s.updates,
                    mini_step=s.mini_step, acc=acc,
                    generator=self.generator.get_state())

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The masters as full tensors (FSDP slices gathered: a collective
        over the ranks)."""
        sh = self.state.sharding
        return (dict(self.state.params) if sh is None
                else sh.full_params(self.state.params))

    def save(self, blocking: bool = True) -> str:
        """Checkpoint the current step (`checkpoint-<step>`: the params
        npz, JAX format, f32, and the rest of the state, full tensors);
        returns its directory.  Every rank calls it; rank 0 writes."""
        params, state = self.full_params(), self.resume_state()
        if self.rank == 0:
            self._saver.save(self.state.step, self.dual, params, state,
                             blocking=blocking)
        if blocking and self.mesh is not None:
            dist.barrier()
        return self.ckpt.step_dir(self.state.step)

    def maybe_resume(self) -> int:
        """Restore the newest readable checkpoint newer than the current
        step (params, optimizer state, counters, accumulator, generator
        state); returns the step the state is at."""
        self._saver.join()
        latest = self.ckpt.latest_step()
        if latest is None or latest <= self.state.step:
            return self.state.step
        restored = self.ckpt.restore()
        if restored is None:
            return self.state.step
        params, st = restored
        self._load_masters(state_dict_from_flax(params))
        s, sh = self.state, self.state.sharding
        opt, acc = st["optimizer"], st["acc"]
        if sh is not None:
            opt = sh.local_optimizer_state(opt, self.device)
            acc = None if acc is None else [
                sh.local(n, a) for n, a in zip(sh.names, acc)]
        s.optimizer.load_state_dict(opt)
        s.step, s.updates, s.mini_step = st["step"], st["updates"], \
            st["mini_step"]
        s.acc = (None if acc is None else [a.to(self.device) for a in acc])
        self.generator.set_state(st["generator"])
        return s.step

    def train(self, batch_iterator: Optional[Iterator[Mapping]] = None,
              max_steps: Optional[int] = None,
              validation_fn: Optional[Callable[[TrainState, int], object]]
              = None) -> TrainState:
        """Steps until `max_steps` (default TrainConfig.max_steps) steps
        have been taken, over the iterator's batches (a scene bank needs
        none), after resuming from the newest checkpoint."""
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        start = self.maybe_resume()
        if self.bank is not None:
            batch_iterator = itertools.repeat(None)
        for batch in batch_iterator:
            if self.state.step >= max_steps:
                break
            with self.timer.phase("step"):
                metrics = self.step(batch)
            step = self.state.step
            if step % LOG_EVERY == 0 or step == start + 1:
                with self.timer.phase("log", sync=True):
                    rec = (self.logger.log(step, metrics) if self.logger
                           else {k: float(v) for k, v in metrics.items()})
                    self.guard.check(rec, step)
            if step % cfg.checkpoint_every == 0:
                with self.timer.phase("checkpoint"):
                    self.save(blocking=False)
            if validation_fn is not None and \
                    step % cfg.validation_every == 0:
                with self.timer.phase("validation", sync=True):
                    validation_fn(self.state, step)
        if self.state.step > start and \
                self.state.step % cfg.checkpoint_every != 0:
            self.save(blocking=True)
        self._saver.join()
        if self.rank == 0:
            self.timer.dump(os.path.join(self.workdir, "phases.jsonl"))
        return self.state


def synthetic_batches(cfg: SystemConfig, batch: int, seed: int = 0,
                      device="cuda", rows: slice = slice(None)
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    """Random-map batches for smoke runs (no dataset): every map uniform in
    [-1, 1] at the VAE's sample size, from numpy as the JAX source draws
    them; `rows` of each batch of `batch` (a rank's
    `host_local_batch_slice`) go to the device."""
    rng = np.random.default_rng(seed)
    hw = cfg.vae.sample_size
    while True:
        yield {k: torch.from_numpy(rng.uniform(-1, 1, (batch, hw, hw, 3))
                                   .astype(np.float32)[rows]).to(device)
               for k in BATCH_KEYS}


def rendered_batches(dataset, batch: int, resolution: int, ssaa: int,
                     device="cuda", seed: int = 0, prefetch: int = 0,
                     rows: slice = slice(None)
                     ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of the render collate (`data/objaverse.collate_render`, K4
    on the card) over a shuffled pass of the dataset, repeated, without a
    gradient; only `rows` of each batch of `batch` items (a rank's
    `host_local_batch_slice`) are loaded and rendered.  `prefetch` > 0
    runs the collate that many batches ahead in a thread (on a side CUDA
    stream on the card: `data/input_pipeline.device_prefetch`); the
    batches are the same."""
    from unirenderer_tpu_torch.data.input_pipeline import device_prefetch
    from unirenderer_tpu_torch.data.objaverse import collate_render
    order = np.random.default_rng(seed).permutation(len(dataset))

    def make_batch(i):
        items = [dataset[int(order[(i * batch + j) % len(order)])]
                 for j in range(batch)[rows]]
        return collate_render(items, resolution=resolution, ssaa=ssaa,
                              device=device)

    if prefetch > 0:
        yield from device_prefetch(make_batch, device, depth=prefetch)
        return
    for i in itertools.count():
        with torch.no_grad():     # leave before the yield: grad mode is
            maps = make_batch(i)  # per thread
        yield maps
