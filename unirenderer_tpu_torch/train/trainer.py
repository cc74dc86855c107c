"""The training loop (counterpart of `unirenderer_tpu/train/trainer.py`
`Trainer` on its default path: rendered batches from an iterator, no
render in the step, no scene bank).

The dual-stream model is built on the device as f32 masters from seeded
random weights (every tensor filled, the zero convs too, as
`pipelines.fill_random_` does); the VAE and the text encoder are frozen in
the compute type; the blank-prompt context is computed once.  `train`
draws each step's random numbers from a host generator seeded from
`TrainConfig.seed`, logs `metrics.jsonl` at step 1 and every 10 steps as
the JAX loop does, raises on a non-finite loss, and writes the params npz
(`core/checkpoint.save_params_npz`, the JAX package's format) every
`checkpoint_every` steps and at the end.

Not here yet (queued): resuming with optimizer state, the asynchronous
saver, validation, FSDP, `render_in_step` and the scene bank.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from unirenderer_tpu_torch.core.checkpoint import save_params_npz
from unirenderer_tpu_torch.core.config import SystemConfig, TrainConfig
from unirenderer_tpu_torch.core.convert import flax_from_module, load_flax
from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule
from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder, blank_ids
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.models.vae import AutoencoderKL
from unirenderer_tpu_torch.pipelines import fill_random_
from unirenderer_tpu_torch.train.train_step import (
    BATCH_KEYS, TrainState, create_train_state, draw, make_train_step,
)


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device with no card raises (nothing
    falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA card is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


def _build(module: torch.nn.Module, device, dtype,
           generator: torch.Generator) -> torch.nn.Module:
    module.to(dtype=dtype).to_empty(device=device)
    module.to(memory_format=torch.channels_last)
    fill_random_(module, generator)
    return module


def resolve_compute_dtype(cfg: TrainConfig,
                          device: torch.device) -> torch.dtype:
    """TrainConfig.compute_dtype on `device`: None gives bf16 on the card
    and f32 on the CPU; the card's kernels take bf16 only, so any other
    type asked for there raises."""
    if cfg.compute_dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    dtype = getattr(torch, cfg.compute_dtype)
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} on the card: "
                         "its kernels take bfloat16 only")
    return dtype


class Trainer:
    """Owns the models, the train state and the step loop on one device;
    the step computes in `resolve_compute_dtype(cfg.train, device)`."""

    def __init__(self, cfg: SystemConfig, workdir: str, device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype = resolve_compute_dtype(
            cfg.train, self.device)
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
        self.state: TrainState = create_train_state(cfg, self.dual)
        self._step = make_train_step(cfg, self.dual, self.vae, self.schedule,
                                     compute_dtype)
        # every step's random numbers, drawn on the host
        self.generator = torch.Generator().manual_seed(seed)
        self.metrics_path = os.path.join(workdir, "metrics.jsonl")
        self.ckpt_dir = os.path.join(workdir, "checkpoints")

    # ------------------------------------------------------------------
    def _blank_ctx(self) -> torch.Tensor:
        """The constant ' ' prompt's context (1, L, D), computed once."""
        with torch.no_grad():
            return self.text(blank_ids(self.cfg.text, self.device))

    def install_dual(self, flat: Mapping[str, np.ndarray]) -> int:
        """Warm-start the dual-stream masters from flax params (a params
        npz); the optimizer starts fresh."""
        with torch.no_grad():
            n = load_flax(self.dual, flat)
        self.state = create_train_state(self.cfg, self.dual)
        return n

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
    def step(self, batch: Mapping[str, torch.Tensor],
             is_inverse: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """One train step on a batch of the 8 maps (moved to the device);
        `is_inverse` forces the branch of the dual timestep draw."""
        batch = {k: batch[k].to(self.device) for k in BATCH_KEYS}
        b, h, w, _ = batch["image"].shape
        ds = self.cfg.vae.downscale
        draws = draw(self.generator, b, (h // ds, w // ds),
                     self.cfg.diffusion.num_train_timesteps, is_inverse)
        return self._step(self.state, self.ctx, batch,
                          draws.to(self.device))

    def save(self) -> str:
        """The dual-stream params as a JAX-format npz, named by step."""
        path = os.path.join(self.ckpt_dir,
                            f"params_{self.state.step:08d}.npz")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        save_params_npz(path, flax_from_module(self.dual), self.state.step)
        return path

    def train(self, batch_iterator: Iterator[Mapping[str, torch.Tensor]],
              max_steps: Optional[int] = None) -> TrainState:
        """Steps over the iterator's batches until `max_steps` (default
        TrainConfig.max_steps) updates have been taken."""
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        start = self.state.step
        with open(self.metrics_path, "a", buffering=1) as log:
            for batch in batch_iterator:
                if self.state.step >= max_steps:
                    break
                metrics = self.step(batch)
                step = self.state.step
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {step}")
                if step % 10 == 0 or step == start + 1:
                    rec = {"step": step, "time": time.time()}
                    rec.update((k, float(v)) for k, v in metrics.items())
                    log.write(json.dumps(rec) + "\n")
                if step % cfg.checkpoint_every == 0:
                    self.save()
        if self.state.step > start and \
                self.state.step % cfg.checkpoint_every != 0:
            self.save()
        return self.state


def synthetic_batches(cfg: SystemConfig, batch: int, seed: int = 0,
                      device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Random-map batches for smoke runs (no dataset): every map uniform in
    [-1, 1] at the VAE's sample size, from numpy as the JAX source draws
    them."""
    rng = np.random.default_rng(seed)
    hw = cfg.vae.sample_size
    while True:
        yield {k: torch.from_numpy(rng.uniform(-1, 1, (batch, hw, hw, 3))
                                   .astype(np.float32)).to(device)
               for k in BATCH_KEYS}


def rendered_batches(dataset, batch: int, resolution: int, ssaa: int,
                     device="cuda", seed: int = 0
                     ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of the render collate (`data/objaverse.collate_render`, K4
    on the card) over a shuffled pass of the dataset, repeated; the collate
    runs without a gradient, in the loop (no prefetch thread)."""
    from unirenderer_tpu_torch.data.objaverse import collate_render
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(dataset))
    i = 0
    while True:
        items = [dataset[int(order[(i + j) % len(order)])]
                 for j in range(batch)]
        i += batch
        with torch.no_grad():     # leave before the yield: grad mode is
            maps = collate_render(items, resolution=resolution,  # per thread
                                  ssaa=ssaa, device=device)
        yield maps
