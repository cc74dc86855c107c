"""Validation during training (counterpart of
`unirenderer_tpu/eval/validation.py`): the inverse pipeline on held-out
photos with the trainer's current parameters, the maps written as images
and each map's PSNR against its ground truth.

The masters are f32 and the card's kernels take bf16 only, so the run
uses copies of the masters cast to the trainer's compute type, installed
in the dual-stream module for its duration (`train_step.use_params`),
without a gradient and in eval mode; afterwards the masters and the
module's mode are as they were.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from unirenderer_tpu_torch.eval.metrics import psnr

VALIDATION_MAPS = ("normal", "albedo", "spec_light", "diff_light", "env")


def make_validation_fn(trainer, val_batch: Mapping, out_dir: str,
                       num_steps: int = 20, ensemble: int = 1,
                       logger=None, noise_seed: Optional[int] = None):
    """-> validation_fn(state, step) -> {psnr_<map>: dB} for
    `Trainer.train(validation_fn=...)`.  `val_batch`: 'image' and 'mask',
    and optionally the ground-truth maps, each (B, H, W, 3) in [-1, 1].
    The run's noise comes from a generator on the trainer's device seeded
    with `noise_seed` (default: the step).  Writes
    `<out_dir>/step-<step>/<map>.png` (the first image of each map).
    Under a process group every rank calls it (the sharded masters are
    gathered) and rank 0 alone samples, writes and returns the PSNRs."""
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    from unirenderer_tpu_torch.train.train_step import use_params
    os.makedirs(out_dir, exist_ok=True)
    pipe = UniRendererPipeline(trainer.cfg, trainer.dual, trainer.vae,
                               trainer.text, device=trainer.device)
    dual = trainer.dual

    def validation_fn(state, step: int) -> Dict[str, float]:
        params = (state.params if state.sharding is None
                  else state.sharding.full_params(state.params))
        if trainer.rank != 0:       # rank 0 samples and writes
            return {}
        compute = {n: p.detach().to(trainer.compute_dtype)
                   for n, p in params.items()}
        seed = step if noise_seed is None else noise_seed
        gen = torch.Generator(device=trainer.device).manual_seed(seed)
        was_training = dual.training
        dual.eval()
        try:
            with torch.no_grad(), use_params(dual, compute):
                out = pipe.real_image2mask_3mod_albedo(
                    image=val_batch["image"], mask=val_batch["mask"],
                    generator=gen, num_steps=num_steps, ensemble=ensemble)
        finally:
            dual.train(was_training)
        metrics = {}
        step_dir = os.path.join(out_dir, f"step-{step}")
        os.makedirs(step_dir, exist_ok=True)
        for name in VALIDATION_MAPS:
            pred01 = (out[name].float().cpu().numpy() + 1.0) / 2.0
            save_png(os.path.join(step_dir, f"{name}.png"), pred01[0])
            if name in val_batch:
                gt = val_batch[name]
                gt = gt.float().cpu().numpy() if isinstance(
                    gt, torch.Tensor) else np.asarray(gt, np.float32)
                metrics[f"psnr_{name}"] = psnr(pred01, (gt + 1.0) / 2.0)
        if logger is not None:
            logger.log(step, metrics)
        return metrics

    return validation_fn


def save_png(path: str, arr01: np.ndarray) -> None:
    """An (H, W, 3) image in [0, 1] as an 8-bit PNG (an .npy beside the
    name when PIL is missing)."""
    try:
        from PIL import Image
        Image.fromarray((np.clip(arr01, 0, 1) * 255).astype(np.uint8)).save(
            path)
    except ImportError:
        np.save(path + ".npy", arr01)
