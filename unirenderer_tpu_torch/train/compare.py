"""Agreement of one training step between two settings (device, compute
type), from the same weights, batch and draws: the relative loss error,
the cosine of the flattened gradients and the ratio of their norms.

`compare([("cuda", torch.bfloat16), ("cpu", torch.float32)])` holds the
card (bf16, the kernels) against f32 on the CPU at `small()` with the
trained r05 weights, both branches of the dual timestep draw
(`chip_smoke.py` phase 9); `[("cpu", torch.bfloat16), ("cpu",
torch.float32)]` measures the bf16 gap alone, with the plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from unirenderer_tpu_torch.core import config
from unirenderer_tpu_torch.core.checkpoint import load_params_npz
from unirenderer_tpu_torch.eval.quality import DUAL_NPZ, TEXT_NPZ, VAE_NPZ
from unirenderer_tpu_torch.train.train_step import (
    BATCH_KEYS, Draws, draw, make_grad_fn,
)
from unirenderer_tpu_torch.train.trainer import Trainer


def small_weights(root: str = ".") -> Dict[str, Mapping[str, np.ndarray]]:
    """The trained small() weights the repo carries (dual, vae, text)."""
    return {k: load_params_npz(os.path.join(root, p))[0] for k, p in
            (("dual", DUAL_NPZ), ("vae", VAE_NPZ), ("text", TEXT_NPZ))}


def trainer_with(cfg, weights, device, dtype: torch.dtype,
                 workdir) -> Trainer:
    """A Trainer computing in `dtype`, with every weight loaded strictly."""
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype=str(dtype).removeprefix("torch.")))
    tr = Trainer(cfg, workdir, device=device)
    tr.install_dual(weights["dual"])
    tr.install_vae(weights["vae"])
    tr.install_text(weights["text"])
    return tr


def step_grads(tr: Trainer, batch: Mapping[str, torch.Tensor],
               draws: Draws) -> Tuple[torch.Tensor, float]:
    """(all gradients flattened, f64 on the host; the loss) of one step."""
    grad_fn = make_grad_fn(tr.cfg, tr.dual, tr.vae, tr.schedule,
                           tr.compute_dtype)
    b = {k: v.to(tr.device) for k, v in batch.items()}
    grads, metrics = grad_fn(tr.state.params, b, tr.ctx,
                             draws.to(tr.device))
    flat = torch.cat([g.flatten().double().cpu() for g in grads])
    return flat, float(metrics["loss"])


def agreement(a: Tuple[torch.Tensor, float],
              b: Tuple[torch.Tensor, float]) -> Dict[str, float]:
    """a against b (the reference): relative loss error, gradient cosine,
    gradient norm ratio."""
    (ga, la), (gb, lb) = a, b
    na, nb = float(ga.norm()), float(gb.norm())
    return dict(loss_rel_err=abs(la - lb) / abs(lb),
                grad_cos=float(ga @ gb) / (na * nb), norm_ratio=na / nb,
                loss=la, loss_ref=lb, grad_norm=na, grad_norm_ref=nb)


def smooth_batch(cfg, batch: int, seed: int) -> Dict[str, torch.Tensor]:
    """Smooth maps in [-1, 1] (bilinear upsampling of a 8x8 field) and a
    disc mask, from numpy, on the host."""
    rng = np.random.default_rng(seed)
    hw = cfg.vae.sample_size
    out = {}
    for k in BATCH_KEYS:
        z = torch.from_numpy(rng.standard_normal((batch, 3, 8, 8))
                             .astype(np.float32))
        z = torch.nn.functional.interpolate(z, size=(hw, hw),
                                            mode="bilinear",
                                            align_corners=False)
        out[k] = torch.tanh(z).permute(0, 2, 3, 1).contiguous()
    yy, xx = np.meshgrid(np.linspace(-1, 1, hw), np.linspace(-1, 1, hw),
                         indexing="ij")
    disc = np.where(xx ** 2 + yy ** 2 < 0.6, 1.0, -1.0).astype(np.float32)
    out["mask"] = torch.from_numpy(disc)[None, :, :, None].expand(
        batch, hw, hw, 3).contiguous()
    return out


def compare(settings: Sequence[Tuple[str, torch.dtype]], batch: int = 2,
            seed: int = 1234) -> Dict[str, Dict[str, float]]:
    """small() with the r05 weights: for each branch, one step's gradients
    under settings[0] against settings[1] (the reference)."""
    cfg = config.small()
    weights = small_weights()
    data = smooth_batch(cfg, batch, seed)
    lat = cfg.vae.sample_size // cfg.vae.downscale
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainers = [trainer_with(cfg, weights, dev, dt, tmp)
                    for dev, dt in settings]
        for inverse in (True, False):
            draws = draw(torch.Generator().manual_seed(seed), batch,
                         (lat, lat), cfg.diffusion.num_train_timesteps,
                         inverse)
            res = [step_grads(tr, data, draws) for tr in trainers]
            out["inverse" if inverse else "forward"] = agreement(*res)
    return out

