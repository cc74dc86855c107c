"""VAE pre-training (counterpart of `unirenderer_tpu/train/vae_train.py`):
the KL autoencoder trained on the 8 training maps of each batch stacked
into one image batch (images, normals, albedo, masks and light maps
alike), with L1 + MSE reconstruction + beta x KL against N(0, I), no GAN
term; the result is the frozen VAE of diffusion training.

f32 master parameters, computed in `trainer.resolve_compute_dtype` (the
VAE CLI asks for f32, as tools/train_vae.py): K1 runs under autograd in
the encoder and the decoder, its f32 form in f32 (cuDNN without TF32) and
its bf16 one in bf16; the mid-block attention is plain PyTorch;
global-norm clipping at 1.0 and
AdamW (betas 0.9 / 0.999, weight decay 1e-4), as optax's chain.  The
posterior noise is drawn on the host (the step takes it), and with a
scene bank the scenes' draws too, from one generator whose state is
checkpointed: a resumed run continues the same draws.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from unirenderer_tpu_torch.core.config import SystemConfig
from unirenderer_tpu_torch.train.train_step import (
    BATCH_KEYS, clip_by_global_norm_, use_params, warmup_cosine,
)
from unirenderer_tpu_torch.utils.runtime import exact_f32

VAE_MAX_GRAD_NORM = 1.0


@dataclasses.dataclass
class VAETrainState:
    params: Dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_vae_optimizer(params: Mapping[str, torch.Tensor],
                       lr: float = 1e-4) -> torch.optim.Optimizer:
    """AdamW as optax's `adamw(lr, b1=0.9, b2=0.999, weight_decay=1e-4)`;
    the learning rate is set before every update."""
    return torch.optim.AdamW(list(params.values()), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def vae_lr_schedule(lr: float, schedule: str, max_steps: int,
                    warmup: int = 500) -> Callable[[int], float]:
    """updates so far -> learning rate: constant, or optax's warmup cosine
    from 0 to `lr` over `warmup` steps and down to lr / 100 at
    `max_steps`."""
    if schedule == "cosine":
        return warmup_cosine(lr, warmup, max_steps, lr * 0.01)
    if schedule != "constant":
        raise ValueError(f"lr_schedule {schedule!r}")
    return lambda step: lr


def create_vae_train_state(vae: nn.Module, lr: float = 1e-4
                           ) -> VAETrainState:
    params = dict(vae.named_parameters())
    for p in params.values():
        if p.dtype != torch.float32:
            raise TypeError(f"master parameters must be f32, got {p.dtype}")
        p.requires_grad_(True)
    return VAETrainState(params, make_vae_optimizer(params, lr))


def stack_modalities(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, H, W, 3) x the 8 maps -> one (8B, H, W, 3) training stack, in
    the order of `BATCH_KEYS`."""
    return torch.cat([batch[k] for k in BATCH_KEYS if k in batch])


def posterior_shape(cfg: SystemConfig, images_shape):
    """(N, h, w, latent channels) of the posterior of (N, H, W, 3)."""
    n, h, w, _ = images_shape
    f = cfg.vae.downscale
    return (n, h // f, w // f, cfg.vae.latent_channels)


def make_vae_train_step(vae: nn.Module, lr: Union[float, Callable],
                        kl_weight: float = 1e-6,
                        compute_dtype: torch.dtype = torch.float32):
    """-> vae_step(state, images, noise) -> metrics: images (N, H, W, 3)
    in [-1, 1] and the posterior noise (N, h, w, 4); the loss with the
    parameters cast to `compute_dtype`, its gradient, the clip and AdamW;
    `state` updated in place.  metrics: vae_loss, vae_l1, vae_mse, vae_kl,
    vae_psnr and vae_grad_norm (before clipping), on the device."""
    schedule = lr if callable(lr) else (lambda step: lr)

    def loss_fn(images, noise):
        mean, logvar = vae.encode(images)
        mean32, logvar32 = mean.float(), logvar.float()
        z = mean32 + torch.exp(0.5 * logvar32) * noise
        recon = vae.decode(z).float()
        images = images.float()
        l1 = torch.abs(recon - images).mean()
        mse = torch.square(recon - images).mean()
        kl = 0.5 * (torch.square(mean32) + torch.exp(logvar32) - 1.0
                    - logvar32).mean()
        loss = l1 + mse + kl_weight * kl
        psnr = -10.0 * torch.log10(torch.clamp(
            torch.square((recon - images) / 2.0).mean(), min=1e-12))
        return loss, {"vae_loss": loss, "vae_l1": l1, "vae_mse": mse,
                      "vae_kl": kl, "vae_psnr": psnr}

    def vae_step(state: VAETrainState, images: torch.Tensor,
                 noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        compute = {n: p.to(compute_dtype) for n, p in state.params.items()}
        with use_params(vae, compute), \
                exact_f32(compute_dtype == torch.float32):
            loss, metrics = loss_fn(images, noise)
            grads = torch.autograd.grad(loss, list(state.params.values()))
        grads = [g.float() for g in grads]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["vae_grad_norm"] = clip_by_global_norm_(grads,
                                                        VAE_MAX_GRAD_NORM)
        for p, g in zip(state.params.values(), grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    return vae_step


def make_vae_bank_train_step(cfg: SystemConfig, vae: nn.Module,
                             lr: Union[float, Callable],
                             kl_weight: float = 1e-6, augment: bool = True,
                             compute_dtype: torch.dtype = torch.float32):
    """Fresh-scenes VAE training: -> bank_step(state, bank, scene_draws,
    noise) -> metrics: new scenes from the device-resident bank, the
    render collate at the data config's resolution and SSAA (K4), the 8
    maps stacked, and `make_vae_train_step`'s step."""
    from unirenderer_tpu_torch.data.objaverse import collate_from_scene
    from unirenderer_tpu_torch.data.scene_bank import scenes_from_draws
    base = make_vae_train_step(vae, lr, kl_weight, compute_dtype)

    def bank_step(state: VAETrainState, bank, scene_draws,
                  noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        scene = scenes_from_draws(bank, scene_draws, cfg.data,
                                  augment=augment)
        with torch.no_grad():
            batch = collate_from_scene(scene, cfg.data.resolution,
                                       ssaa=cfg.data.ssaa)
        return base(state, stack_modalities(batch), noise)

    return bank_step


def build_vae(cfg: SystemConfig, device, seed: int = 0) -> nn.Module:
    """The VAE as f32 masters on `device`, seeded random weights."""
    from unirenderer_tpu_torch.models.vae import AutoencoderKL
    from unirenderer_tpu_torch.pipelines import fill_random_
    with torch.device("meta"):
        vae = AutoencoderKL(cfg.vae)
    vae.to(dtype=torch.float32).to_empty(device=device)
    vae.to(memory_format=torch.channels_last)
    with torch.no_grad():
        fill_random_(vae, torch.Generator(device=device).manual_seed(seed))
    return vae.train()


def train_vae(cfg: SystemConfig, batch_iterator: Optional[Iterator[Mapping]],
              workdir: str, max_steps: int, lr: float = 1e-4,
              kl_weight: float = 1e-6, seed: int = 0, log_every: int = 25,
              checkpoint_every: int = 1000, lr_schedule: str = "constant",
              lr_warmup: int = 500, init_params: str = "",
              scene_bank: Optional[Mapping[str, np.ndarray]] = None,
              bank_batch: int = 4, augment: bool = True, device="cuda",
              log=print) -> VAETrainState:
    """Drive VAE training over the batch iterator's map batches, or with a
    scene bank over fresh scenes (`bank_batch` scenes x 8 maps a step).
    Checkpoints go to `<workdir>/vae_checkpoints` (`CheckpointManager`:
    the params npz is the frozen VAE of `--vae-ckpt`), metrics to
    `<workdir>/vae_metrics.jsonl`.  `init_params`: a params npz to
    warm-start from; a checkpoint in the workdir wins (resume)."""
    from unirenderer_tpu_torch.core.checkpoint import (
        AsyncSaver, CheckpointManager, load_params_npz,
    )
    from unirenderer_tpu_torch.core.convert import load_flax
    from unirenderer_tpu_torch.core.tracing import MetricLogger
    from unirenderer_tpu_torch.train.trainer import (
        resolve_compute_dtype, resolve_device,
    )
    dev = resolve_device(device)
    compute_dtype = resolve_compute_dtype(cfg.train, dev)
    log(f"[vae] compute {str(compute_dtype).removeprefix('torch.')} on "
        f"{dev}")
    vae = build_vae(cfg, dev, seed)
    if init_params:
        warm, wstep = load_params_npz(init_params)
        try:
            with torch.no_grad():
                load_flax(vae, warm)
        except (KeyError, ValueError) as e:
            raise ValueError(f"{init_params} does not match the {cfg.vae} "
                             f"geometry: warm starts do not transfer "
                             f"across configs ({e})") from e
        log(f"[vae] warm-start params from {init_params} (exported at "
            f"step {wstep})")
    schedule = vae_lr_schedule(lr, lr_schedule, max_steps, lr_warmup)
    state = create_vae_train_state(vae, lr)
    generator = torch.Generator().manual_seed(seed + 1)
    os.makedirs(workdir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(workdir, "vae_checkpoints"))
    saver = AsyncSaver(ckpt)
    restored = ckpt.restore()
    if restored is not None:
        params, st = restored
        with torch.no_grad():
            load_flax(vae, params)
        state.optimizer.load_state_dict(st["optimizer"])
        state.step = st["step"]
        generator.set_state(st["generator"])
        log(f"[vae] resumed from step {state.step}")
    logger = MetricLogger(os.path.join(workdir, "vae_metrics.jsonl"))

    def resume_state():
        return dict(optimizer=state.optimizer.state_dict(), step=state.step,
                    generator=generator.get_state())

    if scene_bank is not None:
        from unirenderer_tpu_torch.data.scene_bank import (
            bank_sizes, bank_to_device, draw_scenes,
        )
        bank = bank_to_device(scene_bank, dev)
        bank_fn = make_vae_bank_train_step(cfg, vae, schedule, kl_weight,
                                           augment, compute_dtype)
        res = cfg.data.resolution
        noise_shape = posterior_shape(cfg, (8 * bank_batch, res, res, 3))

        def run(_batch):
            sd = draw_scenes(generator, bank_sizes(bank), bank_batch,
                             cfg.data)
            noise = torch.randn(noise_shape, generator=generator)
            return bank_fn(state, bank, sd, noise.to(dev))
        batch_iterator = itertools.repeat(None)
    else:
        step_fn = make_vae_train_step(vae, schedule, kl_weight,
                                      compute_dtype)

        def run(batch):
            images = stack_modalities({k: torch.as_tensor(v).to(dev)
                                       for k, v in batch.items()})
            noise = torch.randn(posterior_shape(cfg, images.shape),
                                generator=generator)
            return step_fn(state, images, noise.to(dev))

    start = step = state.step
    exit_reason = "iterator exhausted"
    for batch in batch_iterator:
        if step >= max_steps:
            exit_reason = f"reached max_steps={max_steps}"
            break
        metrics = run(batch)
        step = state.step
        if step % log_every == 0 or step == 1:
            rec = logger.log(step, metrics)
            log(f"[vae] step {step}: loss={rec['vae_loss']:.4f} "
                f"psnr={rec['vae_psnr']:.2f}")
        if step % checkpoint_every == 0:
            saver.save(step, vae, state.params, resume_state())
    if step > start and step % checkpoint_every != 0:
        saver.save(step, vae, state.params, resume_state(), blocking=True)
    saver.join()
    logger.close()
    # the exit cause, named: a run that stops early says why
    log(f"[vae] training loop ended at step {step}/{max_steps} "
        f"({exit_reason})")
    return state
