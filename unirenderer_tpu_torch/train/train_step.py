"""The dual-schedule train step (counterpart of
`unirenderer_tpu/train/train_step.py` `make_loss_fn` / `make_train_step`).

One step: the 8 maps of `BATCH_KEYS` VAE-encoded in one batched call (the
VAE is frozen: no gradient), noise on the env latent, the dual timestep
draw, noise on the image latent and the 24-channel attribute latent, the
full dual-stream model with its decoder, on inverse steps the cycle pass
(UNet and encoder over a re-noised image latent, conditioned on the
predicted attributes), `dual_stream_loss`, the backward through the
dual-stream parameters only, global-norm clipping and AdamW.

Random numbers are split from the loss: `draw` takes every random number
of a step from a host `torch.Generator` (the JAX step splits its key in
7), and `loss_from_draws` is deterministic given them, so tests can feed
it the JAX step's own draws.

Precision, as in the JAX step: the parameters are f32 masters; each step
computes with copies cast to the compute type (bf16 on the card, whose
kernels take nothing else; f32 on the CPU), the cast flax applies at
every use.  The copies are installed in the module for the forward and
the backward (`use_params`), so activation checkpointing recomputes with
the same copies; autograd through the cast gives f32 gradients on the
masters.  With `grad_dtype="bfloat16"` the gradients are those of the
copies, upcast for the update.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

from unirenderer_tpu_torch.core.config import LATENT_CHANNELS, SystemConfig
from unirenderer_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, compute_dual_t,
)
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.models.vae import AutoencoderKL
from unirenderer_tpu_torch.pipelines import KernelCalls, UniRendererPipeline
from unirenderer_tpu_torch.train.losses import dual_stream_loss

# (B, H, W, 3) maps in [-1, 1]: the 8 modalities the step VAE-encodes
BATCH_KEYS = ("image", "material", "mask", "env", "normal", "albedo",
              "spec_light", "diff_light")


def make_lr_schedule(cfg: SystemConfig) -> Callable[[int], float]:
    """step (the number of updates so far) -> learning rate, as optax
    computes `warmup_cosine_decay_schedule`, `linear_schedule` and a
    constant for TrainConfig.lr_schedule / lr_warmup_steps."""
    t = cfg.train
    peak = t.learning_rate
    if t.lr_schedule == "cosine":
        if t.lr_decay_steps <= 0:
            raise ValueError("cosine schedule needs lr_decay_steps")
        warmup = max(t.lr_warmup_steps, 1)
        decay = t.lr_decay_steps - warmup
        if decay <= 0:
            raise ValueError("cosine schedule needs lr_decay_steps > "
                             "lr_warmup_steps")
        end = peak * t.lr_end_factor
        alpha = 0.0 if peak == 0.0 else end / peak

        def cosine(step: int) -> float:
            if step < warmup:
                return peak * step / warmup
            count = min(step - warmup, decay)
            cos = 0.5 * (1 + math.cos(math.pi * count / decay))
            return peak * ((1 - alpha) * cos + alpha)
        return cosine
    if t.lr_schedule != "constant":
        raise ValueError(f"lr_schedule {t.lr_schedule!r}")
    if t.lr_warmup_steps > 0:
        n = t.lr_warmup_steps
        return lambda step: peak * min(max(step, 0), n) / n
    return lambda step: peak


def make_optimizer(cfg: SystemConfig,
                   params: Mapping[str, torch.Tensor]
                   ) -> torch.optim.Optimizer:
    """AdamW with the config's betas, eps and decoupled weight decay:
    the update optax's `adamw` makes.  The learning rate is set from
    `make_lr_schedule` before every update."""
    t = cfg.train
    if t.optimizer != "adamw":
        raise NotImplementedError(f"optimizer {t.optimizer!r}: the port has "
                                  f"AdamW only (adafactor is queued)")
    if t.gradient_accumulation_steps > 1:
        raise NotImplementedError("gradient accumulation is queued")
    return torch.optim.AdamW(list(params.values()), lr=t.learning_rate,
                             betas=(t.adam_beta1, t.adam_beta2),
                             eps=t.adam_eps, weight_decay=t.adam_weight_decay)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of the f32 tensors
    (optax's `global_norm`), in one multi-tensor reduction."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm` in place: g / norm * max_norm when
    norm >= max_norm, else g unchanged (no epsilon).  Returns the norm
    before clipping; stays on the device (no host copy)."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


@dataclasses.dataclass
class Draws:
    """Every random number of one step (the JAX step's `split(rng, 7)`):
    VAE posterior noise of the 8 maps, env latent noise, the dual
    timesteps and branch, image and attribute latent noise, and the cycle
    pass's timesteps and noise."""
    enc_noise: torch.Tensor          # (8B, h, w, 4)
    env_noise: torch.Tensor          # (B, h, w, 4)
    t_img: torch.Tensor              # (B,) int64
    t_attr: torch.Tensor             # (B,)
    is_inverse: bool
    noise_img: torch.Tensor          # (B, h, w, 4)
    noise_attr: torch.Tensor         # (B, h, w, 24)
    t_cycle: torch.Tensor            # (B,)
    noise_cycle: torch.Tensor        # (B, h, w, 4)

    def to(self, device) -> "Draws":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def draw(generator: torch.Generator, batch: int, latent_hw: Tuple[int, int],
         num_train_timesteps: int, is_inverse: Optional[bool] = None
         ) -> Draws:
    """The step's random numbers from a host generator, in the order of the
    JAX step's keys; `is_inverse` forces the branch (`compute_dual_t`)."""
    h, w = latent_hw
    c = LATENT_CHANNELS

    def normal(*shape):
        return torch.randn(shape, generator=generator)

    enc_noise = normal(len(BATCH_KEYS) * batch, h, w, c)
    env_noise = normal(batch, h, w, c)
    t_img, t_attr, inv = compute_dual_t(generator, num_train_timesteps,
                                        batch, is_inverse)
    noise_img = normal(batch, h, w, c)
    noise_attr = normal(batch, h, w, 6 * c)
    t_cycle = torch.randint(0, num_train_timesteps, (batch,),
                            generator=generator)
    return Draws(enc_noise, env_noise, t_img, t_attr, inv, noise_img,
                 noise_attr, t_cycle, normal(batch, h, w, c))


@contextlib.contextmanager
def use_params(module: nn.Module,
               tensors: Mapping[str, torch.Tensor]) -> Iterator[None]:
    """Install `tensors` (by parameter name) in place of the module's
    parameters for the duration, as `torch.func.functional_call` does for
    one call; kept over the backward, so that activation checkpointing
    recomputes with the same tensors."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


def encode_batch(cfg: SystemConfig, vae: AutoencoderKL,
                 batch: Mapping[str, torch.Tensor],
                 noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 8 maps through the frozen VAE encoder as one stack (in chunks of
    the pipeline's VAE_CHUNK images), posterior samples in f32, scaled ->
    {key: (B, h, w, 4)}."""
    stacked = torch.cat([batch[k] for k in BATCH_KEYS])
    with torch.no_grad():
        moments = [vae.encode(chunk) for chunk in stacked.split(
            UniRendererPipeline.VAE_CHUNK)]
    mean = torch.cat([m for m, _ in moments]).float()
    logvar = torch.cat([lv for _, lv in moments]).float()
    z = (mean + torch.exp(0.5 * logvar) * noise) * cfg.vae.scaling_factor
    return dict(zip(BATCH_KEYS, z.chunk(len(BATCH_KEYS))))


def make_loss_fn(cfg: SystemConfig, dual: DualStreamModel,
                 vae: AutoencoderKL, schedule: DiffusionSchedule):
    """-> loss_from_draws(params, batch, ctx, draws) -> (loss, metrics),
    the JAX `loss_fn` with its random numbers given: `params` maps the
    dual-stream parameter names to the tensors to compute with, `batch`
    holds the 8 maps, `ctx` is the (1, L, D) blank-prompt context."""

    def loss(batch: Mapping[str, torch.Tensor], ctx: torch.Tensor,
             draws: Draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        b = batch["image"].shape[0]
        lat = encode_batch(cfg, vae, batch, draws.enc_noise)
        env = lat["env"] + cfg.diffusion.env_noise_aug * draws.env_noise
        latents_img = lat["image"]
        noisy_img = schedule.add_noise(latents_img, draws.noise_img,
                                       draws.t_img)
        # 24-ch attribute order: material|normal|albedo|spec|diff|env
        attr24 = torch.cat([lat["material"], lat["normal"], lat["albedo"],
                            lat["spec_light"], lat["diff_light"], env],
                           dim=-1)
        noisy_attr24 = schedule.add_noise(attr24, draws.noise_attr,
                                          draws.t_attr)
        attr28 = torch.cat([lat["mask"], noisy_attr24], dim=-1)
        ctxb = ctx.expand(b, -1, -1)
        img_pred, attr_pred28 = dual(noisy_img, attr28, draws.t_img,
                                     draws.t_attr, ctxb)
        attr_pred = attr_pred28[..., LATENT_CHANNELS:]    # drop the mask
        if draws.is_inverse:
            noisy_img_c = schedule.add_noise(latents_img, draws.noise_cycle,
                                             draws.t_cycle)
            attr28_c = torch.cat([lat["mask"], attr_pred], dim=-1)
            cycle_pred, _ = dual(noisy_img_c, attr28_c, draws.t_cycle,
                                 torch.zeros_like(draws.t_cycle), ctxb,
                                 run_decoder=False)
        else:
            cycle_pred = torch.zeros_like(img_pred)
        return dual_stream_loss(img_pred, attr_pred, latents_img, attr24,
                                cycle_pred, draws.is_inverse, cfg.train)

    def loss_from_draws(params: Mapping[str, torch.Tensor],
                        batch: Mapping[str, torch.Tensor],
                        ctx: torch.Tensor, draws: Draws):
        with use_params(dual, params):
            return loss(batch, ctx, draws)

    return loss_from_draws


@dataclasses.dataclass
class TrainState:
    """The f32 master parameters (the dual-stream module's own, by name),
    the optimizer over them and the number of updates taken."""
    params: Dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(cfg: SystemConfig,
                       dual: DualStreamModel) -> TrainState:
    params = dict(dual.named_parameters())
    for p in params.values():
        if p.dtype != torch.float32:
            raise TypeError(f"master parameters must be f32, got {p.dtype}")
        p.requires_grad_(True)
    return TrainState(params, make_optimizer(cfg, params))


def make_grad_fn(cfg: SystemConfig, dual: DualStreamModel,
                 vae: AutoencoderKL, schedule: DiffusionSchedule,
                 compute_dtype: torch.dtype):
    """-> grad_fn(params, batch, ctx, draws) -> (f32 grads in the order of
    `params`, metrics): the loss with the parameters cast to
    `compute_dtype`, differentiated (the JAX `value_and_grad(loss_fn)`)."""
    loss_fn = make_loss_fn(cfg, dual, vae, schedule)
    grad_bf16 = cfg.train.grad_dtype == "bfloat16"

    def grad_fn(params: Mapping[str, torch.Tensor], batch, ctx,
                draws: Draws):
        if grad_bf16:
            compute = {n: p.detach().to(compute_dtype).requires_grad_()
                       for n, p in params.items()}
            wrt = list(compute.values())
        else:
            compute = {n: p.to(compute_dtype) for n, p in params.items()}
            wrt = list(params.values())
        with use_params(dual, compute):     # over the backward too
            loss, metrics = loss_fn(compute, batch, ctx, draws)
            grads = torch.autograd.grad(loss, wrt)
        grads = [g.float() for g in grads]
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def make_train_step(cfg: SystemConfig, dual: DualStreamModel,
                    vae: AutoencoderKL, schedule: DiffusionSchedule,
                    compute_dtype: torch.dtype):
    """-> train_step(state, ctx, batch, draws) -> metrics: gradients,
    global-norm clipping at max_grad_norm (<= 0: none), the learning rate
    of the step, AdamW; `state` is updated in place.  metrics["grad_norm"]
    is the norm before clipping."""
    grad_fn = make_grad_fn(cfg, dual, vae, schedule, compute_dtype)
    lr = make_lr_schedule(cfg)
    max_norm = cfg.train.max_grad_norm

    def train_step(state: TrainState, ctx: torch.Tensor,
                   batch: Mapping[str, torch.Tensor],
                   draws: Draws) -> Dict[str, torch.Tensor]:
        grads, metrics = grad_fn(state.params, batch, ctx, draws)
        if max_norm > 0:
            metrics["grad_norm"] = clip_by_global_norm_(grads, max_norm)
        else:
            metrics["grad_norm"] = global_norm(grads)
        for p, g in zip(state.params.values(), grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = lr(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    return train_step


def train_step_launches(cfg: SystemConfig, batch: int,
                        is_inverse: bool) -> Dict[str, int]:
    """Kernel launches of one train step, worked out from the config
    (`pipelines.KernelCalls`): K1 (the VAE encoder's norms and the
    dual-stream norms), K2 forward (every dual-stream attention call), K2
    backward (one per attention call); under remat the down and up blocks'
    K1 and K2 forward calls run again in the backward.  The main pass runs
    the attribute encoder, the UNet and the attribute decoder; an inverse
    step's cycle pass the encoder and the UNet again."""
    size = cfg.vae.sample_size
    encoders, decoders = (4, 3) if is_inverse else (2, 2)
    fwd, bwd = KernelCalls(cfg, size), KernelCalls(cfg, size)
    runs = 2 if cfg.unet.remat else 1
    for calls, block_runs in ((fwd, runs), (bwd, 1)):
        for _ in range(encoders):
            calls.encoder_half(batch, block_runs)
        for _ in range(decoders):
            calls.decoder_half(batch, block_runs)
    fwd.vae_encoder(len(BATCH_KEYS) * batch)
    return {"groupnorm_silu": sum(fwd.gn.values()),
            "flash_attention": sum(fwd.attn.values()),
            "flash_attention_backward": sum(bwd.attn.values())}


def train_kernel_cases(cfg: SystemConfig, batch: int, image_size: int):
    """Every call signature K1 and K2 (forward and backward alike) see in
    one train step at `batch` and `image_size`, worked out from the
    config, in the form the wrappers record in `.seen`: the VAE encoder
    over the 8 maps, the dual-stream encoder and decoder halves (the cycle
    pass repeats the same shapes)."""
    calls = KernelCalls(cfg, image_size)
    calls.encoder_half(batch)
    calls.decoder_half(batch)
    calls.vae_encoder(len(BATCH_KEYS) * batch)
    return set(calls.gn), set(calls.attn)
