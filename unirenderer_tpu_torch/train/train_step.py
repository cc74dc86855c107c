"""The dual-schedule train step (counterpart of
`unirenderer_tpu/train/train_step.py`: `make_loss_fn`, `make_train_step`,
`make_two_phase_train_step`, `make_render_train_step`,
`make_bank_train_step`, `make_optimizer`).

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

The optimizer is AdamW or Adafactor (`TrainConfig.optimizer`, optax's
updates: `train/adafactor.py`), after global-norm clipping; with
`gradient_accumulation_steps` k > 1 the update is optax's `MultiSteps`:
a running mean of the micro-batch gradients, the clip and the optimizer
applied to it on every k-th call only (the parameters do not move in
between), and the learning rate indexed by those inner updates.

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
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import torch
from torch import nn

from unirenderer_tpu_torch.core.config import LATENT_CHANNELS, SystemConfig
from unirenderer_tpu_torch.core.convert import flax_permutations
from unirenderer_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, compute_dual_t,
)
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.models.vae import AutoencoderKL
from unirenderer_tpu_torch.pipelines import KernelCalls, UniRendererPipeline
from unirenderer_tpu_torch.train.adafactor import Adafactor
from unirenderer_tpu_torch.train.losses import dual_stream_loss
from unirenderer_tpu_torch.utils.runtime import exact_f32

# (B, H, W, 3) maps in [-1, 1]: the 8 modalities the step VAE-encodes
BATCH_KEYS = ("image", "material", "mask", "env", "normal", "albedo",
              "spec_light", "diff_light")


def warmup_cosine(peak: float, warmup: int, decay_steps: int,
                  end: float) -> Callable[[int], float]:
    """optax's `warmup_cosine_decay_schedule(0, peak, warmup, decay_steps,
    end)`: a linear ramp over `warmup` steps, then a cosine from `peak` to
    `end` over the remaining steps, `end` after."""
    decay = decay_steps - warmup
    if decay <= 0:
        raise ValueError("cosine schedule needs decay steps > warmup steps")
    alpha = 0.0 if peak == 0.0 else end / peak

    def cosine(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        count = min(step - warmup, decay)
        cos = 0.5 * (1 + math.cos(math.pi * count / decay))
        return peak * ((1 - alpha) * cos + alpha)
    return cosine


def make_lr_schedule(cfg: SystemConfig) -> Callable[[int], float]:
    """the number of optimizer updates so far -> learning rate, as optax
    computes `warmup_cosine_decay_schedule`, `linear_schedule` and a
    constant for TrainConfig.lr_schedule / lr_warmup_steps."""
    t = cfg.train
    peak = t.learning_rate
    if t.lr_schedule == "cosine":
        if t.lr_decay_steps <= 0:
            raise ValueError("cosine schedule needs lr_decay_steps")
        return warmup_cosine(peak, max(t.lr_warmup_steps, 1),
                             t.lr_decay_steps, peak * t.lr_end_factor)
    if t.lr_schedule != "constant":
        raise ValueError(f"lr_schedule {t.lr_schedule!r}")
    if t.lr_warmup_steps > 0:
        n = t.lr_warmup_steps
        return lambda step: peak * min(max(step, 0), n) / n
    return lambda step: peak


def make_optimizer(cfg: SystemConfig, params: Mapping[str, torch.Tensor],
                   layouts: Optional[Mapping[str, Optional[Tuple[int, ...]]]]
                   = None, splits: Optional[Mapping[str, Any]] = None
                   ) -> torch.optim.Optimizer:
    """The update optax's `adamw` (the config's betas, eps and decoupled
    weight decay) or `adafactor(lr, clipping_threshold=1.0,
    weight_decay_rate=adam_weight_decay)` makes, over `params` in their
    order (one param group).  Adafactor needs each parameter's permutation
    to its flax layout (`layouts`, `core/convert.flax_permutations`) and,
    for a master that is a piece of a sharded tensor, its split (`splits`,
    `train/adafactor.Split`; AdamW is elementwise and needs none).  The
    learning rate is set from `make_lr_schedule` before every update."""
    t = cfg.train
    if t.optimizer == "adamw":
        return torch.optim.AdamW(list(params.values()), lr=t.learning_rate,
                                 betas=(t.adam_beta1, t.adam_beta2),
                                 eps=t.adam_eps,
                                 weight_decay=t.adam_weight_decay)
    if t.optimizer == "adafactor":
        if layouts is None:
            raise ValueError("adafactor needs the parameters' flax layouts")
        splits = splits or {}
        return Adafactor([(p, layouts[n], splits.get(n))
                          for n, p in params.items()],
                         lr=t.learning_rate, clipping_threshold=1.0,
                         weight_decay_rate=t.adam_weight_decay)
    raise ValueError(f"optimizer {t.optimizer!r}: 'adamw' or 'adafactor'")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of the f32 tensors
    (optax's `global_norm`), in one multi-tensor reduction."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm_fn: Callable = global_norm) -> torch.Tensor:
    """optax's `clip_by_global_norm` in place: g / norm * max_norm when
    norm >= max_norm, else g unchanged (no epsilon).  Returns the norm
    before clipping (`norm_fn` of the gradients); stays on the device (no
    host copy)."""
    norm = norm_fn(grads)
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
        """The draws on `device` (to the card without a host sync)."""
        from unirenderer_tpu_torch.data.scene_bank import host_to_device
        return dataclasses.replace(self, **{
            f.name: host_to_device(getattr(self, f.name), device)
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
             draws: Draws, contrastive_scale: float = 1.0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
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
                                cycle_pred, draws.is_inverse, cfg.train,
                                contrastive_scale)

    def loss_from_draws(params: Mapping[str, torch.Tensor],
                        batch: Mapping[str, torch.Tensor],
                        ctx: torch.Tensor, draws: Draws,
                        contrastive_scale: float = 1.0):
        with use_params(dual, params):
            return loss(batch, ctx, draws, contrastive_scale)

    return loss_from_draws


@dataclasses.dataclass
class TrainState:
    """The f32 master parameters (the dual-stream module's own, by name),
    the optimizer over them, the number of steps taken (`step`, one per
    call as the JAX `TrainState.step`) and of optimizer updates
    (`updates`, the learning rate's index), and under gradient
    accumulation the micro-steps into the current update and their
    running mean (`mini_step`, `acc`: None between updates).  Over several
    ranks `sharding` (`parallel/mesh.ParamSharding`) says where each
    master lives and runs the step's collectives; None in one process."""
    params: Dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    step: int = 0
    updates: int = 0
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None
    sharding: Any = None


def create_train_state(cfg: SystemConfig,
                       dual: nn.Module) -> TrainState:
    params = dict(dual.named_parameters())
    for p in params.values():
        if p.dtype != torch.float32:
            raise TypeError(f"master parameters must be f32, got {p.dtype}")
        p.requires_grad_(True)
    return TrainState(params, make_optimizer(cfg, params,
                                             flax_permutations(dual)))


def make_grad_fn(cfg: SystemConfig, dual: DualStreamModel,
                 vae: AutoencoderKL, schedule: DiffusionSchedule,
                 compute_dtype: torch.dtype):
    """-> grad_fn(params, batch, ctx, draws) -> (f32 grads in the order of
    `params`, metrics): the loss with the parameters cast to
    `compute_dtype`, differentiated (the JAX `value_and_grad(loss_fn)`)."""
    loss_fn = make_loss_fn(cfg, dual, vae, schedule)
    grad_bf16 = cfg.train.grad_dtype == "bfloat16"
    f32 = compute_dtype == torch.float32

    def grad_fn(params: Mapping[str, torch.Tensor], batch, ctx,
                draws: Draws, contrastive_scale: float = 1.0):
        if grad_bf16:
            compute = {n: p.detach().to(compute_dtype).requires_grad_()
                       for n, p in params.items()}
            wrt = list(compute.values())
        else:
            compute = {n: p.to(compute_dtype) for n, p in params.items()}
            wrt = list(params.values())
        # over the backward too; f32 without TF32
        with use_params(dual, compute), exact_f32(f32):
            loss, metrics = loss_fn(compute, batch, ctx, draws,
                                    contrastive_scale)
            grads = list(torch.autograd.grad(loss, wrt))
        for i, g in enumerate(grads):   # each compute-type gradient freed
            grads[i] = g.float()        # as its f32 copy is made
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def make_update_fn(cfg: SystemConfig):
    """-> update(state, grads) -> the norm of `grads` (on the device): the
    optimizer side of a step (optax's `MultiSteps` over clip + optimizer
    when accumulating), `state` updated in place, `grads` (f32, in the
    order of `state.params`) consumed."""
    t = cfg.train
    lr = make_lr_schedule(cfg)
    max_norm, k = t.max_grad_norm, t.gradient_accumulation_steps

    def update(state: TrainState,
               grads: List[torch.Tensor]) -> torch.Tensor:
        state.step += 1
        norm_fn = (global_norm if state.sharding is None
                   else state.sharding.global_norm)
        norm = None
        if k > 1:
            norm = norm_fn(grads)
            if state.acc is None:
                state.acc = [torch.zeros_like(g) for g in grads]
            n = state.mini_step          # optax: acc + (g - acc) / (n + 1)
            torch._foreach_add_(state.acc, torch._foreach_div(
                torch._foreach_sub(grads, state.acc), n + 1))
            if n + 1 < k:
                state.mini_step = n + 1
                return norm
            grads, state.acc, state.mini_step = state.acc, None, 0
        if max_norm > 0:
            clipped = clip_by_global_norm_(grads, max_norm, norm_fn)
        else:
            clipped = norm_fn(grads) if norm is None else norm
        for p, g in zip(state.params.values(), grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = lr(state.updates)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.updates += 1
        return clipped if norm is None else norm

    return update


def make_train_step(cfg: SystemConfig, dual: DualStreamModel,
                    vae: AutoencoderKL, schedule: DiffusionSchedule,
                    compute_dtype: torch.dtype):
    """-> train_step(state, ctx, batch, draws) -> metrics: gradients, then
    `make_update_fn`'s update (global-norm clipping at max_grad_norm, <= 0:
    none; the learning rate of the update; AdamW or Adafactor; under
    accumulation every k-th call); `state` is updated in place.
    metrics["grad_norm"] is the norm of this call's gradients before
    clipping.  With `state.sharding` the call is one rank's part of a
    sharded step on its slice of the batch (`parallel/mesh.shard_step`):
    FSDP masters gathered, gradients and metrics averaged over the data
    ranks."""
    grad_fn = make_grad_fn(cfg, dual, vae, schedule, compute_dtype)
    update = make_update_fn(cfg)

    def train_step(state: TrainState, ctx: torch.Tensor,
                   batch: Mapping[str, torch.Tensor],
                   draws: Draws) -> Dict[str, torch.Tensor]:
        sh = state.sharding
        if sh is None:
            grads, metrics = grad_fn(state.params, batch, ctx, draws)
        else:
            grads, metrics = grad_fn(
                sh.compute_params(state.params, compute_dtype), batch, ctx,
                draws, sh.contrastive_scale)
            grads = sh.reduce_grads(grads)
            metrics = sh.mean_metrics(metrics)
        metrics["grad_norm"] = update(state, grads)
        return metrics

    return train_step


def make_two_phase_train_step(cfg: SystemConfig, dual: DualStreamModel,
                              vae: AutoencoderKL,
                              schedule: DiffusionSchedule,
                              compute_dtype: torch.dtype,
                              batch_transform: Optional[Callable] = None):
    """The step as two calls, (grad_step, update_step): grad_step(params,
    ctx, batch, draws) -> (grads, metrics), with `batch_transform` (e.g.
    a render collate) applied to `batch` first, and update_step(state,
    grads) -> the gradients' norm.  The same operations in the same order
    as `make_train_step`.  It exists for parity with the JAX package's
    API, which splits its step in two to fit a 16 GB chip's allocator;
    the port's trainer does not need the split and runs the fused step."""
    grad_fn = make_grad_fn(cfg, dual, vae, schedule, compute_dtype)

    def grad_step(params: Mapping[str, torch.Tensor], ctx, batch,
                  draws: Draws):
        if batch_transform is not None:
            with torch.no_grad():
                batch = batch_transform(batch)
        return grad_fn(params, {k: batch[k] for k in BATCH_KEYS}, ctx, draws)

    return grad_step, make_update_fn(cfg)


def make_render_train_step(cfg: SystemConfig, dual: DualStreamModel,
                           vae: AutoencoderKL, schedule: DiffusionSchedule,
                           compute_dtype: torch.dtype, resolution: int = 0,
                           ssaa: int = 0, bg: float = 1.0):
    """Render-in-step: -> step(state, ctx, scene, draws) -> metrics, the
    render collate (`collate_from_scene`: K4 and the shading, on the
    scene's device) of a stacked scene (`data/objaverse.stack_scene`'s
    layout, as tensors) followed by `make_train_step`'s step."""
    from unirenderer_tpu_torch.data.objaverse import collate_from_scene
    base = make_train_step(cfg, dual, vae, schedule, compute_dtype)
    res = resolution or cfg.data.resolution
    ss = ssaa or cfg.data.ssaa

    def render_train_step(state: TrainState, ctx: torch.Tensor,
                          scene: Mapping[str, torch.Tensor],
                          draws: Draws) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            batch = collate_from_scene(scene, res, ssaa=ss, bg=bg)
        return base(state, ctx, {k: batch[k] for k in BATCH_KEYS}, draws)

    return render_train_step


def make_bank_train_step(cfg: SystemConfig, dual: DualStreamModel,
                         vae: AutoencoderKL, schedule: DiffusionSchedule,
                         compute_dtype: torch.dtype, resolution: int = 0,
                         ssaa: int = 0, bg: float = 1.0,
                         augment: bool = True):
    """Fresh-scenes training: -> step(state, ctx, bank, scene_draws,
    draws) -> metrics: a batch of new scenes from the device-resident
    bank (`data/scene_bank.scenes_from_draws`, with `augment`), the
    render collate, and `make_train_step`'s step.  Only the draws cross
    from the host."""
    from unirenderer_tpu_torch.data.scene_bank import scenes_from_draws
    render_step = make_render_train_step(cfg, dual, vae, schedule,
                                         compute_dtype, resolution, ssaa, bg)

    def bank_train_step(state: TrainState, ctx: torch.Tensor,
                        bank: Mapping[str, torch.Tensor], scene_draws,
                        draws: Draws) -> Dict[str, torch.Tensor]:
        scene = scenes_from_draws(bank, scene_draws, cfg.data,
                                  augment=augment)
        return render_step(state, ctx, scene, draws)

    return bank_train_step


def train_step_launches(cfg: SystemConfig, batch: int, is_inverse: bool,
                        render: bool = False) -> Dict[str, int]:
    """Kernel launches of one train step, worked out from the config
    (`pipelines.KernelCalls`): K1 (the VAE encoder's norms and the
    dual-stream norms), K2 forward (every dual-stream attention call), K2
    backward (one per attention call); under remat the down and up blocks'
    K1 and K2 forward calls run again in the backward.  The main pass runs
    the attribute encoder, the UNet and the attribute decoder; an inverse
    step's cycle pass the encoder and the UNet again.  With `render` (the
    render-in-step and bank steps) the collate adds one K4 launch."""
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
    out = {"groupnorm_silu": sum(fwd.gn.values()),
           "flash_attention": sum(fwd.attn.values()),
           "flash_attention_backward": sum(bwd.attn.values())}
    if render:
        out["rasterize"] = 1
    return out


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
