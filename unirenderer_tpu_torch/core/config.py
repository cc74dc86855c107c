"""Typed configuration: the port's own copy of
`unirenderer_tpu/core/config.py`.

Only the parts the ported paths read are carried over: the model
geometries (UNet, VAE, CLIP text), the diffusion schedule, the sampler
recipe, the renderer and the data settings, with the same defaults and
the same `flagship()`, `legacy16()`, `legacy12()`, `small()`, `medium()`
and `tiny()` presets, and the training settings (`TrainConfig`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LATENT_CHANNELS = 4
# the attribute stream: seven 4-channel latent groups, concatenated in the
# order mask | material | normal | albedo | spec_light | diff_light | env
ATTR_CHANNELS = 7 * LATENT_CHANNELS


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Dual-stream denoiser trunk (SD-v1.4 UNet geometry by default)."""
    in_channels: int = LATENT_CHANNELS
    out_channels: int = LATENT_CHANNELS
    attr_channels: int = ATTR_CHANNELS
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # True -> the level has spatial transformers (SD1.x: first 3 down)
    down_block_attn: Tuple[bool, ...] = (True, True, True, False)
    num_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    transformer_layers: int = 1
    sample_size: int = 64                           # latent H=W
    # recompute each down/up block's activations in the backward
    # (torch.utils.checkpoint; the JAX package's nn.remat)
    remat: bool = True

    @property
    def up_block_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_attn))

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD AutoencoderKL geometry."""
    in_channels: int = 3
    latent_channels: int = LATENT_CHANNELS
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_size: int = 512

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """CLIP ViT-L/14 text model geometry."""
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    intermediate_size: int = 3072


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """x0-prediction DDPM schedule with scaled-linear SD betas."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    # std of the noise added to the env latent in training
    env_noise_aug: float = 0.02


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Inference recipe: UniPC (order 2, bh2), no guidance; inverse
    rendering averages an ensemble of 5 runs (1 at small() and tiny()).
    `encoder_reuse` k > 1: forward rendering runs the UNet's encoder half
    only every k-th step and the last, and the decoder half alone from
    the cached raw taps in between (encoder propagation, Faster Diffusion,
    arXiv 2312.09608); 1 runs every step in full."""
    num_steps: int = 20
    ensemble: int = 5
    encoder_reuse: int = 1


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Split-sum PBR renderer."""
    resolution: int = 512
    env_res: int = 512                              # base cubemap face size
    env_min_res: int = 16                           # coarsest specular mip
    min_roughness: float = 0.04
    max_mip_level: int = 4                          # len(mips)-2, see get_mip
    spp: int = 1                                    # supersamples per pixel
    near: float = 0.1
    far: float = 1000.0
    fovy_deg: float = 30.0
    raster_chunk: int = 1024                        # triangles per chunk
    layers: int = 1                                 # depth peel layers


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset and render-collate settings."""
    root_dir: str = ""
    env_dir: str = ""
    meta_json: str = ""
    resolution: int = 512
    random_camera: bool = False     # False: the train split's pinned camera
    camera_distance: float = 4.0
    material_grid: int = 11                         # 11x11 metallic/roughness
    num_workers: int = 8
    ssaa: int = 2                   # supersampling factor of the collate
    v_pad: int = 32768              # static mesh padding (vertices)
    t_pad: int = 32768              # static mesh padding (triangles)
    texture_res: int = 256          # static albedo-texture resolution
    rotation_augment: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Loss weights and loop settings: the fields of the JAX package's
    TrainConfig that the port's trainer reads, with its defaults (except
    `compute_dtype`).  `mesh_axes` comes with the slice that reads it."""
    batch_size_per_device: int = 2
    learning_rate: float = 5e-6
    optimizer: str = "adamw"                        # "adamw" | "adafactor"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0                      # <= 0: no clipping
    lr_schedule: str = "constant"                   # "constant" | "cosine"
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0                         # cosine horizon
    lr_end_factor: float = 0.1                      # final lr = lr * this
    # k > 1: optax MultiSteps, one optimizer update per k calls
    gradient_accumulation_steps: int = 1
    max_steps: int = 5_000_000
    checkpoint_every: int = 5000
    validation_every: int = 5000
    checkpoints_total_limit: int = 5
    seed: int = 42
    # loss weights
    w_img: float = 1.0
    w_attr: float = 10.0
    w_contrastive: float = 0.01
    w_cycle: float = 0.8
    contrastive_temperature: float = 0.1
    # f32 master params; compute in this type.  None: bf16 on the card
    # (the JAX Trainer's default), f32 on the CPU.  The card's kernels take
    # "bfloat16" and "float32"; another type raises there
    compute_dtype: Optional[str] = None
    # "float32": grads of the f32 masters; "bfloat16": grads of the
    # compute-type copies, upcast for the update
    grad_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    text: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def flagship() -> SystemConfig:
    """SD-v1.4 geometry: 512^2 images, 64^2 latents."""
    return SystemConfig()


def legacy16() -> SystemConfig:
    """The legacy 16-channel attribute layout (four 4-channel groups, no
    mask head) of `rendering` / `inverse_rendering` / `mask2image` /
    `image2mask`, at flagship geometry."""
    return SystemConfig(unet=UNetConfig(attr_channels=16))


def legacy12() -> SystemConfig:
    """The legacy 12-channel layout (three groups) of the `*_3mod`
    methods, at flagship geometry."""
    return SystemConfig(unet=UNetConfig(attr_channels=12))


def small() -> SystemConfig:
    """64^2 images, 16^2 latents: the config of the in-repo trained weights
    (artifacts/r05/dual_small.npz, artifacts/r04/vae_small.npz)."""
    return SystemConfig(
        unet=UNetConfig(
            block_out_channels=(128, 256, 512),
            layers_per_block=1,
            down_block_attn=(True, True, False),
            num_heads=4,
            cross_attention_dim=256,
            norm_num_groups=16,
            sample_size=16,
            remat=False,
        ),
        vae=VAEConfig(
            block_out_channels=(32, 64, 128),
            layers_per_block=1,
            norm_num_groups=8,
            sample_size=64,
        ),
        text=TextEncoderConfig(
            vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
            max_length=16, intermediate_size=512,
        ),
        sampler=SamplerConfig(ensemble=1),
        render=RenderConfig(resolution=64, env_res=32, env_min_res=8,
                            max_mip_level=2, raster_chunk=256),
        data=DataConfig(resolution=64, texture_res=64,
                        v_pad=4096, t_pad=8192, random_camera=True),
        train=TrainConfig(batch_size_per_device=8, learning_rate=1e-4,
                          checkpoint_every=1000),
    )


def medium() -> SystemConfig:
    """128^2 images, 32^2 latents: flagship topology at ~3.2x small()'s
    parameter count (328M dual-stream parameters).  Attention at S 1024 /
    D 24, S 256 / D 48 and S 64 / D 96.  Nothing trained at this size is
    in the repo."""
    return SystemConfig(
        unet=UNetConfig(
            block_out_channels=(192, 384, 768),
            layers_per_block=2,
            down_block_attn=(True, True, False),
            num_heads=8,
            cross_attention_dim=512,
            norm_num_groups=32,
            sample_size=32,
            remat=True,
        ),
        vae=VAEConfig(
            block_out_channels=(64, 128, 256),
            layers_per_block=2,
            norm_num_groups=16,
            sample_size=128,
        ),
        text=TextEncoderConfig(
            vocab_size=512, hidden_size=512, num_layers=4, num_heads=8,
            max_length=16, intermediate_size=1024,
        ),
        sampler=SamplerConfig(ensemble=1),
        render=RenderConfig(resolution=128, env_res=64, env_min_res=8,
                            max_mip_level=3, raster_chunk=512),
        data=DataConfig(resolution=128, texture_res=128,
                        v_pad=8192, t_pad=16384, random_camera=True),
        train=TrainConfig(batch_size_per_device=8, learning_rate=1e-4,
                          checkpoint_every=1000, validation_every=1000),
    )


def tiny(latent_size: int = 8) -> SystemConfig:
    """A minute system for tests: same topology, toy widths."""
    return SystemConfig(
        unet=UNetConfig(
            block_out_channels=(32, 64),
            layers_per_block=1,
            down_block_attn=(True, False),
            num_heads=2,
            cross_attention_dim=32,
            norm_num_groups=8,
            sample_size=latent_size,
            remat=False,
        ),
        vae=VAEConfig(
            block_out_channels=(16, 32),
            layers_per_block=1,
            norm_num_groups=8,
            sample_size=latent_size * 2,
        ),
        text=TextEncoderConfig(
            vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_length=16, intermediate_size=64,
        ),
        sampler=SamplerConfig(num_steps=3, ensemble=1),
        render=RenderConfig(resolution=32, env_res=16, env_min_res=4,
                            max_mip_level=1, raster_chunk=64),
        data=DataConfig(resolution=16, texture_res=32,
                        v_pad=4096, t_pad=8192, random_camera=True),
        train=TrainConfig(batch_size_per_device=2),
    )
