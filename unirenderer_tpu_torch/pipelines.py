"""UniRendererPipeline, the sampling API (counterpart of
`unirenderer_tpu/pipelines.py`).

One sampling engine, `_sample`, driven by a `ModeSpec` (which streams and
which attribute groups it denoises), with three branches as in JAX:

  * forward rendering (`mask2image_3mod_albedo`, `_black`, the legacy
    `rendering`): the maps are VAE-encoded in chunks of `VAE_CHUNK` (or
    given as latents), the attribute encoder runs once (the attribute
    stream is clean at t_attr = 0, so its residuals are loop-invariant),
    then UniPC denoises the image latent, one UNet pass a step (with
    `SamplerConfig.encoder_reuse` k > 1, the UNet's encoder half every k-th
    step and the last, its decoder half alone from the cached taps in
    between), and the VAE decodes it;
  * inverse rendering (`real_image2mask_3mod_albedo`,
    `image2mask_3mod_albedo`, the legacy `inverse_rendering`): photo and
    mask encoded once and tiled over the ensemble (folded into the batch),
    the UNet's encoder half once (the image is clean at t_img = 0, and the
    attribute decoder reads its taps before any residual), then the groups
    denoised from noise, one attribute encoder + decoder pass a step,
    decoded and averaged over the members;
  * the generic branch (`joint_sample`, and inverse rendering with
    `hoist_invariant` off): the whole model a step.

Classifier-free guidance (`_sample(guidance_scale=...)`) runs the model at
twice the batch.  `relight` chains inverse rendering, the conditioning
light maps of a new environment and forward rendering.

The JAX package's `lax.scan` is a Python loop here; the sampler's math is
f32 whatever the model's type.

Random numbers: `torch.Generator` and `jax.random` give different numbers
from the same seed, so the public methods draw their noise (VAE posterior
samples, the initial latents) from a generator and hand it as tensors to
the `..._with_noise` methods, which tests call with the noise the JAX
pipeline drew.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unirenderer_tpu_torch.core.config import LATENT_CHANNELS, SystemConfig
from unirenderer_tpu_torch.core.convert import load_flax
from unirenderer_tpu_torch.diffusion.samplers import UniPCState, unipc_step
from unirenderer_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, inference_timesteps,
)
from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder, blank_ids
from unirenderer_tpu_torch.models.dual_stream import (
    DualStreamModel, down_tap_channels,
)
from unirenderer_tpu_torch.models.vae import AutoencoderKL
from unirenderer_tpu_torch.ops.cubemap import cubemap_to_latlong
from unirenderer_tpu_torch.ops.flash_attention import tileable
from unirenderer_tpu_torch.render.light import (
    EnvLight, conditioning_light_maps, env_from_latlong,
)
from unirenderer_tpu_torch.utils.runtime import exact_f32

_MAP_NAMES = ("normal", "albedo", "spec_light", "diff_light", "env", "mask")
# the attribute groups after the clean mask head, in the latent's order
ATTR_GROUPS = ("material", "normal", "albedo", "spec_light", "diff_light",
               "env")


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One sampling mode: whether the image latent is denoised, and per
    attribute group after the mask head whether it is.  The legacy 16/12
    channel layouts have no clean mask head (`has_clean_head`)."""
    name: str
    denoise_img: bool
    denoise_attr: Tuple[bool, ...]
    has_clean_head: bool = True

    @property
    def any_attr(self) -> bool:
        return any(self.denoise_attr)


FORWARD_RENDER = ModeSpec("forward", True, (False,) * len(ATTR_GROUPS))
INVERSE_RENDER = ModeSpec("inverse", False, (True,) * len(ATTR_GROUPS))
JOINT_SAMPLE = ModeSpec("joint", True, (True,) * len(ATTR_GROUPS))


@torch.no_grad()
def fill_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for a run without a checkpoint: matrices and
    conv kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases
    N(0, 0.02^2).  Every tensor is filled, the zero-convs included, so the
    attribute encoder's residuals reach the UNet."""
    for name, p in module.named_parameters():
        z = torch.randn(p.shape, generator=generator, device=p.device,
                        dtype=torch.float32)
        if p.dim() >= 2:
            z *= p[0].numel() ** -0.5
        elif name.endswith("weight"):
            z = 1.0 + 0.1 * z
        else:
            z *= 0.02
        p.copy_(z)


def _in_exact_f32(method):
    """`method` with cuDNN and cuBLAS free of TF32 while the pipeline
    computes in f32 (the caller's flags restored after): f32 on the card
    means f32."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with exact_f32(self.dtype == torch.float32):
            return method(self, *args, **kwargs)
    return wrapped


class UniRendererPipeline:
    """The dual-stream model, the VAE and the text encoder on one device,
    in one compute type (`dtype`: bf16 or f32 on the card, the types of
    its kernels)."""

    # images per VAE call: bounds the full-resolution activations when the
    # forward path encodes 6 maps x batch at once
    VAE_CHUNK = 16
    # inverse rendering runs the UNet's taps once, not once a step (False:
    # the generic branch, the whole model a step; the same result)
    hoist_invariant = True

    def __init__(self, cfg: SystemConfig, dual: DualStreamModel,
                 vae: AutoencoderKL, text: CLIPTextEncoder,
                 device="cuda"):
        self.cfg = cfg
        self.dual = dual
        self.vae = vae
        self.text = text
        self.device = torch.device(device)
        self.dtype = next(dual.parameters()).dtype
        self.schedule = DiffusionSchedule.create(cfg.diffusion, self.device)
        self._blank_ctx: Optional[torch.Tensor] = None
        # the attribute groups after the mask head (6 at 28 channels)
        self.n_groups = cfg.unet.attr_channels // LATENT_CHANNELS - 1

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def create(cls, cfg: SystemConfig, generator: torch.Generator,
               device="cuda", dtype=torch.bfloat16) -> "UniRendererPipeline":
        """Build the modules directly on `device` in `dtype` (no host-side
        init) and fill them from `generator`, which must live on `device`."""
        with torch.device("meta"):
            mods = [DualStreamModel(cfg.unet), AutoencoderKL(cfg.vae),
                    CLIPTextEncoder(cfg.text)]
        for m in mods:
            m.to(dtype=dtype).to_empty(device=device)
            m.to(memory_format=torch.channels_last)
            m.eval().requires_grad_(False)
            fill_random_(m, generator)
        return cls(cfg, *mods, device=device)

    def load_flax(self, dual: Optional[Mapping[str, np.ndarray]] = None,
                  vae: Optional[Mapping[str, np.ndarray]] = None,
                  text: Optional[Mapping[str, np.ndarray]] = None) -> int:
        """Load flax parameters ({path joined with '/': array}, as
        `core/checkpoint.load_params_npz` returns them) into the given
        parts, strictly.  Returns the number of tensors loaded."""
        loaded = 0
        for flat, module in ((dual, self.dual), (vae, self.vae),
                             (text, self.text)):
            if flat is not None:
                loaded += load_flax(module, flat)
        self._blank_ctx = None
        return loaded

    # ------------------------------------------------------------------
    # Encoders / decoders
    # ------------------------------------------------------------------

    @_in_exact_f32
    def blank_context(self, batch: int) -> torch.Tensor:
        """Context of the constant ' ' prompt, computed once."""
        if self._blank_ctx is None:
            self._blank_ctx = self.text(blank_ids(self.cfg.text, self.device))
        return self._blank_ctx.expand(batch, -1, -1)

    @_in_exact_f32
    def _vae_encode(self, images: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images + (N, h, w, 4) noise -> scaled latents."""
        moments = [self.vae.encode(chunk)
                   for chunk in images.split(self.VAE_CHUNK)]
        mean = torch.cat([m for m, _ in moments]).float()
        logvar = torch.cat([lv for _, lv in moments]).float()
        z = mean + torch.exp(0.5 * logvar) * noise
        return z * self.cfg.vae.scaling_factor

    @_in_exact_f32
    def _vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents / self.cfg.vae.scaling_factor
        return torch.cat([self.vae.decode(chunk).float()
                          for chunk in z.split(self.VAE_CHUNK)])

    @torch.no_grad()
    def encode_images(self, images, noise) -> torch.Tensor:
        """(B, H, W, 3) images in [-1, 1] -> scaled latents (B, h, w, 4),
        the posterior sampled with `noise` (B, h, w, 4): the JAX
        pipeline's `encode_images`, its key's draw handed in."""
        return self._vae_encode(self._tensor(images), self._tensor(noise))

    @torch.no_grad()
    def decode_latents(self, latents) -> torch.Tensor:
        """Scaled latents (B, h, w, 4) -> images (B, H, W, 3), f32: the JAX
        pipeline's `decode_latents`."""
        return self._vae_decode(self._tensor(latents))

    def material_latent(self, metallic: torch.Tensor,
                        roughness: torch.Tensor, shape) -> torch.Tensor:
        """(B, h, w, 4) = [m, m, r, r] * 2 - 1, the raw constant map."""
        b, h, w, _ = shape
        m = metallic.reshape(-1, 1, 1, 1).expand(b, h, w, 2)
        r = roughness.reshape(-1, 1, 1, 1).expand(b, h, w, 2)
        return torch.cat([m, r], dim=-1) * 2.0 - 1.0

    def _encode_maps(self, maps: Dict[str, torch.Tensor],
                     noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """VAE-encode several (B, H, W, 3) maps in one batched call."""
        names = list(maps)
        z = self._vae_encode(torch.cat([maps[n] for n in names]), noise)
        return dict(zip(names, z.chunk(len(names))))

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    def _timesteps(self, num_steps: int):
        """(timesteps, the next ones with 0 last, is-final flags) on the
        pipeline's device."""
        dev = self.device
        ts = torch.as_tensor(inference_timesteps(
            self.cfg.diffusion.num_train_timesteps, num_steps), device=dev)
        ts_next = torch.cat([ts[1:], torch.zeros(1, dtype=ts.dtype,
                                                 device=dev)])
        is_final = torch.arange(num_steps, device=dev) == num_steps - 1
        return ts, ts_next, is_final

    @_in_exact_f32
    def _sample(self, mode: ModeSpec, img_init: torch.Tensor,
                attr_groups_init: torch.Tensor, mask_latent: torch.Tensor,
                ctx: torch.Tensor, num_steps: int,
                guidance_scale: float = 0.0,
                neg_ctx: Optional[torch.Tensor] = None):
        """The sampling engine (the JAX `_sample_core`, its scan a loop).

        img_init (B, h, w, 4): the image latent, clean or noise per mode;
        attr_groups_init (G, B, h, w, 4): the attribute groups after the
        mask head, clean or noise; mask_latent (B, h, w, 4): the clean mask
        head (unused without one).  `guidance_scale` > 1: classifier-free
        guidance, the model at batch 2B in (cond, uncond) chunks, uncond
        under `neg_ctx` (`ctx` when None), each prediction u + s (c - u).

        Three branches, as in JAX: no attribute group denoised (forward
        rendering) -> the attribute encoder once, then one UNet pass a step
        (with `cfg.sampler.encoder_reuse` k > 1 the encoder half only on
        steps i % k == 0 and the last); the image clean and
        `hoist_invariant` -> the UNet's raw taps once, then the attribute
        encoder and decoder a step; else the whole model a step.  Every
        stream and group steps by UniPC in f32; a group that `mode` does
        not denoise keeps its input.  -> (img_latent, attr_groups), f32."""
        img = img_init.float()
        groups = attr_groups_init.float()
        head = [mask_latent.float()] if mode.has_clean_head else []
        guided = guidance_scale > 1.0
        if guided:
            ctx = torch.cat([ctx, ctx if neg_ctx is None else neg_ctx])

        def double(x):
            return torch.cat([x, x]) if guided else x

        def guide(pred):
            if not guided:
                return pred
            c, u = pred.chunk(2)
            return u + guidance_scale * (c - u)

        def attr_preds(pred):
            # the (cond, uncond) combination, the clean head's prediction
            # dropped, split into the groups
            pred = guide(pred)
            if mode.has_clean_head:
                pred = pred[..., LATENT_CHANNELS:]
            return torch.stack(pred.split(LATENT_CHANNELS, dim=-1))

        keep = None
        if not all(mode.denoise_attr):
            keep = torch.tensor([not d for d in mode.denoise_attr],
                                device=self.device).reshape(-1, 1, 1, 1, 1)

        def step_groups(state, groups, pred, i):
            state, nxt = unipc_step(self.schedule, state, groups, pred,
                                    ts[i], ts_next[i], is_final[i])
            return state, nxt if keep is None else torch.where(keep, groups,
                                                               nxt)

        ts, ts_next, is_final = self._timesteps(num_steps)
        nb = 2 * img.shape[0] if guided else img.shape[0]
        t0 = torch.zeros(nb, dtype=torch.long, device=self.device)

        if not mode.any_attr:
            attr_flat = double(torch.cat(head + list(groups.unbind(0)), -1))
            ctrl_down, ctrl_mid = self.dual.encode_attr(attr_flat, t0, ctx)
            k = max(1, int(self.cfg.sampler.encoder_reuse))
            state = UniPCState.init(img.shape, device=self.device)
            cache = None
            for i in range(num_steps):
                t = ts[i].expand(nb)
                if i % k == 0 or i == num_steps - 1:
                    pred, *raw = self.dual.image_stream_full_taps(
                        double(img), t, ctx, ctrl_down, ctrl_mid)
                    cache = raw if k > 1 else None
                else:
                    pred = self.dual.image_stream_cached(t, ctx, ctrl_down,
                                                         ctrl_mid, cache)
                state, img = unipc_step(self.schedule, state, img,
                                        guide(pred), ts[i], ts_next[i],
                                        is_final[i])
            return img, groups

        state = UniPCState.init(groups.shape, device=self.device)
        if not mode.denoise_img and self.hoist_invariant:
            # the image latent is clean at t_img = 0 and the attribute
            # decoder reads the UNet's taps before any residual: the UNet
            # pass is the same at every step
            unet_down, unet_mid = self.dual.unet_raw_taps(double(img), t0,
                                                          ctx)
            for i in range(num_steps):
                attr_flat = double(torch.cat(head + list(groups.unbind(0)),
                                             -1))
                pred = self.dual.attr_streams_with_unet_taps(
                    attr_flat, ts[i].expand(nb), ctx, unet_down, unet_mid)
                state, groups = step_groups(state, groups, attr_preds(pred),
                                            i)
            return img, groups

        img_state = UniPCState.init(img.shape, device=self.device)
        for i in range(num_steps):
            t = ts[i].expand(nb)
            attr_flat = double(torch.cat(head + list(groups.unbind(0)), -1))
            img_pred, attr_pred = self.dual(
                double(img), attr_flat, t if mode.denoise_img else t0, t,
                ctx)
            if mode.denoise_img:
                img_state, img = unipc_step(self.schedule, img_state, img,
                                            guide(img_pred), ts[i],
                                            ts_next[i], is_final[i])
            state, groups = step_groups(state, groups, attr_preds(attr_pred),
                                        i)
        return img, groups

    # ------------------------------------------------------------------
    # Public API: the production 28-channel family
    # ------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def _latent_shape(self, images) -> Tuple[int, int, int, int]:
        """(B, h, w, 4) of the latents of (B, H, W, C) images."""
        b, hgt, wid, _ = np.shape(images)
        f = self.cfg.vae.downscale
        return (b, hgt // f, wid // f, LATENT_CHANNELS)

    def _randn(self, shape, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    @torch.no_grad()
    def mask2image_3mod_albedo(self, *, normal, albedo, spec_light,
                               diff_light, env, mask, metallic, roughness,
                               generator: torch.Generator,
                               num_steps: Optional[int] = None,
                               latents_are_raw: bool = False,
                               material_image_encode: bool = False
                               ) -> torch.Tensor:
        """Forward rendering: intrinsics -> RGB (B, H, W, 3) in [-1, 1].

        `generator` (on the pipeline's device) draws the VAE posterior noise
        and the initial image noise.  `latents_are_raw`: the maps are
        already (B, h, w, 4) latents, and nothing is VAE-encoded.
        `material_image_encode`: VAE-encode the masked [m, m, r] material
        image, as training feeds it, instead of the raw constant latent
        [m, m, r, r] * 2 - 1 (not with `latents_are_raw`)."""
        if latents_are_raw:
            lat_shape, enc_noise = tuple(np.shape(normal)), None
        else:
            lat_shape = self._latent_shape(normal)
            n_maps = len(_MAP_NAMES) + int(material_image_encode)
            enc_noise = self._randn((n_maps * lat_shape[0],) + lat_shape[1:],
                                    generator)
        img_noise = self._randn(lat_shape, generator)
        return self.mask2image_3mod_albedo_with_noise(
            normal=normal, albedo=albedo, spec_light=spec_light,
            diff_light=diff_light, env=env, mask=mask, metallic=metallic,
            roughness=roughness, enc_noise=enc_noise, img_noise=img_noise,
            num_steps=num_steps, latents_are_raw=latents_are_raw,
            material_image_encode=material_image_encode)

    mask2image_3mod_albedo_black = mask2image_3mod_albedo

    @torch.no_grad()
    def mask2image_3mod_albedo_with_noise(
            self, *, normal, albedo, spec_light, diff_light, env, mask,
            metallic, roughness, enc_noise, img_noise,
            num_steps: Optional[int] = None, latents_are_raw: bool = False,
            material_image_encode: bool = False) -> torch.Tensor:
        """`mask2image_3mod_albedo` with its noise given: `enc_noise`
        (6 * B, h, w, 4) for the posterior samples of the maps stacked in
        the order normal, albedo, spec_light, diff_light, env, mask (then
        material: 7 * B, with `material_image_encode`; None with
        `latents_are_raw`), and `img_noise` (B, h, w, 4).  Without
        `material_image_encode` (or with `latents_are_raw`) the material
        group is the raw constant latent [m, m, r, r] * 2 - 1."""
        num_steps = num_steps or self.cfg.sampler.num_steps
        given = dict(normal=normal, albedo=albedo, spec_light=spec_light,
                     diff_light=diff_light, env=env, mask=mask)
        maps = {n: self._tensor(given[n]) for n in _MAP_NAMES}
        metallic = self._tensor(metallic)
        roughness = self._tensor(roughness)
        encode_material = material_image_encode and not latents_are_raw
        if latents_are_raw:
            lat = maps
        else:
            if encode_material:
                maps["material"] = material_image(maps["mask"], metallic,
                                                  roughness)
            lat = self._encode_maps(maps, self._tensor(enc_noise))
        shape = lat["normal"].shape
        if encode_material:
            material = lat["material"]
        else:
            material = self.material_latent(metallic, roughness, shape)
        groups = torch.stack([material, lat["normal"], lat["albedo"],
                              lat["spec_light"], lat["diff_light"],
                              lat["env"]])
        img_lat, _ = self._sample(FORWARD_RENDER, self._tensor(img_noise),
                                  groups, lat["mask"],
                                  self.blank_context(shape[0]), num_steps)
        return self._vae_decode(img_lat)

    @staticmethod
    def material_from_latent(material_latent: torch.Tensor):
        """Inverse of `material_latent`: the means of the two halves,
        mapped back to [0, 1] -> (metallic, roughness), each (B, h, w)."""
        m = (material_latent[..., :2].mean(dim=-1) + 1.0) / 2.0
        r = (material_latent[..., 2:].mean(dim=-1) + 1.0) / 2.0
        return m, r

    @torch.no_grad()
    def image2mask_3mod_albedo(self, *, image, mask,
                               generator: torch.Generator,
                               num_steps: Optional[int] = None,
                               material_readout: str = "decode"
                               ) -> Dict[str, torch.Tensor]:
        """Inverse rendering of a rendered image: the ensemble-1 form of
        `real_image2mask_3mod_albedo`."""
        return self._inverse(image=image, mask=mask, generator=generator,
                             num_steps=num_steps, ensemble=1,
                             material_readout=material_readout)

    @torch.no_grad()
    def real_image2mask_3mod_albedo(self, *, image, mask,
                                    generator: torch.Generator,
                                    num_steps: Optional[int] = None,
                                    ensemble: Optional[int] = None,
                                    material_readout: str = "decode"
                                    ) -> Dict[str, torch.Tensor]:
        """Inverse rendering: a photo (B, H, W, 3) in [-1, 1] and its mask
        (B, H, W, 3) in [-1, 1] -> the maps, averaged over `ensemble` runs
        (`cfg.sampler.ensemble` by default).

        Returns normal, albedo, spec_light, diff_light, env (B, H, W, 3)
        decoded images; metallic, roughness per-pixel maps (B, H, W), or
        (B, h, w) with `material_readout="latent"`, multiplied by the mask;
        material_latents (B, h, w, 4).  `material_readout`: "decode" reads
        metallic/roughness from the VAE-decoded [m, m, r] material image,
        the inverse of what training encodes; "latent" from the raw latent
        halves (`material_from_latent`).  `generator` (on the pipeline's
        device) draws the VAE posterior noise and the groups' noise."""
        return self._inverse(image=image, mask=mask, generator=generator,
                             num_steps=num_steps,
                             ensemble=ensemble or self.cfg.sampler.ensemble,
                             material_readout=material_readout)

    def _inverse(self, *, image, mask, generator, num_steps, ensemble,
                 material_readout):
        e = max(1, int(ensemble))
        b, *lat = self._latent_shape(image)
        enc_noise = self._randn((2 * b, *lat), generator)
        attr_noise = self._randn((self.n_groups, e * b, *lat), generator)
        return self.real_image2mask_3mod_albedo_with_noise(
            image=image, mask=mask, enc_noise=enc_noise,
            attr_noise=attr_noise, num_steps=num_steps, ensemble=e,
            material_readout=material_readout)

    @torch.no_grad()
    def real_image2mask_3mod_albedo_with_noise(
            self, *, image, mask, enc_noise, attr_noise,
            num_steps: Optional[int] = None, ensemble: int = 1,
            material_readout: str = "decode") -> Dict[str, torch.Tensor]:
        """`real_image2mask_3mod_albedo` with its noise given: `enc_noise`
        (2 * B, h, w, 4) for the posterior samples of image then mask, and
        `attr_noise` (6, ensemble * B, h, w, 4), the groups' initial noise
        with the ensemble's members member-major along the batch."""
        if material_readout not in ("decode", "latent"):
            raise ValueError(f"material_readout {material_readout!r}: "
                             f"'decode' or 'latent'")
        num_steps = num_steps or self.cfg.sampler.num_steps
        e = max(1, int(ensemble))
        image, mask = self._tensor(image), self._tensor(mask)
        lat = self._encode_maps(dict(image=image, mask=mask),
                                self._tensor(enc_noise))
        img_lat, mask_lat = lat["image"], lat["mask"]
        b = img_lat.shape[0]
        # the ensemble folded into the batch: latents encoded once, tiled
        img_lat, mask_lat = img_lat.repeat(e, 1, 1, 1), mask_lat.repeat(
            e, 1, 1, 1)
        n = e * b
        _, groups = self._sample(INVERSE_RENDER, img_lat,
                                 self._tensor(attr_noise), mask_lat,
                                 self.blank_context(n), num_steps)
        g = groups.shape[0]
        material = groups[0]
        if material_readout == "decode":
            decoded = self._vae_decode(groups.flatten(0, 1)).unflatten(
                0, (g, n))
            mat01 = torch.clamp(decoded[0] * 0.5 + 0.5, 0.0, 1.0)  # [m,m,r]
            metallic = mat01[..., :2].mean(dim=-1)
            roughness = mat01[..., 2]
            maps = decoded[1:]
        else:
            metallic, roughness = self.material_from_latent(material)
            maps = self._vae_decode(groups[1:].flatten(0, 1)).unflatten(
                0, (g - 1, n))
        if mask.shape[-1] == 3:
            # the material read-out is masked
            maskv = ((mask[..., 0] + 1.0) / 2.0).repeat(e, 1, 1)
            mh = resize_nearest(maskv, metallic.shape[1:])
            metallic, roughness = metallic * mh, roughness * mh
        out = dict(zip(ATTR_GROUPS[1:], maps.unbind(0)))
        out.update(metallic=metallic, roughness=roughness,
                   material_latents=material)
        # members averaged after the decode
        return {k: v.unflatten(0, (e, b)).mean(dim=0) for k, v in out.items()}

    @torch.no_grad()
    def joint_sample(self, *, batch: int, mask, generator: torch.Generator,
                     num_steps: Optional[int] = None):
        """Joint generation: the image and every attribute group denoised
        together from noise, beside the clean mask (B, H, W, 3) in [-1, 1]
        -> (image latent (B, h, w, 4), attribute groups (6, B, h, w, 4)),
        undecoded.  The batch is the mask's; `batch` is the JAX method's
        argument, which it reads nowhere either."""
        lat = self._latent_shape(mask)
        enc_noise = self._randn(lat, generator)
        img_noise = self._randn(lat, generator)
        attr_noise = self._randn((self.n_groups,) + lat, generator)
        return self.joint_sample_with_noise(
            mask=mask, enc_noise=enc_noise, img_noise=img_noise,
            attr_noise=attr_noise, num_steps=num_steps)

    @torch.no_grad()
    def joint_sample_with_noise(self, *, mask, enc_noise, img_noise,
                                attr_noise, num_steps: Optional[int] = None):
        """`joint_sample` with its noise given: `enc_noise` (B, h, w, 4) for
        the mask's posterior sample, `img_noise` (B, h, w, 4) and
        `attr_noise` (6, B, h, w, 4) the initial latents."""
        mask_lat = self._vae_encode(self._tensor(mask),
                                    self._tensor(enc_noise))
        return self._sample(JOINT_SAMPLE, self._tensor(img_noise),
                            self._tensor(attr_noise), mask_lat,
                            self.blank_context(mask_lat.shape[0]),
                            num_steps or self.cfg.sampler.num_steps)

    # ------------------------------------------------------------------
    # The legacy 16- and 12-channel layouts (a model built with
    # `legacy16()` / `legacy12()`): attr_channels / 4 groups, no mask head
    # ------------------------------------------------------------------

    @torch.no_grad()
    def rendering(self, *, attr_latents, generator: torch.Generator,
                  num_steps: Optional[int] = None) -> torch.Tensor:
        """Legacy forward rendering: `attr_latents` (G, B, h, w, 4), G =
        attr_channels / 4, clean -> RGB (B, H, W, 3) in [-1, 1].
        `generator` draws the initial image noise."""
        img_noise = self._randn(tuple(np.shape(attr_latents))[1:], generator)
        return self.rendering_with_noise(attr_latents=attr_latents,
                                         img_noise=img_noise,
                                         num_steps=num_steps)

    @torch.no_grad()
    def rendering_with_noise(self, *, attr_latents, img_noise,
                             num_steps: Optional[int] = None
                             ) -> torch.Tensor:
        """`rendering` with the initial image noise (B, h, w, 4) given."""
        attr_latents = self._tensor(attr_latents)
        g = attr_latents.shape[0]
        if g * LATENT_CHANNELS != self.cfg.unet.attr_channels:
            raise AssertionError(
                f"{g} groups of {LATENT_CHANNELS} channels: the legacy "
                f"methods need a model built with the matching attr_channels "
                f"({self.cfg.unet.attr_channels}; core.config.legacy16 / "
                f"legacy12)")
        mode = ModeSpec("legacy_forward", True, (False,) * g,
                        has_clean_head=False)
        img_noise = self._tensor(img_noise)
        img_lat, _ = self._sample(mode, img_noise, attr_latents,
                                  torch.zeros_like(img_noise),
                                  self.blank_context(img_noise.shape[0]),
                                  num_steps or self.cfg.sampler.num_steps)
        return self._vae_decode(img_lat)

    @torch.no_grad()
    def inverse_rendering(self, *, image, generator: torch.Generator,
                          num_steps: Optional[int] = None) -> torch.Tensor:
        """Legacy inverse rendering: a photo (B, H, W, 3) in [-1, 1] ->
        the attribute latents (G, B, h, w, 4), G = attr_channels / 4, every
        group denoised from noise.  `generator` draws the posterior noise
        and the groups' noise."""
        lat = self._latent_shape(image)
        g = self.cfg.unet.attr_channels // LATENT_CHANNELS
        enc_noise = self._randn(lat, generator)
        attr_noise = self._randn((g,) + lat, generator)
        return self.inverse_rendering_with_noise(
            image=image, enc_noise=enc_noise, attr_noise=attr_noise,
            num_steps=num_steps)

    @torch.no_grad()
    def inverse_rendering_with_noise(self, *, image, enc_noise, attr_noise,
                                     num_steps: Optional[int] = None
                                     ) -> torch.Tensor:
        """`inverse_rendering` with its noise given: `enc_noise` (B, h, w,
        4) for the photo's posterior sample, `attr_noise` (G, B, h, w, 4)
        the groups' initial noise."""
        img_lat = self._vae_encode(self._tensor(image),
                                   self._tensor(enc_noise))
        g = self.cfg.unet.attr_channels // LATENT_CHANNELS
        mode = ModeSpec("legacy_inverse", False, (True,) * g,
                        has_clean_head=False)
        _, attr = self._sample(mode, img_lat, self._tensor(attr_noise),
                               torch.zeros_like(img_lat),
                               self.blank_context(img_lat.shape[0]),
                               num_steps or self.cfg.sampler.num_steps)
        return attr

    # the reference's other names of the legacy methods
    mask2image = mask2image_3mod = rendering
    image2mask = image2mask_3mod = inverse_rendering
    mask2image_with_noise = mask2image_3mod_with_noise = rendering_with_noise
    image2mask_with_noise = image2mask_3mod_with_noise = (
        inverse_rendering_with_noise)

    # ------------------------------------------------------------------
    # Relighting: decompose, swap the environment, render again
    # ------------------------------------------------------------------

    @torch.no_grad()
    def relight(self, *, image, mask, new_env, generator: torch.Generator,
                num_steps: Optional[int] = None,
                ensemble: Optional[int] = None, env_res: int = 128,
                env_samples: int = 64,
                decomposed: Optional[Mapping] = None) -> torch.Tensor:
        """A photo and its mask (B, H, W, 3) in [-1, 1] under a new
        environment -> the re-lit RGB (B, H, W, 3) in [-1, 1].

        Inverse-renders the photo (`real_image2mask_3mod_albedo` at
        `ensemble`, 1 by default; or takes its result as `decomposed`),
        then forward-renders the decomposed normal and albedo with the
        spec/diff light maps of `new_env` rebuilt from the decomposed
        normals (`conditioning_light_maps`), composited over white, and the
        masked mean of the decomposed metallic/roughness, the material
        image VAE-encoded.  `new_env`: an `EnvLight`, or an (H, W, 3)
        linear HDR latlong, prefiltered here at `env_res` with
        `env_samples` samples.  Normals and `new_env` are in the frame of
        the camera that took the photo.  `generator` draws the inverse
        pass's noise, then the forward pass's."""
        if decomposed is None:
            decomposed = self.real_image2mask_3mod_albedo(
                image=image, mask=mask, generator=generator,
                num_steps=num_steps, ensemble=ensemble or 1)
        lat = self._latent_shape(mask)
        enc_noise = self._randn(((len(_MAP_NAMES) + 1) * lat[0],) + lat[1:],
                                generator)
        img_noise = self._randn(lat, generator)
        return self.relight_with_noise(
            mask=mask, new_env=new_env, decomposed=decomposed,
            enc_noise=enc_noise, img_noise=img_noise, num_steps=num_steps,
            env_res=env_res, env_samples=env_samples)

    @torch.no_grad()
    def relight_with_noise(self, *, mask, new_env, decomposed: Mapping,
                           enc_noise, img_noise,
                           num_steps: Optional[int] = None,
                           env_res: int = 128, env_samples: int = 64
                           ) -> torch.Tensor:
        """`relight` from a decomposition with the forward pass's noise
        given: `enc_noise` (7 * B, h, w, 4) and `img_noise` (B, h, w, 4),
        as `mask2image_3mod_albedo_with_noise` takes them with
        `material_image_encode`."""
        mask = self._tensor(mask)
        dec = {k: self._tensor(decomposed[k])
               for k in ("normal", "albedo", "metallic", "roughness")}
        # the masked mean: the decomposed maps are multiplied by the mask,
        # so a plain mean would scale them by the object's coverage
        mh = resize_nearest((mask[..., 0] + 1.0) / 2.0,
                            dec["metallic"].shape[1:])
        denom = torch.clamp(mh.sum(dim=(1, 2)), min=1e-6)
        metallic = (dec["metallic"] * mh).sum(dim=(1, 2)) / denom
        roughness = (dec["roughness"] * mh).sum(dim=(1, 2)) / denom
        if not isinstance(new_env, EnvLight):
            new_env = env_from_latlong(self._tensor(new_env), res=env_res,
                                       num_samples=env_samples)
        mask01 = torch.clamp(mask * 0.5 + 0.5, 0.0, 1.0)
        spec_l, diff_l = conditioning_light_maps(new_env, dec["normal"],
                                                 roughness)
        # over the white background, as the training maps, in [-1, 1]
        spec_img = (spec_l * mask01 + (1.0 - mask01)) * 2.0 - 1.0
        diff_img = (diff_l * mask01 + (1.0 - mask01)) * 2.0 - 1.0
        hw = dec["normal"].shape[1]
        env_img = cubemap_to_latlong(new_env.diffuse, (hw, hw))
        env_img = torch.clamp(env_img, 0.0, 1.0) * 2.0 - 1.0
        return self.mask2image_3mod_albedo_with_noise(
            normal=dec["normal"], albedo=dec["albedo"], spec_light=spec_img,
            diff_light=diff_img, env=env_img.expand(dec["normal"].shape),
            mask=mask, metallic=metallic, roughness=roughness,
            enc_noise=enc_noise, img_noise=img_noise, num_steps=num_steps,
            material_image_encode=True)


def material_image(mask: torch.Tensor, metallic: torch.Tensor,
                   roughness: torch.Tensor) -> torch.Tensor:
    """The masked material image [m, m, r] * 2 - 1 (B, H, W, 3): metallic
    m and roughness r (B,) under the mask (B, H, W, 3) in [-1, 1], zero
    outside it."""
    mask01 = torch.clamp(mask * 0.5 + 0.5, 0.0, 1.0)[..., :1]
    m = metallic.reshape(-1, 1, 1, 1) * mask01
    r = roughness.reshape(-1, 1, 1, 1) * mask01
    return torch.cat([m, m, r], dim=-1) * 2.0 - 1.0


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(N, H, W) -> (N, *size), nearest neighbour at half-pixel centres, as
    `jax.image.resize(..., "nearest")` samples (PyTorch's "nearest-exact";
    its "nearest" samples the top-left corners and differs)."""
    return F.interpolate(x[:, None], size=tuple(size),
                         mode="nearest-exact")[:, 0]


class KernelCalls:
    """The calls the two model kernels get, worked out from the config:
    GroupNorm (x shape, groups, eps, silu) and attention (q shape, k
    shape), in the form the wrappers record in `.seen`, each counted with
    its multiplicity.  The request methods add the calls of one call of
    the pipeline's entry point of that name and return self, so that
    `signatures` are the shapes each kernel sees and `launches` the calls
    it gets.  `block_runs` counts the down and up blocks that many times
    (activation checkpointing runs their forward twice)."""

    def __init__(self, cfg: SystemConfig, image_size: int):
        self.cfg, self.image_size = cfg, image_size
        self.lat = image_size // cfg.vae.downscale
        self.gn, self.attn = Counter(), Counter()
        self._runs = 1

    @property
    def signatures(self):
        """(K1 call signatures, K2 call signatures), each a set."""
        return set(self.gn), set(self.attn)

    @property
    def launches(self) -> Dict[str, int]:
        return {"groupnorm_silu": sum(self.gn.values()),
                "flash_attention": sum(self.attn.values())}

    def _resnet(self, n, r, cin, cout, groups):
        self.gn[((n, r, r, cin), groups, 1e-5, True)] += self._runs
        self.gn[((n, r, r, cout), groups, 1e-5, True)] += self._runs

    def _transformer(self, n, r, ch):
        u = self.cfg.unet
        self.gn[((n, r, r, ch), u.norm_num_groups, 1e-6, False)] += self._runs
        q = (n, r * r, u.num_heads, ch // u.num_heads)
        calls = u.transformer_layers * self._runs
        self.attn[(q, q)] += calls
        self.attn[(q, (n, self.cfg.text.max_length) + q[2:])] += calls

    def encoder_half(self, n, block_runs: int = 1):
        """conv_in, down and mid blocks (the UNet's and the attribute
        encoder's) at batch n."""
        u = self.cfg.unet
        r, prev = self.lat, u.block_out_channels[0]
        self._runs = block_runs
        for i, ch in enumerate(u.block_out_channels):
            for _ in range(u.layers_per_block):
                self._resnet(n, r, prev, ch, u.norm_num_groups)
                prev = ch
                if u.down_block_attn[i]:
                    self._transformer(n, r, ch)
            if i != len(u.block_out_channels) - 1:
                r //= 2
        self._runs = 1
        self._resnet(n, r, prev, prev, u.norm_num_groups)
        self._transformer(n, r, prev)
        self._resnet(n, r, prev, prev, u.norm_num_groups)

    def decoder_half(self, n, block_runs: int = 1):
        """Up blocks and conv_norm_out (the UNet's and the attribute
        decoder's) at batch n."""
        u = self.cfg.unet
        skips = down_tap_channels(u)
        r = self.lat // 2 ** (len(u.block_out_channels) - 1)
        prev = u.block_out_channels[-1]
        self._runs = block_runs
        for i, ch in enumerate(reversed(u.block_out_channels)):
            for _ in range(u.layers_per_block + 1):
                self._resnet(n, r, prev + skips.pop(), ch, u.norm_num_groups)
                prev = ch
                if u.up_block_attn[i]:
                    self._transformer(n, r, ch)
            if i != len(u.block_out_channels) - 1:
                r *= 2
        self._runs = 1
        self.gn[((n, self.lat, self.lat, u.block_out_channels[0]),
                 u.norm_num_groups, 1e-5, True)] += 1

    def vae_encoder(self, images):
        """The VAE encoder over a stack of `images`, in VAE_CHUNK chunks."""
        vc, g = self.cfg.vae, self.cfg.vae.norm_num_groups
        for n in _chunks(images):
            r, prev = self.image_size, vc.block_out_channels[0]
            for i, ch in enumerate(vc.block_out_channels):
                for _ in range(vc.layers_per_block):
                    self._resnet(n, r, prev, ch, g)
                    prev = ch
                if i != len(vc.block_out_channels) - 1:
                    r //= 2
            self._vae_mid(n, r, prev)
            self.gn[((n, r, r, prev), g, 1e-6, True)] += 1

    def vae_decoder(self, latents):
        """The VAE decoder over a stack of `latents`, in VAE_CHUNK chunks."""
        vc, g = self.cfg.vae, self.cfg.vae.norm_num_groups
        for n in _chunks(latents):
            r, prev = self.lat, vc.block_out_channels[-1]
            self._vae_mid(n, r, prev)
            for i, ch in enumerate(reversed(vc.block_out_channels)):
                for _ in range(vc.layers_per_block + 1):
                    self._resnet(n, r, prev, ch, g)
                    prev = ch
                if i != len(vc.block_out_channels) - 1:
                    r *= 2
            self.gn[((n, self.image_size, self.image_size, prev), g,
                     1e-6, True)] += 1

    def _vae_mid(self, n, r, ch):
        g = self.cfg.vae.norm_num_groups
        self._resnet(n, r, ch, ch, g)
        self.gn[((n, r, r, ch), g, 1e-6, False)] += 1
        self._resnet(n, r, ch, ch, g)

    # ---- the pipeline's entry points

    def sample(self, mode: ModeSpec, n: int, num_steps: int,
               guidance: bool = False, hoist: bool = True,
               encoder_reuse: int = 1) -> "KernelCalls":
        """One `_sample` at batch n (2n under guidance), as its branch
        runs it."""
        nb = 2 * n if guidance else n
        if not mode.any_attr:
            self.encoder_half(nb)                   # the attribute encoder
            for i in range(num_steps):
                if i % encoder_reuse == 0 or i == num_steps - 1:
                    self.encoder_half(nb)           # the UNet's encoder half
                self.decoder_half(nb)
        elif not mode.denoise_img and hoist:
            self.encoder_half(nb)                   # the UNet's raw taps
            for _ in range(num_steps):
                self.encoder_half(nb)
                self.decoder_half(nb)
        else:
            for _ in range(num_steps):              # the whole model
                self.encoder_half(nb)
                self.encoder_half(nb)
                self.decoder_half(nb)
                self.decoder_half(nb)
        return self

    def mask2image_3mod_albedo(self, batch: int, num_steps: int,
                               material_image_encode: bool = False,
                               latents_are_raw: bool = False,
                               encoder_reuse: Optional[int] = None
                               ) -> "KernelCalls":
        """`encoder_reuse`: the config's by default."""
        if encoder_reuse is None:
            encoder_reuse = max(1, int(self.cfg.sampler.encoder_reuse))
        if not latents_are_raw:
            self.vae_encoder(batch * (len(_MAP_NAMES)
                                      + int(material_image_encode)))
        self.sample(FORWARD_RENDER, batch, num_steps,
                    encoder_reuse=encoder_reuse)
        self.vae_decoder(batch)
        return self

    def real_image2mask_3mod_albedo(self, batch: int, num_steps: int,
                                    ensemble: int = 1,
                                    material_readout: str = "decode",
                                    hoist: bool = True) -> "KernelCalls":
        n = batch * ensemble
        self.vae_encoder(2 * batch)                 # image and mask
        self.sample(INVERSE_RENDER, n, num_steps, hoist=hoist)
        groups = len(ATTR_GROUPS) - int(material_readout == "latent")
        self.vae_decoder(groups * n)
        return self

    def joint_sample(self, batch: int, num_steps: int) -> "KernelCalls":
        self.vae_encoder(batch)                     # the mask
        return self.sample(JOINT_SAMPLE, batch, num_steps)

    def rendering(self, batch: int, num_steps: int) -> "KernelCalls":
        self.sample(ModeSpec("legacy_forward", True, (False,),
                             has_clean_head=False), batch, num_steps)
        self.vae_decoder(batch)
        return self

    def inverse_rendering(self, batch: int, num_steps: int
                          ) -> "KernelCalls":
        self.vae_encoder(batch)
        return self.sample(ModeSpec("legacy_inverse", False, (True,),
                                    has_clean_head=False), batch, num_steps)

    def relight(self, batch: int, num_steps: int, ensemble: int = 1
                ) -> "KernelCalls":
        """`relight` without `decomposed`: inverse, then forward rendering
        with the material image encoded."""
        self.real_image2mask_3mod_albedo(batch, num_steps, ensemble)
        return self.mask2image_3mod_albedo(batch, num_steps,
                                           material_image_encode=True)


def _chunks(n: int) -> List[int]:
    chunk = UniRendererPipeline.VAE_CHUNK
    return [min(chunk, n - i) for i in range(0, n, chunk)]


def kernel_cases(cfg: SystemConfig, batch: int, image_size: int,
                 material_image_encode: bool = False):
    """Every call signature the two kernels see in one
    `mask2image_3mod_albedo` of `batch` requests at `image_size` (with or
    without `material_image_encode`), worked out from the config:
    GroupNorm (x shape, groups, eps, silu) and attention (q shape, k
    shape), in the form the wrappers record in `.seen`.  Lets a check on
    the card cover exactly the main path's shapes."""
    return KernelCalls(cfg, image_size).mask2image_3mod_albedo(
        batch, 1, material_image_encode).signatures


def inverse_kernel_cases(cfg: SystemConfig, batch: int, image_size: int,
                         ensemble: int = 1,
                         material_readout: str = "decode"):
    """The same for one `real_image2mask_3mod_albedo` of `batch` requests
    with `ensemble` members (the model runs at batch * ensemble)."""
    return KernelCalls(cfg, image_size).real_image2mask_3mod_albedo(
        batch, 1, ensemble, material_readout).signatures


def forward_self_attention_calls(cfg: SystemConfig, batch: int,
                                 image_size: int, num_steps: int) -> int:
    """How many attention calls of one `mask2image_3mod_albedo` are
    tileable self-attention (`ops.flash_attention.tileable`), the calls the
    splash and unet_flash routes take: the attribute encoder once, the
    UNet's decoder half every step and its encoder half on the steps that
    the config's `encoder_reuse` runs in full."""
    calls = KernelCalls(cfg, image_size).mask2image_3mod_albedo(
        batch, num_steps)
    return sum(c for (q, k), c in calls.attn.items()
               if q == k and tileable(q[1], k[1], q[3]))
