"""UniRendererPipeline, forward and inverse rendering (counterpart of
`unirenderer_tpu/pipelines.py`).

Forward rendering: `mask2image_3mod_albedo` takes intrinsic maps (normal,
albedo, specular and diffuse light, environment, mask; (B, H, W, 3) in
[-1, 1]) plus
metallic/roughness, VAE-encodes the maps in chunks of `VAE_CHUNK` (with
`material_image_encode`, the masked [m, m, r] material image as a
seventh map, as training feeds it; else the raw constant latent), runs
the attribute encoder once (the attribute stream is clean at t_attr = 0,
so its residuals are loop-invariant), then denoises the image latent with
UniPC, one UNet pass per step, and VAE-decodes the result.

Inverse rendering: `real_image2mask_3mod_albedo` (and
`image2mask_3mod_albedo`, its ensemble-1 form) takes a photo and its mask,
VAE-encodes both once, tiles them over the ensemble (folded into the
batch), runs the UNet's encoder half once (the image latent is clean at
t_img = 0, and the attribute decoder reads its taps before any residual),
then denoises the six attribute groups from noise with UniPC, one encoder
+ decoder pass per step, VAE-decodes them and averages the ensemble's
members after the decode.

The JAX package's `lax.scan` is a Python loop here; the sampler's math is
f32 whatever the model's type.

Random numbers: `torch.Generator` and `jax.random` give different numbers
from the same seed, so the public methods draw their noise (VAE posterior
samples, the initial latents) from a generator and hand it as tensors to
the `..._with_noise` methods, which tests call with the noise the JAX
pipeline drew.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Mapping, Optional

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
from unirenderer_tpu_torch.ops.flash_attention import tileable

_MAP_NAMES = ("normal", "albedo", "spec_light", "diff_light", "env", "mask")
# the attribute groups after the clean mask head, in the latent's order
ATTR_GROUPS = ("material", "normal", "albedo", "spec_light", "diff_light",
               "env")


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


class UniRendererPipeline:
    """The dual-stream model, the VAE and the text encoder on one device."""

    # images per VAE call: bounds the full-resolution activations when the
    # forward path encodes 6 maps x batch at once
    VAE_CHUNK = 16

    def __init__(self, cfg: SystemConfig, dual: DualStreamModel,
                 vae: AutoencoderKL, text: CLIPTextEncoder,
                 device="cuda"):
        self.cfg = cfg
        self.dual = dual
        self.vae = vae
        self.text = text
        self.device = torch.device(device)
        self.schedule = DiffusionSchedule.create(cfg.diffusion, self.device)
        self._blank_ctx: Optional[torch.Tensor] = None

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

    def blank_context(self, batch: int) -> torch.Tensor:
        """Context of the constant ' ' prompt, computed once."""
        if self._blank_ctx is None:
            self._blank_ctx = self.text(blank_ids(self.cfg.text, self.device))
        return self._blank_ctx.expand(batch, -1, -1)

    def _vae_encode(self, images: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images + (N, h, w, 4) noise -> scaled latents."""
        moments = [self.vae.encode(chunk)
                   for chunk in images.split(self.VAE_CHUNK)]
        mean = torch.cat([m for m, _ in moments]).float()
        logvar = torch.cat([lv for _, lv in moments]).float()
        z = mean + torch.exp(0.5 * logvar) * noise
        return z * self.cfg.vae.scaling_factor

    def _vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents / self.cfg.vae.scaling_factor
        return torch.cat([self.vae.decode(chunk).float()
                          for chunk in z.split(self.VAE_CHUNK)])

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

    def _sample_forward(self, img_init: torch.Tensor,
                        attr_groups: List[torch.Tensor],
                        mask_latent: torch.Tensor, ctx: torch.Tensor,
                        num_steps: int) -> torch.Tensor:
        """The forward-rendering branch of the JAX `_sample_core` (no
        guidance, encoder evaluated once), its scan as a loop."""
        dev = self.device
        ts, ts_next, is_final = self._timesteps(num_steps)
        img = img_init.float()
        attr_flat = torch.cat([mask_latent.float()]
                              + [g.float() for g in attr_groups], dim=-1)
        nb = attr_flat.shape[0]
        ctrl_down, ctrl_mid = self.dual.encode_attr(
            attr_flat, torch.zeros(nb, dtype=torch.long, device=dev), ctx)
        state = UniPCState.init(img.shape, device=dev)
        for i in range(num_steps):
            pred = self.dual.image_stream_with_residuals(
                img, ts[i].expand(nb), ctx, ctrl_down, ctrl_mid)
            state, img = unipc_step(self.schedule, state, img, pred, ts[i],
                                    ts_next[i], is_final[i])
        return img

    def _sample_inverse(self, img_latent: torch.Tensor,
                        attr_init: torch.Tensor, mask_latent: torch.Tensor,
                        ctx: torch.Tensor, num_steps: int) -> torch.Tensor:
        """The hoisted inverse branch of the JAX `_sample_core` (no
        guidance): the UNet's raw taps once at t = 0, then per step the
        attribute encoder and decoder at t.  `attr_init` (G, N, h, w, 4) is
        the groups' initial noise; the G groups step through UniPC as one
        tensor with a leading group axis (the JAX package vmaps
        `unipc_step` over them: every group shares the timesteps and the
        step count, and the step is elementwise, so the batching is
        exact).  Returns the denoised groups (G, N, h, w, 4)."""
        dev = self.device
        ts, ts_next, is_final = self._timesteps(num_steps)
        nb = img_latent.shape[0]
        unet_down, unet_mid = self.dual.unet_raw_taps(
            img_latent.float(), torch.zeros(nb, dtype=torch.long, device=dev),
            ctx)
        mask = mask_latent.float()
        groups = attr_init.float()
        state = UniPCState.init(groups.shape, device=dev)
        for i in range(num_steps):
            attr_flat = torch.cat([mask, *groups.unbind(0)], dim=-1)
            pred = self.dual.attr_streams_with_unet_taps(
                attr_flat, ts[i].expand(nb), ctx, unet_down, unet_mid)
            # drop the clean mask's prediction, split the rest into groups
            pred = torch.stack(pred[..., LATENT_CHANNELS:].split(
                LATENT_CHANNELS, dim=-1))
            state, groups = unipc_step(self.schedule, state, groups, pred,
                                       ts[i], ts_next[i], is_final[i])
        return groups

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def mask2image_3mod_albedo(self, *, normal, albedo, spec_light,
                               diff_light, env, mask, metallic, roughness,
                               generator: torch.Generator,
                               num_steps: Optional[int] = None,
                               material_image_encode: bool = False
                               ) -> torch.Tensor:
        """Forward rendering: intrinsics -> RGB (B, H, W, 3) in [-1, 1].

        `generator` (on the pipeline's device) draws the VAE posterior noise
        and the initial image noise.  `material_image_encode`: VAE-encode
        the masked [m, m, r] material image, as training feeds it, instead
        of the raw constant latent [m, m, r, r] * 2 - 1."""
        b, hgt, wid, _ = np.shape(normal)
        f = self.cfg.vae.downscale
        lat_shape = (b, hgt // f, wid // f, LATENT_CHANNELS)
        n_maps = len(_MAP_NAMES) + int(material_image_encode)
        enc_noise = torch.randn((n_maps * b,) + lat_shape[1:],
                                generator=generator, device=self.device)
        img_noise = torch.randn(lat_shape, generator=generator,
                                device=self.device)
        return self.mask2image_3mod_albedo_with_noise(
            normal=normal, albedo=albedo, spec_light=spec_light,
            diff_light=diff_light, env=env, mask=mask, metallic=metallic,
            roughness=roughness, enc_noise=enc_noise, img_noise=img_noise,
            num_steps=num_steps, material_image_encode=material_image_encode)

    mask2image_3mod_albedo_black = mask2image_3mod_albedo

    @torch.no_grad()
    def mask2image_3mod_albedo_with_noise(
            self, *, normal, albedo, spec_light, diff_light, env, mask,
            metallic, roughness, enc_noise, img_noise,
            num_steps: Optional[int] = None,
            material_image_encode: bool = False) -> torch.Tensor:
        """`mask2image_3mod_albedo` with its noise given: `enc_noise`
        (6 * B, h, w, 4) for the posterior samples of the maps stacked in
        the order normal, albedo, spec_light, diff_light, env, mask (then
        material: 7 * B, with `material_image_encode`), and `img_noise`
        (B, h, w, 4).  Without `material_image_encode` the material group
        is the raw constant latent [m, m, r, r] * 2 - 1, not VAE-encoded."""
        num_steps = num_steps or self.cfg.sampler.num_steps
        given = dict(normal=normal, albedo=albedo, spec_light=spec_light,
                     diff_light=diff_light, env=env, mask=mask)
        maps = {n: self._tensor(given[n]) for n in _MAP_NAMES}
        metallic = self._tensor(metallic)
        roughness = self._tensor(roughness)
        if material_image_encode:
            mask01 = torch.clamp(maps["mask"] * 0.5 + 0.5, 0.0, 1.0)[..., :1]
            m = metallic.reshape(-1, 1, 1, 1) * mask01
            r = roughness.reshape(-1, 1, 1, 1) * mask01
            maps["material"] = torch.cat([m, m, r], dim=-1) * 2.0 - 1.0
        lat = self._encode_maps(maps, self._tensor(enc_noise))
        shape = lat["normal"].shape
        if material_image_encode:
            material = lat["material"]
        else:
            material = self.material_latent(metallic, roughness, shape)
        groups = [material, lat["normal"], lat["albedo"], lat["spec_light"],
                  lat["diff_light"], lat["env"]]
        ctx = self.blank_context(shape[0])
        img_lat = self._sample_forward(self._tensor(img_noise), groups,
                                       lat["mask"], ctx, num_steps)
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
        b, hgt, wid, _ = np.shape(image)
        f = self.cfg.vae.downscale
        lat = (hgt // f, wid // f, LATENT_CHANNELS)
        enc_noise = torch.randn((2 * b,) + lat, generator=generator,
                                device=self.device)
        attr_noise = torch.randn((len(ATTR_GROUPS), e * b) + lat,
                                 generator=generator, device=self.device)
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
        groups = self._sample_inverse(img_lat, self._tensor(attr_noise),
                                      mask_lat, self.blank_context(n),
                                      num_steps)
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


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(N, H, W) -> (N, *size), nearest neighbour at half-pixel centres, as
    `jax.image.resize(..., "nearest")` samples (PyTorch's "nearest-exact";
    its "nearest" samples the top-left corners and differs)."""
    return F.interpolate(x[:, None], size=tuple(size),
                         mode="nearest-exact")[:, 0]


class _KernelCalls:
    """The calls the two model kernels get, worked out from the config:
    GroupNorm (x shape, groups, eps, silu) and attention (q shape, k
    shape), in the form the wrappers record in `.seen`, each counted with
    its multiplicity.  `block_runs` counts the down and up blocks that
    many times (activation checkpointing runs their forward twice)."""

    def __init__(self, cfg: SystemConfig, image_size: int):
        self.cfg, self.image_size = cfg, image_size
        self.lat = image_size // cfg.vae.downscale
        self.gn, self.attn = Counter(), Counter()
        self._runs = 1

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
    calls = _KernelCalls(cfg, image_size)
    calls.encoder_half(batch)
    calls.decoder_half(batch)
    calls.vae_encoder(batch * (len(_MAP_NAMES) + int(material_image_encode)))
    calls.vae_decoder(batch)
    return set(calls.gn), set(calls.attn)


def inverse_kernel_cases(cfg: SystemConfig, batch: int, image_size: int,
                         ensemble: int = 1,
                         material_readout: str = "decode"):
    """The same for one `real_image2mask_3mod_albedo` of `batch` requests
    with `ensemble` members (the model runs at batch * ensemble)."""
    n = batch * ensemble
    calls = _KernelCalls(cfg, image_size)
    calls.encoder_half(n)           # the UNet's taps, the attribute encoder
    calls.decoder_half(n)           # the attribute decoder
    calls.vae_encoder(2 * batch)    # image and mask
    groups = len(ATTR_GROUPS) - int(material_readout == "latent")
    calls.vae_decoder(groups * n)
    return set(calls.gn), set(calls.attn)


def forward_self_attention_calls(cfg: SystemConfig, batch: int,
                                 image_size: int, num_steps: int) -> int:
    """How many attention calls of one `mask2image_3mod_albedo` are
    tileable self-attention (`ops.flash_attention.tileable`), the calls the
    splash and unet_flash routes take: the attribute encoder once, the
    UNet's both halves once per step."""
    enc, unet = _KernelCalls(cfg, image_size), _KernelCalls(cfg, image_size)
    enc.encoder_half(batch)
    unet.encoder_half(batch)
    unet.decoder_half(batch)

    def tileable_self(counter):
        return sum(c for (q, k), c in counter.items()
                   if q == k and tileable(q[1], k[1], q[3]))

    return tileable_self(enc.attn) + num_steps * tileable_self(unet.attn)
