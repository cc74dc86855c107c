"""UniRendererPipeline, forward rendering (counterpart of
`unirenderer_tpu/pipelines.py`).

`mask2image_3mod_albedo` takes intrinsic maps (normal, albedo, specular
and diffuse light, environment, mask; (B, H, W, 3) in [-1, 1]) plus
metallic/roughness, VAE-encodes the maps in chunks of `VAE_CHUNK` (with
`material_image_encode`, the masked [m, m, r] material image as a
seventh map, as training feeds it; else the raw constant latent), runs
the attribute encoder once (the attribute stream is clean at t_attr = 0,
so its residuals are loop-invariant), then denoises the image latent with
UniPC, one UNet pass per step, and VAE-decodes the result.  The JAX
package's `lax.scan` is a Python loop here; the sampler's math is f32
whatever the model's type.

Random numbers: `torch.Generator` and `jax.random` give different numbers
from the same seed, so the public method draws the VAE posterior noise and
the initial latent noise from a generator and hands them as tensors to
`mask2image_3mod_albedo_with_noise`, which tests call with the noise the
JAX pipeline drew.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from unirenderer_tpu_torch.core.config import LATENT_CHANNELS, SystemConfig
from unirenderer_tpu_torch.core.convert import load_flax
from unirenderer_tpu_torch.diffusion.samplers import UniPCState, unipc_step
from unirenderer_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, inference_timesteps,
)
from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder, blank_ids
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.models.vae import AutoencoderKL

_MAP_NAMES = ("normal", "albedo", "spec_light", "diff_light", "env", "mask")


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
        parts, strictly.  Returns the number of skipped decoder keys."""
        skipped = 0
        for flat, module in ((dual, self.dual), (vae, self.vae),
                             (text, self.text)):
            if flat is not None:
                skipped += load_flax(module, flat)
        self._blank_ctx = None
        return skipped

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

    def _sample_forward(self, img_init: torch.Tensor,
                        attr_groups: List[torch.Tensor],
                        mask_latent: torch.Tensor, ctx: torch.Tensor,
                        num_steps: int) -> torch.Tensor:
        """The forward-rendering branch of the JAX `_sample_core` (no
        guidance, encoder evaluated once), its scan as a loop."""
        dev = self.device
        ts = torch.as_tensor(inference_timesteps(
            self.cfg.diffusion.num_train_timesteps, num_steps), device=dev)
        ts_next = torch.cat([ts[1:], torch.zeros(1, dtype=ts.dtype,
                                                 device=dev)])
        is_final = torch.arange(num_steps, device=dev) == num_steps - 1

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


def kernel_cases(cfg: SystemConfig, batch: int, image_size: int,
                 material_image_encode: bool = False):
    """Every call signature the two kernels see in one
    `mask2image_3mod_albedo` of `batch` requests at `image_size` (with or
    without `material_image_encode`), worked out from the config:
    GroupNorm (x shape, groups, eps, silu) and attention (q shape, k
    shape), in the form the wrappers record in `.seen`.  Lets a check on
    the card cover exactly the main path's shapes."""
    u, vc = cfg.unet, cfg.vae
    gn, attn = set(), set()
    lat = image_size // vc.downscale

    def resnet(n, r, cin, cout, groups):
        gn.add(((n, r, r, cin), groups, 1e-5, True))
        gn.add(((n, r, r, cout), groups, 1e-5, True))

    def transformer(r, ch):
        gn.add(((batch, r, r, ch), u.norm_num_groups, 1e-6, False))
        q = (batch, r * r, u.num_heads, ch // u.num_heads)
        attn.add((q, q))
        attn.add((q, (batch, cfg.text.max_length) + q[2:]))

    # UNet and attribute encoder: the same encoder half
    r, prev, skips = lat, u.block_out_channels[0], [u.block_out_channels[0]]
    for i, ch in enumerate(u.block_out_channels):
        for _ in range(u.layers_per_block):
            resnet(batch, r, prev, ch, u.norm_num_groups)
            prev = ch
            if u.down_block_attn[i]:
                transformer(r, ch)
            skips.append(ch)
        if i != len(u.block_out_channels) - 1:
            skips.append(ch)
            r //= 2
    resnet(batch, r, prev, prev, u.norm_num_groups)
    transformer(r, prev)
    resnet(batch, r, prev, prev, u.norm_num_groups)
    # UNet decoder half
    for i, ch in enumerate(reversed(u.block_out_channels)):
        for _ in range(u.layers_per_block + 1):
            resnet(batch, r, prev + skips.pop(), ch, u.norm_num_groups)
            prev = ch
            if u.up_block_attn[i]:
                transformer(r, ch)
        if i != len(u.block_out_channels) - 1:
            r *= 2
    gn.add(((batch, lat, lat, u.block_out_channels[0]), u.norm_num_groups,
            1e-5, True))

    # VAE encoder over the stacked maps, decoder over the batch
    n = batch * (len(_MAP_NAMES) + int(material_image_encode))
    g = vc.norm_num_groups
    r, prev = image_size, vc.block_out_channels[0]
    for i, ch in enumerate(vc.block_out_channels):
        for _ in range(vc.layers_per_block):
            resnet(n, r, prev, ch, g)
            prev = ch
        if i != len(vc.block_out_channels) - 1:
            r //= 2
    for n_mid, r_mid in ((n, r), (batch, lat)):     # encoder, decoder mid
        resnet(n_mid, r_mid, prev, prev, g)
        gn.add(((n_mid, r_mid, r_mid, prev), g, 1e-6, False))
    gn.add(((n, r, r, prev), g, 1e-6, True))
    r = lat
    for i, ch in enumerate(reversed(vc.block_out_channels)):
        for _ in range(vc.layers_per_block + 1):
            resnet(batch, r, prev, ch, g)
            prev = ch
        if i != len(vc.block_out_channels) - 1:
            r *= 2
    gn.add(((batch, image_size, image_size, prev), g, 1e-6, True))
    return gn, attn
