"""Relighting in the port against the JAX package, at `tiny(4)` in float32
on the CPU:

  * `render.light.conditioning_light_maps` on one prefiltered environment
    (the JAX one's arrays, so only the lookups are compared) and a normal
    map: max|port - jax| <= 1e-4 * max|jax| (a single module call);
  * `relight` from a given decomposition with the forward pass's noise
    handed in, against the JAX method (environment prefiltered on both
    sides): max|port - jax| <= 1e-3 on the decoded [-1, 1] image, as for
    every sampler path;
  * the masked mean of metallic and roughness (the regression of
    tests/test_pipeline.py `test_relight_material_readout_undiluted`);
  * `trainable_env`: its draws cannot be jax.random's, so its shape,
    range and seeding;
  * the K1/K2 calls of a full `relight` (inverse, then forward rendering)
    against `KernelCalls`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_abs_close, assert_rel_close, count_kernel_calls,
    seen_kernel_calls, tiny_pipelines,
)
from unirenderer_tpu.render import light as jlight
from unirenderer_tpu_torch import pipelines as tpl
from unirenderer_tpu_torch.render import light as tlight

LATENT = 4
ENV_RES, ENV_SAMPLES = 64, 16       # three specular mips down to 16

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipelines(LATENT)


def _latlong(seed):
    """A small linear-HDR latlong (8, 16, 3)."""
    return np.random.default_rng(seed).uniform(
        0.0, 2.0, (8, 16, 3)).astype(np.float32)


def _scene(cfg, b, seed):
    """A mask (B, H, W, 3) in {-1, 1} and a decomposition of it: normal
    and albedo maps in [-1, 1], metallic and roughness maps multiplied by
    the mask, as `real_image2mask_3mod_albedo` returns them."""
    rng = np.random.default_rng(seed)
    res = cfg.vae.sample_size
    cover = (rng.uniform(size=(b, res, res)) > 0.3).astype(np.float32)
    dec = {k: rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32)
           for k in ("normal", "albedo")}
    dec["metallic"] = cover * rng.uniform(0, 1, (b, 1, 1)).astype(np.float32)
    dec["roughness"] = cover * rng.uniform(0, 1, (b, 1, 1)).astype(
        np.float32)
    mask = np.repeat(cover[..., None] * 2.0 - 1.0, 3, -1).astype(np.float32)
    return mask, dec


def test_conditioning_light_maps_match_jax():
    jenv = jlight.env_from_latlong(jnp.asarray(_latlong(1)), res=32,
                                   min_res=8, num_samples=8)
    tenv = tlight.EnvLight(
        specular=tuple(torch.from_numpy(np.array(m)) for m in jenv.specular),
        diffuse=torch.from_numpy(np.array(jenv.diffuse)))
    rng = np.random.default_rng(2)
    normal = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    rough = np.array([0.15, 0.8], np.float32)
    want = jlight.conditioning_light_maps(jenv, jnp.asarray(normal),
                                          jnp.asarray(rough))
    got = tlight.conditioning_light_maps(tenv, torch.from_numpy(normal),
                                         torch.from_numpy(rough))
    for what, g, w in zip(("spec_light", "diff_light"), got, want):
        assert_rel_close(g, np.asarray(w), 1e-4, what)
    # a scalar roughness is every pixel's
    got1 = tlight.conditioning_light_maps(tenv, torch.from_numpy(normal),
                                          0.8)
    assert torch.equal(got1[0][1], got[0][1])


def test_relight_matches_jax(pipes):
    jpipe, tpipe = pipes
    b = 2
    mask, dec = _scene(jpipe.cfg, b, seed=3)
    latlong = _latlong(4)
    key = jax.random.key(3)
    want = np.asarray(jpipe.relight(
        image=jnp.zeros_like(jnp.asarray(mask)), mask=jnp.asarray(mask),
        new_env=jnp.asarray(latlong), rng=key, num_steps=3, env_res=ENV_RES,
        env_samples=ENV_SAMPLES,
        decomposed={k: jnp.asarray(v) for k, v in dec.items()}))
    # the forward pass's draws: relight splits (k1, k2), the forward
    # method splits k2 into the posterior noise of 7 maps and the image's
    k_enc, k_noise = jax.random.split(jax.random.split(key)[1])
    lat = jpipe.cfg.unet.sample_size
    got = tpipe.relight_with_noise(
        mask=mask, new_env=latlong, decomposed=dec,
        enc_noise=np.asarray(jax.random.normal(k_enc, (7 * b, lat, lat, 4))),
        img_noise=np.asarray(jax.random.normal(k_noise, (b, lat, lat, 4))),
        num_steps=3, env_res=ENV_RES, env_samples=ENV_SAMPLES)
    assert_abs_close(got, want, 1e-3, "relight")
    env = tlight.env_from_latlong(torch.from_numpy(latlong), res=ENV_RES,
                                  num_samples=ENV_SAMPLES)
    again = tpipe.relight_with_noise(
        mask=mask, new_env=env, decomposed=dec,
        enc_noise=np.asarray(jax.random.normal(k_enc, (7 * b, lat, lat, 4))),
        img_noise=np.asarray(jax.random.normal(k_noise, (b, lat, lat, 4))),
        num_steps=3)
    assert torch.equal(again, got)          # an EnvLight is taken as it is


def test_relight_reads_the_masked_mean(pipes, monkeypatch):
    """A 25 %-coverage object at metallic 0.8, roughness 0.4 (maps
    multiplied by the mask): the forward pass gets 0.8 and 0.4, not the
    full-image means 0.2 and 0.1."""
    _, tpipe = pipes
    s = tpipe.cfg.vae.sample_size
    cover = np.zeros((1, s, s), np.float32)
    cover[:, : s // 2, : s // 2] = 1.0
    mask = np.repeat(cover[..., None] * 2.0 - 1.0, 3, -1)
    dec = dict(normal=np.zeros((1, s, s, 3), np.float32),
               albedo=np.zeros((1, s, s, 3), np.float32),
               metallic=cover * 0.8, roughness=cover * 0.4)
    captured = {}

    def forward(**kw):
        captured.update(kw)
        return torch.zeros(1, s, s, 3)

    monkeypatch.setattr(tpipe, "mask2image_3mod_albedo_with_noise", forward)
    tpipe.relight(image=np.zeros_like(mask), mask=mask,
                  new_env=np.ones((8, 16, 3), np.float32), decomposed=dec,
                  generator=torch.Generator().manual_seed(0), num_steps=2,
                  env_res=32, env_samples=4)
    np.testing.assert_allclose(captured["metallic"].numpy(), [0.8],
                               atol=1e-6)
    np.testing.assert_allclose(captured["roughness"].numpy(), [0.4],
                               atol=1e-6)
    assert captured["material_image_encode"]


def test_trainable_env_shape_and_range():
    gen = torch.Generator().manual_seed(0)
    env = tlight.trainable_env(gen, base_res=16)
    assert env.shape == (6, 16, 16, 3) and env.dtype == torch.float32
    assert env.min() >= 0.25 and env.max() < 0.75
    assert env.std() > 0.1                       # uniform: 0.5 / sqrt(12)
    again = tlight.trainable_env(torch.Generator().manual_seed(0), 16)
    assert torch.equal(env, again)
    other = tlight.trainable_env(gen, base_res=4, scale=1.0, bias=-1.0)
    assert other.min() >= -1.0 and other.max() < 0.0


def test_relight_kernel_calls(pipes, monkeypatch):
    """A relight without a decomposition: the inverse request, then the
    forward one with the material image encoded (the environment's
    prefilter and light maps call neither kernel)."""
    _, tpipe = pipes
    cfg, res = tpipe.cfg, tpipe.cfg.vae.sample_size
    mask, _ = _scene(cfg, 1, seed=5)
    counts = count_kernel_calls(monkeypatch)
    out = tpipe.relight(image=mask, mask=mask, new_env=_latlong(6),
                        generator=torch.Generator().manual_seed(0),
                        num_steps=2, env_res=32, env_samples=4)
    assert out.shape == (1, res, res, 3) and torch.isfinite(out).all()
    calls = tpl.KernelCalls(cfg, res).relight(1, 2)
    assert (seen_kernel_calls(), dict(counts)) == (calls.signatures,
                                                   calls.launches)
