"""The port's generic and inverse branches and the legacy layouts against
the JAX package, at `tiny(4)` in float32 on the CPU, both fed the same
latents, noise and context:

  * `joint_sample_with_noise` against `joint_sample` with the JAX draws;
  * the inverse branch with `hoist_invariant` off (the whole model a step)
    against JAX's, and against the port's hoisted branch;
  * guidance (`guidance_scale` 2, with and without a negative context) in
    the hoisted inverse and the generic (joint) branches against the JAX
    `_sample`;
  * the legacy 16- and 12-channel layouts: the presets field for field,
    `rendering` and `inverse_rendering` against JAX, the channel check,
    the aliases, the strict load of a legacy model;
  * the K1/K2 calls of these paths against `KernelCalls`.

Tolerances, as tests/test_torch_pipeline.py states them: max|port - jax|
<= 1e-3 on latents after the sampler and on decoded [-1, 1] images; the
hoisted and unhoisted inverse in the port within 1e-5 of each other (as
tests/test_pipeline.py holds JAX's two branches).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_abs_close, blank_or_random_ctx, count_kernel_calls, sample_both,
    sampler_inputs, seen_kernel_calls, tiny_pipelines,
)
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu_torch import pipelines as tpl
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel

LATENT = 4
STEPS = 3
TOL = 1e-3

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipelines(LATENT)


@pytest.fixture(scope="module", params=[16, 12])
def legacy(request):
    """(attr_channels, jax pipe, port pipe) of a legacy layout."""
    return (request.param,) + tiny_pipelines(LATENT, request.param)


def _mask(cfg, b, seed):
    rng = np.random.default_rng(seed)
    res = cfg.vae.sample_size
    m = np.where(rng.uniform(size=(b, res, res, 1)) > 0.4, 1.0, -1.0)
    return np.repeat(m, 3, -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Joint sampling, the unhoisted inverse, guidance
# ---------------------------------------------------------------------------


def test_joint_sample_matches_jax(pipes):
    jpipe, tpipe = pipes
    b, lat = 2, jpipe.cfg.unet.sample_size
    mask = _mask(jpipe.cfg, b, seed=1)
    key = jax.random.key(1)
    want = jpipe.joint_sample(batch=b, mask=jnp.asarray(mask), rng=key,
                              num_steps=STEPS)
    k_enc, k1, k2 = jax.random.split(key, 3)
    shape = (b, lat, lat, 4)
    got = tpipe.joint_sample_with_noise(
        mask=mask, enc_noise=np.asarray(jax.random.normal(k_enc, shape)),
        img_noise=np.asarray(jax.random.normal(k1, shape)),
        attr_noise=np.asarray(jax.random.normal(k2, (6,) + shape)),
        num_steps=STEPS)
    for what, g, w in zip(("image latent", "attribute groups"), got, want):
        assert_abs_close(g, np.asarray(w), TOL, what)
    drawn = tpipe.joint_sample(batch=b, mask=mask, num_steps=1,
                               generator=torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in drawn] == [shape, (6,) + shape]


def test_unhoisted_inverse_matches_jax_and_the_hoisted_one(pipes,
                                                          monkeypatch):
    jpipe, tpipe = pipes
    inputs = sampler_inputs(jpipe.cfg, 2, seed=2)
    ctx = blank_or_random_ctx(jpipe, 2)
    _, (_, hoisted) = sample_both(pipes, "INVERSE_RENDER", inputs, ctx,
                                  STEPS)
    monkeypatch.setattr(jpipe, "hoist_invariant", False, raising=False)
    monkeypatch.setattr(tpipe, "hoist_invariant", False)
    (img_w, want), (img_g, got) = sample_both(pipes, "INVERSE_RENDER",
                                              inputs, ctx, STEPS)
    assert_abs_close(got, want, TOL, "unhoisted inverse")
    np.testing.assert_array_equal(img_g, inputs[0])      # the image clean
    np.testing.assert_allclose(got, hoisted, atol=1e-5)


@pytest.mark.parametrize("mode", ["INVERSE_RENDER", "JOINT_SAMPLE"])
@pytest.mark.parametrize("negative", [False, True])
def test_guidance_matches_jax(pipes, mode, negative):
    """The hoisted inverse branch and the generic one (joint sampling:
    the image and the attribute predictions both guided)."""
    jpipe, _ = pipes
    inputs = sampler_inputs(jpipe.cfg, 2, seed=3)
    neg = (blank_or_random_ctx(jpipe, 2, negative_seed=4) if negative
           else None)
    want, got = sample_both(pipes, mode, inputs,
                            blank_or_random_ctx(jpipe, 2), STEPS, 2.0, neg)
    for i, (g, w) in enumerate(zip(got, want)):
        if mode == "INVERSE_RENDER" and i == 0:
            np.testing.assert_array_equal(g, inputs[0])
        else:
            assert_abs_close(g, w, TOL, f"{mode} guided output {i}")


def test_groups_not_denoised_keep_their_input(pipes):
    """A mode that denoises every other group (the hoisted inverse
    branch): those groups match JAX's, the others are returned as given."""
    from unirenderer_tpu import pipelines as jpl
    jpipe, tpipe = pipes
    sel = (True, False) * 3
    jmode = jpl.ModeSpec("alternate", False, sel)
    tmode = tpl.ModeSpec("alternate", False, sel)
    img, attr, mask = sampler_inputs(jpipe.cfg, 2, seed=8)
    ctx = blank_or_random_ctx(jpipe, 2)
    _, want = jpipe._sample(jmode, *map(jnp.asarray, (img, attr, mask, ctx)),
                            STEPS)
    _, got = tpipe._sample(tmode, *map(torch.from_numpy,
                                       (img, attr, mask, ctx)), STEPS)
    assert_abs_close(got.numpy(), np.asarray(want), TOL, "alternate groups")
    np.testing.assert_array_equal(got.numpy()[1::2], attr[1::2])


# ---------------------------------------------------------------------------
# The legacy layouts
# ---------------------------------------------------------------------------


# the port's one stated difference (its TrainConfig docstring): None picks
# bf16 on the card and f32 on the CPU
BY_DESIGN = {"cfg.train.compute_dtype"}


def _same_fields(port, ref, path="cfg"):
    """Every field the port's config carries equals the JAX preset's."""
    for f in dataclasses.fields(port):
        if f"{path}.{f.name}" in BY_DESIGN:
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, f"{path}.{f.name}")
        else:
            assert a == b, (f"{path}.{f.name}", a, b)


@pytest.mark.parametrize("preset", ["legacy16", "legacy12", "flagship"])
def test_presets_match_jax_field_for_field(preset):
    _same_fields(getattr(tcfg, preset)(), getattr(jcfg, preset)())


def test_legacy_rendering_matches_jax(legacy):
    c, jpipe, tpipe = legacy
    g, lat = c // 4, jpipe.cfg.unet.sample_size
    rng = np.random.default_rng(c)
    attr = rng.standard_normal((g, 2, lat, lat, 4)).astype(np.float32)
    key = jax.random.key(c)
    want = np.asarray(jpipe.rendering(attr_latents=jnp.asarray(attr),
                                      rng=key, num_steps=STEPS))
    noise = np.asarray(jax.random.normal(key, (2, lat, lat, 4)))
    got = tpipe.rendering_with_noise(attr_latents=attr, img_noise=noise,
                                     num_steps=STEPS)
    assert_abs_close(got, want, TOL, f"legacy {c} rendering")


def test_legacy_inverse_rendering_matches_jax(legacy):
    c, jpipe, tpipe = legacy
    g, lat = c // 4, jpipe.cfg.unet.sample_size
    res = jpipe.cfg.vae.sample_size
    image = np.random.default_rng(c + 1).uniform(
        -1, 1, (2, res, res, 3)).astype(np.float32)
    key = jax.random.key(c + 1)
    want = np.asarray(jpipe.inverse_rendering(
        image=jnp.asarray(image), rng=key, num_steps=STEPS))
    k_enc, k_noise = jax.random.split(key)
    shape = (2, lat, lat, 4)
    got = tpipe.inverse_rendering_with_noise(
        image=image, enc_noise=np.asarray(jax.random.normal(k_enc, shape)),
        attr_noise=np.asarray(jax.random.normal(k_noise, (g,) + shape)),
        num_steps=STEPS)
    assert got.shape == (g,) + shape
    assert_abs_close(got, want, TOL, f"legacy {c} inverse_rendering")


def test_legacy_channel_mismatch_raises(legacy):
    c, _, tpipe = legacy
    lat = tpipe.cfg.unet.sample_size
    bad = np.zeros((c // 4 + 1, 1, lat, lat, 4), np.float32)
    with pytest.raises(AssertionError, match="attr_channels"):
        tpipe.rendering(attr_latents=bad, num_steps=1,
                        generator=torch.Generator())


def test_legacy_aliases_are_the_methods(legacy):
    c, _, tpipe = legacy
    p = tpl.UniRendererPipeline
    for name in ("mask2image", "mask2image_3mod"):
        assert getattr(p, name) is p.rendering
        assert getattr(p, name + "_with_noise") is p.rendering_with_noise
    for name in ("image2mask", "image2mask_3mod"):
        assert getattr(p, name) is p.inverse_rendering
        assert (getattr(p, name + "_with_noise")
                is p.inverse_rendering_with_noise)
    lat, res = tpipe.cfg.unet.sample_size, tpipe.cfg.vae.sample_size
    out = tpipe.image2mask(image=np.zeros((1, res, res, 3), np.float32),
                           generator=torch.Generator().manual_seed(0),
                           num_steps=1)
    assert out.shape == (c // 4, 1, lat, lat, 4)
    img = tpipe.mask2image(attr_latents=out, num_steps=1,
                           generator=torch.Generator().manual_seed(0))
    assert img.shape == (1, res, res, 3) and torch.isfinite(img).all()


def test_legacy_model_loads_strictly(legacy):
    """The legacy model took every flax tensor (`tiny_pipelines` checks
    the count); against the production layout only the attribute
    encoder's conv_in and the attribute decoder's conv_out change shape."""
    c, _, tpipe = legacy
    mine = {k: tuple(v.shape) for k, v in tpipe.dual.state_dict().items()}
    prod = DualStreamModel(tcfg.tiny(LATENT).unet)
    theirs = {k: tuple(v.shape) for k, v in prod.state_dict().items()}
    assert mine.keys() == theirs.keys()
    changed = {k for k in mine if mine[k] != theirs[k]}
    assert changed == {"controlnet.conv_in.weight",
                       "controldec.conv_out.weight",
                       "controldec.conv_out.bias"}
    assert mine["controlnet.conv_in.weight"][1] == c
    assert mine["controldec.conv_out.weight"][0] == c


# ---------------------------------------------------------------------------
# Kernel calls
# ---------------------------------------------------------------------------


def test_joint_and_unhoisted_kernel_calls(pipes, monkeypatch):
    """Joint sampling and the unhoisted inverse run the whole model a
    step; the hoisted inverse the UNet's encoder half once."""
    _, tpipe = pipes
    cfg, res = tpipe.cfg, tpipe.cfg.vae.sample_size
    mask = _mask(cfg, 2, seed=5)
    counts = count_kernel_calls(monkeypatch)
    tpipe.joint_sample(batch=2, mask=mask, num_steps=2,
                       generator=torch.Generator().manual_seed(0))
    calls = tpl.KernelCalls(cfg, res).joint_sample(2, 2)
    assert (seen_kernel_calls(), dict(counts)) == (calls.signatures,
                                                   calls.launches)
    for hoist in (True, False):
        monkeypatch.setattr(tpipe, "hoist_invariant", hoist)
        counts = count_kernel_calls(monkeypatch)
        tpipe.image2mask_3mod_albedo(
            image=mask, mask=mask, num_steps=2,
            generator=torch.Generator().manual_seed(0))
        calls = tpl.KernelCalls(cfg, res).real_image2mask_3mod_albedo(
            2, 2, hoist=hoist)
        assert (seen_kernel_calls(), dict(counts)) == (calls.signatures,
                                                       calls.launches)


def test_legacy_kernel_calls(legacy, monkeypatch):
    _, _, tpipe = legacy
    cfg, res = tpipe.cfg, tpipe.cfg.vae.sample_size
    image = _mask(cfg, 1, seed=6)
    counts = count_kernel_calls(monkeypatch)
    attr = tpipe.inverse_rendering(image=image, num_steps=2,
                                   generator=torch.Generator().manual_seed(0))
    calls = tpl.KernelCalls(cfg, res).inverse_rendering(1, 2)
    assert (seen_kernel_calls(), dict(counts)) == (calls.signatures,
                                                   calls.launches)
    counts = count_kernel_calls(monkeypatch)
    tpipe.rendering(attr_latents=attr, num_steps=2,
                    generator=torch.Generator().manual_seed(0))
    calls = tpl.KernelCalls(cfg, res).rendering(1, 2)
    assert (seen_kernel_calls(), dict(counts)) == (calls.signatures,
                                                   calls.launches)
