"""Inverse rendering in the PyTorch port against the JAX package, at
`tiny()` in float32 on the CPU.

  * the attribute decoder (`AttrDecoder`, flax `controldec`), the UNet's
    raw taps (`unet_raw_taps`) and the per-step attribute streams
    (`attr_streams_with_unet_taps`) against the flax methods, with the
    same seeded weights and numpy inputs: max|port - jax| <= 1e-4 *
    max|jax| (f32 on both sides; summation order only, as in
    tests/test_torch_models.py);
  * `real_image2mask_3mod_albedo_with_noise` at ensemble 2, 2 UniPC steps,
    both material read-outs, fed the noise the JAX pipeline draws:
    max|port - jax| <= 1e-3 on every output (as the forward slice: the
    differences pass through the sampler and two VAE passes).  One JAX
    inverse sampler compile serves both read-outs;
  * the masked read-out's resize (`resize_nearest`) against
    `jax.image.resize(..., "nearest")`, exactly;
  * `inverse_kernel_cases`, the shape list the card check is built from,
    against the calls one request makes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_rel_close, flatten, flax_shapes, random_params, tiny_pipelines,
)
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.models import dual_stream as jdual
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.convert import load_flax
from unirenderer_tpu_torch.models import dual_stream as tdual
from unirenderer_tpu_torch.ops.flash_attention import flash_attention
from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
from unirenderer_tpu_torch.pipelines import (
    inverse_kernel_cases, resize_nearest,
)

REL = 1e-4
JT = jcfg.tiny()
OUT_KEYS = ("normal", "albedo", "spec_light", "diff_light", "env",
            "metallic", "roughness", "material_latents")

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


@pytest.fixture(scope="module")
def dual():
    """The flax dual-stream model at tiny() with seeded weights and the
    port loaded strictly with the same ones."""
    u = JT.unet
    s, b = u.sample_size, 2
    img, attr, ctx = _inputs(31, (b, s, s, 4), (b, s, s, u.attr_channels),
                             (b, JT.text.max_length, u.cross_attention_dim))
    t = jnp.zeros((b,), jnp.int32)
    jm = jdual.DualStreamModel(u, jnp.float32)
    params = random_params(flax_shapes(jm, jnp.asarray(img),
                                       jnp.asarray(attr), t, t,
                                       jnp.asarray(ctx)), 31)
    tm = tdual.DualStreamModel(tcfg.tiny().unet)
    flat = flatten(params["params"])
    assert load_flax(tm, flat) == len(flat)
    return jm, params, tm.eval(), (img, attr, ctx)


def _compare(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g, np.asarray(w), REL, f"{what}[{i}]")


def test_unet_raw_taps_match_flax(dual):
    jm, params, tm, (img, _, ctx) = dual
    t_img = np.array([0, 0], np.int32)
    jdown, jmid = jm.apply(params, jnp.asarray(img), jnp.asarray(t_img),
                           jnp.asarray(ctx), method="unet_raw_taps")
    with torch.no_grad():
        tdown, tmid = tm.unet_raw_taps(torch.from_numpy(img),
                                       torch.from_numpy(t_img).long(),
                                       torch.from_numpy(ctx))
    _compare((tmid,) + tdown, (jmid,) + tuple(jdown), "unet_raw_taps")


def test_attr_streams_with_unet_taps_match_flax(dual):
    jm, params, tm, (img, attr, ctx) = dual
    t_attr = np.array([981, 17], np.int32)
    jdown, jmid = jm.apply(params, jnp.asarray(img), jnp.zeros(2, jnp.int32),
                           jnp.asarray(ctx), method="unet_raw_taps")
    want = jm.apply(params, jnp.asarray(attr), jnp.asarray(t_attr),
                    jnp.asarray(ctx), jdown, jmid,
                    method="attr_streams_with_unet_taps")
    with torch.no_grad():
        tdown, tmid = tm.unet_raw_taps(torch.from_numpy(img),
                                       torch.zeros(2, dtype=torch.long),
                                       torch.from_numpy(ctx))
        got = tm.attr_streams_with_unet_taps(
            torch.from_numpy(attr), torch.from_numpy(t_attr).long(),
            torch.from_numpy(ctx), tdown, tmid)
    assert got.shape == (2, JT.unet.sample_size, JT.unet.sample_size, 28)
    _compare((got,), (want,), "attr_streams_with_unet_taps")


def test_attr_decoder_matches_flax(dual):
    """The decoder alone, on independent random taps for both streams."""
    jm, params, tm, (img, _, ctx) = dual
    jdown, jmid = jm.apply(params, jnp.asarray(img), jnp.zeros(2, jnp.int32),
                           jnp.asarray(ctx), method="unet_raw_taps")
    shapes = [np.shape(x) for x in (jmid, *jdown)]
    enc = _inputs(41, *shapes)
    unet = _inputs(42, *shapes)
    t_attr = np.array([500, 3], np.int32)
    want = jm.apply(params, jnp.asarray(enc[0]),
                    tuple(jnp.asarray(x) for x in enc[1:]),
                    jnp.asarray(t_attr), jnp.asarray(ctx),
                    tuple(jnp.asarray(x) for x in unet[1:]),
                    jnp.asarray(unet[0]),
                    method=lambda m, *a: m.decoder(*a))
    with torch.no_grad():
        got = tm.controldec(torch.from_numpy(enc[0]),
                            tuple(torch.from_numpy(x) for x in enc[1:]),
                            torch.from_numpy(t_attr).long(),
                            torch.from_numpy(ctx),
                            tuple(torch.from_numpy(x) for x in unet[1:]),
                            torch.from_numpy(unet[0]))
    _compare((got,), (want,), "AttrDecoder")


# ---------------------------------------------------------------------------
# The inverse path end to end
# ---------------------------------------------------------------------------


def _inverse_request(cfg, b, seed):
    rng = np.random.default_rng(seed)
    res = cfg.vae.sample_size
    image = rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32)
    # a per-pixel mask: a latent-size read-out then depends on which pixel
    # the resize samples
    mask = np.where(rng.uniform(size=(b, res, res, 1)) > 0.4, 1.0, -1.0)
    return image, np.repeat(mask, 3, axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipelines()


@pytest.mark.parametrize("readout", ["decode", "latent"])
def test_inverse_matches_jax(pipes, readout):
    jpipe, tpipe = pipes
    cfg = jpipe.cfg
    b, e, steps = 2, 2, 2
    image, mask = _inverse_request(cfg, b, seed=17)
    rng = jax.random.key(17)
    want = jpipe.real_image2mask_3mod_albedo(
        image=jnp.asarray(image), mask=jnp.asarray(mask), rng=rng,
        num_steps=steps, ensemble=e, material_readout=readout)
    # the noise the JAX pipeline drew (pipelines.py `_inverse`)
    k_enc, k_noise = jax.random.split(rng)
    lat = cfg.vae.sample_size // cfg.vae.downscale
    enc_noise = jax.random.normal(k_enc, (2 * b, lat, lat, 4))
    attr_noise = jax.random.normal(k_noise, (6, e * b, lat, lat, 4))
    got = tpipe.real_image2mask_3mod_albedo_with_noise(
        image=image, mask=mask, enc_noise=np.asarray(enc_noise),
        attr_noise=np.asarray(attr_noise), num_steps=steps, ensemble=e,
        material_readout=readout)
    assert set(got) == set(want) == set(OUT_KEYS)
    for k in OUT_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert np.abs(w).max() > 0.01, k          # not a trivial output
        err = np.abs(got[k].numpy() - w).max()
        assert err <= 1e-3, (k, err)
    side = cfg.vae.sample_size if readout == "decode" else lat
    assert got["metallic"].shape == (b, side, side)


def test_inverse_entry_points_draw_from_the_generator(pipes):
    _, tpipe = pipes
    image, mask = _inverse_request(tpipe.cfg, 2, seed=5)
    outs = [tpipe.real_image2mask_3mod_albedo(
        image=image, mask=mask, generator=torch.Generator().manual_seed(s),
        num_steps=1) for s in (0, 1)]
    assert not torch.equal(outs[0]["albedo"], outs[1]["albedo"])
    one = tpipe.image2mask_3mod_albedo(
        image=image, mask=mask, generator=torch.Generator().manual_seed(0),
        num_steps=1)
    # tiny()'s ensemble is 1: the same request, drawn from the same seed
    for k in OUT_KEYS:
        assert torch.equal(one[k], outs[0][k]), k
    with pytest.raises(ValueError):
        tpipe.image2mask_3mod_albedo(
            image=image, mask=mask, generator=torch.Generator(),
            num_steps=1, material_readout="mean")


def test_resize_nearest_matches_jax():
    """`jax.image.resize(..., "nearest")` samples half-pixel centres: an
    8x8 ramp to 2x2 gives [18, 22, 50, 54] (top-left corners would give
    [0, 4, 32, 36]).  Down and up, exactly."""
    ramp = np.arange(64, dtype=np.float32).reshape(1, 8, 8)
    got = resize_nearest(torch.from_numpy(ramp), (2, 2)).numpy()
    np.testing.assert_array_equal(got.ravel(), [18, 22, 50, 54])
    x = np.random.default_rng(0).standard_normal((2, 16, 12))
    x = x.astype(np.float32)
    for size in ((8, 6), (5, 7), (16, 12), (20, 30)):
        want = np.asarray(jax.image.resize(x, (2,) + size, "nearest"))
        got = resize_nearest(torch.from_numpy(x), size).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(size))


@pytest.mark.parametrize("readout", ["decode", "latent"])
def test_inverse_kernel_cases_are_the_shapes_the_path_runs(pipes, readout):
    _, tpipe = pipes
    cfg = tpipe.cfg
    image, mask = _inverse_request(cfg, 2, seed=3)
    fused_groupnorm_silu.seen.clear()
    flash_attention.seen.clear()
    tpipe.real_image2mask_3mod_albedo(
        image=image, mask=mask, generator=torch.Generator().manual_seed(0),
        num_steps=1, ensemble=3, material_readout=readout)
    want = inverse_kernel_cases(cfg, 2, cfg.vae.sample_size, 3, readout)
    assert (fused_groupnorm_silu.seen, flash_attention.seen) == want
