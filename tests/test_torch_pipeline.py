"""The slice end to end: the port's `mask2image_3mod_albedo` against the JAX
pipeline at `tiny()` with 3 UniPC steps, fed the noise the JAX pipeline
draws; the weight converter on the repo's trained `small()` weights; and
the shape list the card check is built from.

Tolerances.  The slice: max|port - jax| <= 1e-3 on the [-1, 1] image
(f32 on both sides; summation-order differences pass through a 3-step
sampler and two VAE passes).  The small() model call: 1e-4 * max|jax|, as
in the module tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_rel_close, tiny_pipelines
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.core.checkpoint import load_params_npz as jax_load_npz
from unirenderer_tpu.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.checkpoint import load_params_npz
from unirenderer_tpu_torch.core.convert import (
    load_flax, state_dict_from_flax,
)
from unirenderer_tpu_torch.models.dual_stream import (
    DualStreamModel as TorchDual,
)
from unirenderer_tpu_torch.models.vae import AutoencoderKL as TorchVAE
from unirenderer_tpu_torch.ops.flash_attention import flash_attention
from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
from unirenderer_tpu_torch.pipelines import (
    UniRendererPipeline, kernel_cases,
)

DUAL_NPZ = "artifacts/r05/dual_small.npz"
VAE_NPZ = "artifacts/r04/vae_small.npz"
MAPS = ("normal", "albedo", "spec_light", "diff_light", "env", "mask")

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(scope="module")
def pipes():
    """One JAX tiny pipeline with seeded random weights and the port loaded
    with the same weights (`tiny_pipelines`)."""
    return tiny_pipelines()


def _request(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    res = cfg.vae.sample_size
    maps = {k: rng.uniform(-1, 1, (batch, res, res, 3)).astype(np.float32)
            for k in MAPS}
    maps["metallic"] = rng.uniform(0, 1, batch).astype(np.float32)
    maps["roughness"] = rng.uniform(0, 1, batch).astype(np.float32)
    return maps


@pytest.mark.parametrize("b,seed", [(2, 7), (1, 8)])
def test_forward_render_matches_jax(pipes, b, seed):
    jpipe, tpipe = pipes
    cfg = jpipe.cfg
    steps = 3
    req = _request(cfg, b, seed=seed)
    rng = jax.random.key(seed)
    want = jpipe.mask2image_3mod_albedo(
        **{k: jnp.asarray(v) for k, v in req.items()}, rng=rng,
        num_steps=steps)

    # the noise the JAX pipeline drew (pipelines.py: split, then the VAE
    # posterior noise over the stacked maps and the initial latent noise)
    k_enc, k_noise = jax.random.split(rng)
    lat = cfg.vae.sample_size // cfg.vae.downscale
    enc_noise = jax.random.normal(k_enc, (len(MAPS) * b, lat, lat, 4))
    img_noise = jax.random.normal(k_noise, (b, lat, lat, 4))
    got = tpipe.mask2image_3mod_albedo_with_noise(
        **req, enc_noise=np.asarray(enc_noise),
        img_noise=np.asarray(img_noise), num_steps=steps)

    want = np.asarray(want)
    assert got.shape == want.shape == (b, cfg.vae.sample_size,
                                       cfg.vae.sample_size, 3)
    assert np.abs(want).max() > 0.05          # not a trivial output
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-3, err


def test_material_image_encode_matches_jax(pipes):
    """`material_image_encode=True`: the masked [m, m, r] material image is
    VAE-encoded as a seventh map, so the posterior noise is 7 * B maps in
    the JAX dict order (normal, albedo, spec_light, diff_light, env, mask,
    material).  Tolerance 1e-3 as for the slice.  The result must differ
    from the raw-latent path."""
    jpipe, tpipe = pipes
    cfg = jpipe.cfg
    steps, b = 3, 2
    req = _request(cfg, b, seed=9)
    rng = jax.random.key(9)
    want = np.asarray(jpipe.mask2image_3mod_albedo(
        **{k: jnp.asarray(v) for k, v in req.items()}, rng=rng,
        num_steps=steps, material_image_encode=True))
    k_enc, k_noise = jax.random.split(rng)
    lat = cfg.vae.sample_size // cfg.vae.downscale
    enc_noise = np.asarray(jax.random.normal(
        k_enc, ((len(MAPS) + 1) * b, lat, lat, 4)))
    img_noise = np.asarray(jax.random.normal(k_noise, (b, lat, lat, 4)))
    got = tpipe.mask2image_3mod_albedo_with_noise(
        **req, enc_noise=enc_noise, img_noise=img_noise, num_steps=steps,
        material_image_encode=True)
    assert np.abs(want).max() > 0.05
    assert np.abs(got.numpy() - want).max() <= 1e-3
    raw = tpipe.mask2image_3mod_albedo_with_noise(
        **req, enc_noise=enc_noise[:len(MAPS) * b], img_noise=img_noise,
        num_steps=steps)
    assert np.abs(raw.numpy() - want).max() > 1e-2
    drawn = tpipe.mask2image_3mod_albedo(
        **req, generator=torch.Generator().manual_seed(0), num_steps=1,
        material_image_encode=True)
    assert drawn.shape == (b, cfg.vae.sample_size, cfg.vae.sample_size, 3)


def test_public_entry_draws_noise_from_generator(pipes):
    _, tpipe = pipes
    req = _request(tpipe.cfg, 2, seed=5)
    outs = [tpipe.mask2image_3mod_albedo(
        **req, generator=torch.Generator().manual_seed(s), num_steps=2)
        for s in (0, 0, 1)]
    assert outs[0].shape == (2, 16, 16, 3)
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def _kernel_calls(tpipe, b, material_image_encode):
    fused_groupnorm_silu.seen.clear()
    flash_attention.seen.clear()
    tpipe.mask2image_3mod_albedo(
        **_request(tpipe.cfg, b, seed=3), num_steps=1,
        generator=torch.Generator().manual_seed(0),
        material_image_encode=material_image_encode)
    return (kernel_cases(tpipe.cfg, b, tpipe.cfg.vae.sample_size,
                         material_image_encode),
            (fused_groupnorm_silu.seen, flash_attention.seen))


@pytest.mark.parametrize("b", [1, 2])
def test_kernel_cases_are_the_shapes_the_path_runs(pipes, b):
    """kernel_cases(), from which the card check builds its cases, lists
    exactly the calls one request makes of each kernel."""
    want, seen = _kernel_calls(pipes[1], b, False)
    assert seen == want


def test_kernel_cases_with_material_image_encode(pipes):
    """The same with the material image as a seventh VAE-encoded map."""
    want, seen = _kernel_calls(pipes[1], 2, True)
    assert seen == want
    assert want != _kernel_calls(pipes[1], 2, False)[0]


def test_entry_points_default_to_the_card():
    """With no card, building the pipeline without device="cpu" raises;
    nothing falls back to the CPU.  A pipeline whose device is the card
    (the default) runs every public sampling method there: each raises
    here at its first draw or its first tensor."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        UniRendererPipeline.create(tcfg.tiny(), torch.Generator())
    pipe = UniRendererPipeline.create(tcfg.tiny(4), torch.Generator(),
                                      device="cpu", dtype=torch.float32)
    pipe.device = torch.device("cuda")
    req = _request(pipe.cfg, 1, seed=1)
    lat = np.zeros((1, 4, 4, 4), np.float32)
    photo = dict(image=req["albedo"], mask=req["mask"])
    calls = {
        "mask2image_3mod_albedo": req,
        "mask2image_3mod_albedo_black": req,
        "image2mask_3mod_albedo": photo,
        "real_image2mask_3mod_albedo": photo,
        "joint_sample": dict(batch=1, mask=req["mask"]),
        "rendering": dict(attr_latents=np.zeros((6, 1, 4, 4, 4))),
        "inverse_rendering": dict(image=req["albedo"]),
        "mask2image": dict(attr_latents=np.zeros((6, 1, 4, 4, 4))),
        "mask2image_3mod": dict(attr_latents=np.zeros((6, 1, 4, 4, 4))),
        "image2mask": dict(image=req["albedo"]),
        "image2mask_3mod": dict(image=req["albedo"]),
        "relight": dict(photo, new_env=np.ones((8, 16, 3))),
    }
    raw = dict(req, **{k: lat for k in MAPS})
    # the error of a tensor made or moved onto the absent card
    no_card = dict(expected_exception=(RuntimeError, AssertionError),
                   match="(?i)cuda|nvidia")
    for name, kw in list(calls.items()) + [
            ("mask2image_3mod_albedo", dict(raw, latents_are_raw=True))]:
        with pytest.raises(**no_card):
            getattr(pipe, name)(**kw, generator=torch.Generator(),
                                num_steps=1)
    noise = dict(enc_noise=lat, img_noise=lat)
    with_noise = {
        "mask2image_3mod_albedo_with_noise": dict(req, **noise),
        "real_image2mask_3mod_albedo_with_noise": dict(
            photo, enc_noise=lat, attr_noise=lat),
        "joint_sample_with_noise": dict(mask=req["mask"], attr_noise=lat,
                                        **noise),
        "rendering_with_noise": dict(attr_latents=lat, img_noise=lat),
        "inverse_rendering_with_noise": dict(image=req["albedo"],
                                             enc_noise=lat, attr_noise=lat),
        "relight_with_noise": dict(mask=req["mask"], new_env=lat,
                                   decomposed={}, **noise),
    }
    for name, kw in with_noise.items():
        with pytest.raises(**no_card):
            getattr(pipe, name)(**kw, num_steps=1)


# ---------------------------------------------------------------------------
# The converter on the repo's trained small() weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_weights():
    dual_flat, step = load_params_npz(DUAL_NPZ)
    vae_flat, _ = load_params_npz(VAE_NPZ)
    return dual_flat, vae_flat, step


def test_converter_strict_load_of_trained_weights(small_weights):
    dual_flat, vae_flat, step = small_weights
    assert step == 90000
    cfg = tcfg.small()
    dual, vae = TorchDual(cfg.unet), TorchVAE(cfg.vae)
    n_dec = sum("/controldec/" in k for k in dual_flat)
    assert n_dec == 202
    # strict: every key of the file is loaded, the decoder's included
    assert load_flax(dual, dual_flat) == len(dual_flat) == 684
    assert load_flax(vae, vae_flat) == len(vae_flat)
    assert len(state_dict_from_flax(dual_flat)) == len(dual_flat)
    k = dual_flat["params/controldec/conv_out/kernel"]
    np.testing.assert_array_equal(
        dual.controldec.conv_out.weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))
    # layouts: conv (kh,kw,I,O) -> (O,I,kh,kw), dense (I,O) -> (O,I)
    k = dual_flat["params/unet/conv_in/kernel"]
    np.testing.assert_array_equal(dual.unet.conv_in.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    k = dual_flat["params/unet/time_embedding/linear_1/kernel"]
    np.testing.assert_array_equal(
        dual.unet.time_embedding.linear_1.weight.detach().numpy(), k.T)
    # a broken file is refused
    bad = dict(dual_flat)
    bad.pop("params/unet/conv_in/bias")
    with pytest.raises(KeyError):
        load_flax(TorchDual(cfg.unet), bad)


def test_trained_small_model_matches_jax(small_weights):
    """encode_attr + image_stream_with_residuals of the trained small()
    model, batch 1, port against JAX."""
    dual_flat, _, _ = small_weights
    cfg = jcfg.small()
    u, s = cfg.unet, cfg.unet.sample_size
    rng = np.random.default_rng(11)
    img = rng.standard_normal((1, s, s, 4)).astype(np.float32)
    attr = rng.standard_normal((1, s, s, u.attr_channels)).astype(np.float32)
    ctx = rng.standard_normal(
        (1, cfg.text.max_length, u.cross_attention_dim)).astype(np.float32)
    t_img = np.array([500])

    params, _ = jax_load_npz(DUAL_NPZ)
    jm = DualStreamModel(u, jnp.float32)
    jdown, jmid = jm.apply(params, jnp.asarray(attr), jnp.zeros(1, jnp.int32),
                           jnp.asarray(ctx), method="encode_attr")
    want = jm.apply(params, jnp.asarray(img), jnp.asarray(t_img),
                    jnp.asarray(ctx), jdown, jmid,
                    method="image_stream_with_residuals")

    tm = TorchDual(tcfg.small().unet)
    load_flax(tm, dual_flat)
    with torch.no_grad():
        tdown, tmid = tm.encode_attr(torch.from_numpy(attr),
                                     torch.zeros(1, dtype=torch.long),
                                     torch.from_numpy(ctx))
        got = tm.image_stream_with_residuals(
            torch.from_numpy(img), torch.from_numpy(t_img), torch.from_numpy(ctx),
            tdown, tmid)
    assert_rel_close(got, np.asarray(want), 1e-4, "small dual stream")
    assert_rel_close(tmid, np.asarray(jmid), 1e-4, "small ctrl_mid")
