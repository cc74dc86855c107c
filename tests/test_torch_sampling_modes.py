"""The forward branch of the port's sampling engine against the JAX
package, at `tiny(4)` in float32 on the CPU, both fed the same latents,
noise and context:

  * encoder reuse (`SamplerConfig.encoder_reuse` 2 and 3, with and without
    classifier-free guidance) against the JAX `_sample`; at 1 the engine
    gives the bits of a plain loop of full UNet passes (the branch before
    reuse existed); `image_stream_full_taps` and `image_stream_cached`
    against the flax methods on the same taps;
  * guidance (`guidance_scale` 2, with and without a negative context)
    against the JAX `_sample`;
  * `latents_are_raw` end to end against the JAX method;
  * the K1/K2 calls of each of these paths against `KernelCalls`.

Tolerances, as tests/test_torch_pipeline.py states them: max|port - jax|
<= 1e-3 on latents after the sampler and on decoded [-1, 1] images (f32
on both sides; summation order passes through the steps); 1e-4 * max|jax|
for a single model call.  Encoder reuse needs 4 steps to tell k = 2 (full
at steps 0, 2, 3) from k = 3 (full at 0 and 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_abs_close, assert_rel_close, blank_or_random_ctx,
    count_kernel_calls, sample_both, sampler_inputs, seen_kernel_calls,
    tiny_pipelines,
)
from unirenderer_tpu_torch import pipelines as tpl
from unirenderer_tpu_torch.diffusion.samplers import UniPCState, unipc_step

LATENT = 4
STEPS = 4
TOL = 1e-3
MAPS = ("normal", "albedo", "spec_light", "diff_light", "env", "mask")

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipelines(LATENT)


def _with_reuse(monkeypatch, pipes, k):
    for p in pipes:
        monkeypatch.setattr(p, "cfg", dataclasses.replace(
            p.cfg, sampler=dataclasses.replace(p.cfg.sampler,
                                               encoder_reuse=k)))


@pytest.mark.parametrize("k,guidance,negative", [
    (2, 0.0, False), (3, 0.0, False), (2, 2.0, False), (3, 2.0, True)])
def test_encoder_reuse_matches_jax(pipes, monkeypatch, k, guidance,
                                   negative):
    jpipe, tpipe = pipes
    inputs = sampler_inputs(jpipe.cfg, 2, seed=k)
    ctx = blank_or_random_ctx(jpipe, 2)
    neg = (blank_or_random_ctx(jpipe, 2, negative_seed=5) if negative
           else None)
    exact = tpipe._sample(tpl.FORWARD_RENDER,
                          *(torch.from_numpy(x) for x in inputs + (ctx,)),
                          STEPS, guidance,
                          None if neg is None else torch.from_numpy(neg))[0]
    _with_reuse(monkeypatch, pipes, k)
    (want, _), (got, groups) = sample_both(
        pipes, "FORWARD_RENDER", inputs, ctx, STEPS, guidance, neg)
    assert_abs_close(got, want, TOL,
                     f"encoder_reuse={k} guidance={guidance}")
    np.testing.assert_array_equal(groups, inputs[1])  # clean groups kept
    # the cached steps ran: the result is not the exact one
    assert np.abs(got - exact.numpy()).max() > 1e-3


def test_encoder_reuse_1_is_the_plain_loop(pipes, monkeypatch):
    """k = 1: the same bits as the forward branch before encoder reuse,
    a loop of full UNet passes (`image_stream_with_residuals`) after one
    pass of the attribute encoder, with the config's default and with 1
    set."""
    _, tpipe = pipes
    img, attr, mask = (torch.from_numpy(x)
                       for x in sampler_inputs(tpipe.cfg, 2, seed=1))
    ctx = tpipe.blank_context(2)
    dual, sched = tpipe.dual, tpipe.schedule
    ts, ts_next, fin = tpipe._timesteps(STEPS)
    zero = torch.zeros(2, dtype=torch.long)
    down, mid = dual.encode_attr(torch.cat([mask, *attr.unbind(0)], -1),
                                 zero, ctx)
    x, state = img, UniPCState.init(img.shape)
    with torch.no_grad():
        for i in range(STEPS):
            pred = dual.image_stream_with_residuals(x, ts[i].expand(2), ctx,
                                                    down, mid)
            state, x = unipc_step(sched, state, x, pred, ts[i], ts_next[i],
                                  fin[i])
    default = tpipe._sample(tpl.FORWARD_RENDER, img, attr, mask, ctx,
                            STEPS)[0]
    _with_reuse(monkeypatch, pipes, 1)
    one = tpipe._sample(tpl.FORWARD_RENDER, img, attr, mask, ctx, STEPS)[0]
    assert torch.equal(default, x) and torch.equal(one, x)


def test_image_stream_full_taps_and_cached_match_flax(pipes):
    """The full pass with its raw taps, and the decoder-only pass from
    given taps (random, the same numbers on both sides), at two
    timesteps."""
    jpipe, tpipe = pipes
    jm, params, tm = jpipe.dual, jpipe.dual_params, tpipe.dual
    img, attr, mask = sampler_inputs(jpipe.cfg, 2, seed=3)
    attr_flat = np.concatenate([mask, *attr], -1)
    ctx = blank_or_random_ctx(jpipe, 2)
    t0, t = np.zeros(2, np.int32), np.array([981, 17], np.int32)
    jdown, jmid = jm.apply(params, jnp.asarray(attr_flat), jnp.asarray(t0),
                           jnp.asarray(ctx), method="encode_attr")
    want = jm.apply(params, jnp.asarray(img), jnp.asarray(t),
                    jnp.asarray(ctx), jdown, jmid,
                    method="image_stream_full_taps")
    down = tuple(torch.from_numpy(np.array(x)) for x in jdown)
    mid = torch.from_numpy(np.array(jmid))
    tt, tctx = torch.from_numpy(t).long(), torch.from_numpy(ctx)
    with torch.no_grad():
        got = tm.image_stream_full_taps(torch.from_numpy(img), tt, tctx,
                                        down, mid)
    assert_rel_close(got[0], np.asarray(want[0]), 1e-4, "img_pred")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert_rel_close(g, np.asarray(w), 1e-4, f"raw down tap {i}")
    assert_rel_close(got[2], np.asarray(want[2]), 1e-4, "raw mid")

    rng = np.random.default_rng(4)
    raw = [rng.standard_normal(np.shape(x)).astype(np.float32)
           for x in (*want[1], want[2])]
    want = jm.apply(params, jnp.asarray(t[::-1]), jnp.asarray(ctx), jdown,
                    jmid, (tuple(map(jnp.asarray, raw[:-1])),
                           jnp.asarray(raw[-1])),
                    method="image_stream_cached")
    with torch.no_grad():
        got = tm.image_stream_cached(
            tt.flip(0), tctx, down, mid,
            (tuple(torch.from_numpy(x) for x in raw[:-1]),
             torch.from_numpy(raw[-1])))
    assert_rel_close(got, np.asarray(want), 1e-4, "image_stream_cached")


@pytest.mark.parametrize("negative", [False, True])
def test_forward_guidance_matches_jax(pipes, negative):
    jpipe, _ = pipes
    inputs = sampler_inputs(jpipe.cfg, 2, seed=11)
    neg = (blank_or_random_ctx(jpipe, 2, negative_seed=12) if negative
           else None)
    ctx = blank_or_random_ctx(jpipe, 2)
    (want, _), (got, _) = sample_both(pipes, "FORWARD_RENDER", inputs, ctx,
                                      3, 2.0, neg)
    assert_abs_close(got, want, TOL, f"forward guidance, negative {negative}")


def test_latents_are_raw_matches_jax(pipes):
    """The maps given as (B, h, w, 4) latents: nothing VAE-encoded, the
    material the raw constant latent; the JAX method's noise handed in."""
    jpipe, tpipe = pipes
    b, s = 2, jpipe.cfg.unet.sample_size
    rng = np.random.default_rng(21)
    req = {k: rng.standard_normal((b, s, s, 4)).astype(np.float32)
           for k in MAPS}
    req.update(metallic=np.array([0.3, 0.8], np.float32),
               roughness=np.array([0.6, 0.2], np.float32))
    key = jax.random.key(21)
    want = np.asarray(jpipe.mask2image_3mod_albedo(
        **{k: jnp.asarray(v) for k, v in req.items()}, rng=key,
        num_steps=3, latents_are_raw=True))
    img_noise = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                             (b, s, s, 4)))
    got = tpipe.mask2image_3mod_albedo_with_noise(
        **req, enc_noise=None, img_noise=img_noise, num_steps=3,
        latents_are_raw=True)
    assert_abs_close(got.numpy(), want, TOL, "latents_are_raw")
    drawn = tpipe.mask2image_3mod_albedo(
        **req, generator=torch.Generator().manual_seed(0), num_steps=1,
        latents_are_raw=True)
    assert drawn.shape == want.shape


@pytest.mark.parametrize("k", [1, 3])
def test_forward_kernel_calls_with_encoder_reuse(pipes, monkeypatch, k):
    """The shapes a forward request sends to the K1/K2 stand-ins and how
    often it calls them, against `KernelCalls` (the count chip_smoke holds
    the card's launches to)."""
    _, tpipe = pipes
    _with_reuse(monkeypatch, pipes, k)
    cfg, res = tpipe.cfg, tpipe.cfg.vae.sample_size
    rng = np.random.default_rng(2)
    req = {n: rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
           for n in MAPS}
    counts = count_kernel_calls(monkeypatch)
    tpipe.mask2image_3mod_albedo(**req, metallic=[0.1, 0.5],
                                 roughness=[0.2, 0.9], num_steps=STEPS,
                                 generator=torch.Generator().manual_seed(0))
    calls = tpl.KernelCalls(cfg, res).mask2image_3mod_albedo(2, STEPS)
    assert seen_kernel_calls() == calls.signatures
    assert dict(counts) == calls.launches
    exact = tpl.KernelCalls(cfg, res).mask2image_3mod_albedo(
        2, STEPS, encoder_reuse=1).launches
    assert (calls.launches == exact) == (k == 1)


def test_guidance_kernel_calls(pipes, monkeypatch):
    """Under guidance the model runs at twice the batch."""
    _, tpipe = pipes
    inputs = [torch.from_numpy(x)
              for x in sampler_inputs(tpipe.cfg, 2, seed=6)]
    counts = count_kernel_calls(monkeypatch)
    tpipe._sample(tpl.FORWARD_RENDER, *inputs, tpipe.blank_context(2), 2,
                  3.0)
    calls = tpl.KernelCalls(tpipe.cfg, tpipe.cfg.vae.sample_size).sample(
        tpl.FORWARD_RENDER, 2, 2, guidance=True)
    assert seen_kernel_calls() == calls.signatures
    assert dict(counts) == calls.launches
    assert {s[0][0] for s in calls.signatures[0]} == {4}
