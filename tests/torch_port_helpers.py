"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy parameters for a flax module (from `jax.eval_shape`
of its init, so no flax init runs), flattening to `/`-joined paths, a
JAX tiny() pipeline with seeded weights beside the port loaded with the
same ones, the training step's models, batch and replayed draws, and the
relative-error check every parity test states, and the suite's one
torch thread per process (`use_one_thread`)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

try:
    import jax
except ImportError:     # the card's machine: tests/test_torch_card.py
    jax = None


def use_one_thread() -> None:
    """One torch thread in this process: the suite runs 6 xdist workers on
    an 8-core machine beside JAX's own pools, and torch's default of a
    thread per core oversubscribes it (a tiny step runs many times slower).
    Every tests/test_torch_*.py file calls it on import; the subprocesses
    port tests start get OMP_NUM_THREADS=1 (`ONE_THREAD_ENV`)."""
    torch.set_num_threads(1)


ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


def flax_shapes(module, *args, **kwargs):
    """The module's variables as ShapeDtypeStructs (no init compute)."""
    return jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                          jax.random.key(0))


def random_params(shapes, seed: int):
    """Fill a flax shape tree with seeded values: kernels N(0, 1/fan_in),
    scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), embeddings N(0, 1).
    Zero-convs get random values too, so every path shapes the output."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            z /= np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif name in ("bias", "position_embedding"):
            z *= 0.1
        return z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    """Nested params dict -> {'a/b/leaf': array} (save_params_npz keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = np.asarray(v)
    return out


def to_jax(*arrays):
    return tuple(jax.numpy.asarray(a) for a in arrays)


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def assert_rel_close(got, want, rel: float, what: str = "") -> float:
    """max|got - want| <= rel * max|want|; returns the relative error."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: max rel err {err:.3e} > {rel:.1e}"
    return err


def tiny_pipelines(latent_size: int = 8, attr_channels: int = 0):
    """A JAX tiny() pipeline with seeded random f32 weights (built from
    `jax.eval_shape` of the inits: no flax init runs) and the port on the
    CPU in f32 loaded with the same weights -> (jax pipe, port pipe).
    `attr_channels` (16 or 12: a legacy layout) replaces the 28 of
    tiny()."""
    import dataclasses

    import jax.numpy as jnp

    from unirenderer_tpu.core import config as jcfg
    from unirenderer_tpu.models.clip_text import CLIPTextEncoder, blank_ids
    from unirenderer_tpu.models.dual_stream import DualStreamModel
    from unirenderer_tpu.models.vae import AutoencoderKL
    from unirenderer_tpu.pipelines import UniRendererPipeline as JaxPipeline
    from unirenderer_tpu_torch.core import config as tcfg
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline

    def layout(c):
        if not attr_channels:
            return c
        return dataclasses.replace(c, unet=dataclasses.replace(
            c.unet, attr_channels=attr_channels))

    cfg = layout(jcfg.tiny(latent_size))
    u, s = cfg.unet, cfg.unet.sample_size
    dual = DualStreamModel(u, jnp.float32)
    dual_p = random_params(flax_shapes(
        dual, jnp.zeros((1, s, s, 4)), jnp.zeros((1, s, s, u.attr_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.text.max_length, u.cross_attention_dim))), 1)
    vae = AutoencoderKL(cfg.vae, jnp.float32)
    vs = cfg.vae.sample_size
    vae_p = random_params(flax_shapes(
        vae, jnp.zeros((1, vs, vs, 3)), jax.random.key(0)), 2)
    text = CLIPTextEncoder(cfg.text, jnp.float32)
    text_p = random_params(flax_shapes(text, blank_ids(cfg.text)), 3)
    jpipe = JaxPipeline(cfg, dual, dual_p, vae, vae_p, text, text_p)

    tpipe = UniRendererPipeline.create(
        layout(tcfg.tiny(latent_size)), torch.Generator().manual_seed(0),
        device="cpu", dtype=torch.float32)
    flat = [flatten(p["params"]) for p in (dual_p, vae_p, text_p)]
    assert tpipe.load_flax(*flat) == sum(map(len, flat))
    return jpipe, tpipe


def jax_models(cfg):
    """Flax dual-stream model and VAE at `cfg` in f32 with seeded weights
    (from `jax.eval_shape` of the inits: no flax init runs)."""
    u, s = cfg.unet, cfg.unet.sample_size
    import jax.numpy as jnp

    from unirenderer_tpu.models.dual_stream import DualStreamModel as JaxDual
    from unirenderer_tpu.models.vae import AutoencoderKL as JaxVAE
    dual = JaxDual(u, jnp.float32)
    dual_p = random_params(flax_shapes(
        dual, jnp.zeros((1, s, s, 4)), jnp.zeros((1, s, s, u.attr_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.text.max_length, u.cross_attention_dim))), 1)
    vae = JaxVAE(cfg.vae, jnp.float32)
    vs = cfg.vae.sample_size
    vae_p = random_params(flax_shapes(
        vae, jnp.zeros((1, vs, vs, 3)), jax.random.key(0)), 2)
    return dual, dual_p, vae, vae_p


def port_models(cfg, dual_p, vae_p, remat=False):
    """The port's dual-stream model (f32 masters) and VAE loaded strictly
    with the flax params."""
    import dataclasses

    from unirenderer_tpu_torch.core.convert import load_flax
    from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
    from unirenderer_tpu_torch.models.vae import AutoencoderKL
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                            remat=remat))
    dual, vae = DualStreamModel(cfg.unet), AutoencoderKL(cfg.vae)
    for m, p in ((dual, dual_p), (vae, vae_p)):
        flat = flatten(p["params"])
        assert load_flax(m, flat) == len(flat)
    vae.requires_grad_(False)
    return cfg, dual, vae


def batch_and_ctx(cfg, seed, b=2):
    from unirenderer_tpu_torch.train.train_step import BATCH_KEYS
    rng = np.random.default_rng(seed)
    hw = cfg.vae.sample_size
    batch = {k: rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
             for k in BATCH_KEYS}
    ctx = rng.standard_normal(
        (1, cfg.text.max_length, cfg.unet.cross_attention_dim)
    ).astype(np.float32)
    return batch, ctx


def jax_draws(key, cfg, b):
    """The random numbers JAX's `loss_fn(.., rng=key)` draws, replayed
    from its `split(key, 7)`, as the port's Draws."""
    from unirenderer_tpu.diffusion.schedule import compute_dual_t
    from unirenderer_tpu_torch.train.train_step import BATCH_KEYS, Draws
    h = cfg.vae.sample_size // cfg.vae.downscale
    T = cfg.diffusion.num_train_timesteps
    keys = jax.random.split(key, 7)
    n = len(BATCH_KEYS)
    t_img, t_attr, inv = compute_dual_t(keys[2], T, b)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(dtype)

    return Draws(
        enc_noise=t(jax.random.normal(keys[0], (n * b, h, h, 4))),
        env_noise=t(jax.random.normal(keys[1], (b, h, h, 4))),
        t_img=t(t_img, torch.long), t_attr=t(t_attr, torch.long),
        is_inverse=bool(inv),
        noise_img=t(jax.random.normal(keys[3], (b, h, h, 4))),
        noise_attr=t(jax.random.normal(keys[4], (b, h, h, 24))),
        t_cycle=t(jax.random.randint(keys[5], (b,), 0, T), torch.long),
        noise_cycle=t(jax.random.normal(keys[6], (b, h, h, 4))))


def torch_tree(tree):
    """{key: array} -> {key: tensor}."""
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def count_kernel_calls(monkeypatch):
    """Count the calls of K1's and K2's CPU stand-ins (the plain versions
    the wrappers run on a CPU tensor) from now on, and clear the shapes
    the wrappers have seen -> the Counter, keyed as
    `KernelCalls.launches`."""
    from collections import Counter

    from unirenderer_tpu_torch.ops import flash_attention as fa
    from unirenderer_tpu_torch.ops import groupnorm as gn
    counts = Counter()

    def counted(module, name, kernel):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            counts[kernel] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counted(gn, "_forward", "groupnorm_silu")
    counted(fa, "attention_reference", "flash_attention")
    gn.fused_groupnorm_silu.seen.clear()
    fa.flash_attention.seen.clear()
    return counts


def seen_kernel_calls():
    """(K1 signatures, K2 signatures) the wrappers have seen, as
    `KernelCalls.signatures` gives them."""
    from unirenderer_tpu_torch.ops.flash_attention import flash_attention
    from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
    return set(fused_groupnorm_silu.seen), set(flash_attention.seen)


def sampler_inputs(cfg, b, seed, groups=6):
    """Seeded (image latent, attribute groups, mask latent) for `_sample`."""
    rng = np.random.default_rng(seed)
    s = cfg.unet.sample_size
    img = rng.standard_normal((b, s, s, 4)).astype(np.float32)
    attr = rng.standard_normal((groups, b, s, s, 4)).astype(np.float32)
    mask = rng.standard_normal((b, s, s, 4)).astype(np.float32)
    return img, attr, mask


def blank_or_random_ctx(jpipe, b, negative_seed=None):
    """The blank context the JAX pipeline computes, or a seeded random one
    of its shape (a negative prompt's)."""
    ctx = np.array(jpipe.blank_context(b))
    if negative_seed is None:
        return ctx
    rng = np.random.default_rng(negative_seed)
    return rng.standard_normal(ctx.shape).astype(np.float32)


def sample_both(pipes, mode, inputs, ctx, steps, guidance=0.0,
                neg_ctx=None):
    """The JAX and the port `_sample` of the mode named `mode` on the same
    numpy inputs -> ((jax img, jax groups), (port img, port groups)), as
    numpy."""
    import jax.numpy as jnp

    from unirenderer_tpu import pipelines as jpl
    from unirenderer_tpu_torch import pipelines as tpl
    jpipe, tpipe = pipes
    img, attr, mask = inputs
    want = jpipe._sample(getattr(jpl, mode), *map(jnp.asarray, inputs),
                         jnp.asarray(ctx), steps, guidance,
                         None if neg_ctx is None else jnp.asarray(neg_ctx))
    t = [torch.from_numpy(x) for x in (img, attr, mask, ctx)]
    neg = None if neg_ctx is None else torch.from_numpy(neg_ctx)
    got = tpipe._sample(getattr(tpl, mode), *t, steps, guidance, neg)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def assert_abs_close(got, want, tol: float, what: str = "") -> float:
    """max|got - want| <= tol on a non-trivial `want` (max|want| > 0.05)
    of the same shape; returns the error."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(want).max() > 0.05, what
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|diff| {err:.3g} > {tol:.1e}"
    return err
