"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy parameters for a flax module (from `jax.eval_shape`
of its init, so no flax init runs), flattening to `/`-joined paths, a
JAX tiny() pipeline with seeded weights beside the port loaded with the
same ones, the training step's models, batch and replayed draws, and the
relative-error check every parity test states."""

from __future__ import annotations

from typing import Dict

import jax
import numpy as np
import torch


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


def tiny_pipelines(latent_size: int = 8):
    """A JAX tiny() pipeline with seeded random f32 weights (built from
    `jax.eval_shape` of the inits: no flax init runs) and the port on the
    CPU in f32 loaded with the same weights -> (jax pipe, port pipe)."""
    import jax.numpy as jnp

    from unirenderer_tpu.core import config as jcfg
    from unirenderer_tpu.models.clip_text import CLIPTextEncoder, blank_ids
    from unirenderer_tpu.models.dual_stream import DualStreamModel
    from unirenderer_tpu.models.vae import AutoencoderKL
    from unirenderer_tpu.pipelines import UniRendererPipeline as JaxPipeline
    from unirenderer_tpu_torch.core import config as tcfg
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline

    cfg = jcfg.tiny(latent_size)
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
        tcfg.tiny(latent_size), torch.Generator().manual_seed(0),
        device="cpu", dtype=torch.float32)
    tpipe.load_flax(dual=flatten(dual_p["params"]),
                    vae=flatten(vae_p["params"]),
                    text=flatten(text_p["params"]))
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
