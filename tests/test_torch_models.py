"""Module parity of the PyTorch port against the JAX package, at `tiny()`
widths in float32 on the CPU.

Each case builds a flax module and its port, fills both with the same
seeded parameters (flax shapes from `jax.eval_shape`, converted through
`core/convert.py`), feeds both the same numpy inputs and compares.

Tolerance: max|port - jax| <= 1e-4 * max|jax| per module.  Both sides
compute in f32; what is left is summation order (convolutions, matmuls,
GroupNorm statistics), a few ulp per layer, far below 1e-4 even through
the whole dual-stream model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_rel_close, flatten, flax_shapes, random_params, to_jax, to_torch,
)
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.models import blocks as jblocks
from unirenderer_tpu.models import clip_text as jclip
from unirenderer_tpu.models import dual_stream as jdual
from unirenderer_tpu.models import layers as jlayers
from unirenderer_tpu.models import vae as jvae
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.convert import load_flax
from unirenderer_tpu_torch.models import blocks as tblocks
from unirenderer_tpu_torch.models import clip_text as tclip
from unirenderer_tpu_torch.models import dual_stream as tdual
from unirenderer_tpu_torch.models import layers as tlayers
from unirenderer_tpu_torch.models import vae as tvae

REL = 1e-4
F32 = jnp.float32
JT, TT = jcfg.tiny(), tcfg.tiny()

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _inputs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.standard_normal(s)).astype(np.float32)
                 for s in shapes)


def _pair(jmod, tmod, jargs, seed=0, method=None):
    """Random params for `jmod` given its call args; the same params loaded
    into `tmod`.  Returns (jax apply fn, torch module)."""
    kw = {"method": method} if method else {}
    shapes = flax_shapes(jmod, *jargs, **kw)
    params = random_params(shapes, seed)
    load_flax(tmod, flatten(params["params"]))
    tmod.eval()
    return (lambda *a, **k: jmod.apply(params, *a, **k)), tmod


def _compare(got, want, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g, np.asarray(w), REL, f"{what}[{i}]")


def test_timestep_embedding():
    t = np.array([0, 17, 500, 999], np.int32)
    for dim in (32, 33, 320):
        want = jlayers.timestep_embedding(jnp.asarray(t), dim)
        got = tlayers.timestep_embedding(torch.from_numpy(t), dim)
        _compare(got, want, f"timestep_embedding dim={dim}")


def _resnet_temb():
    x, temb = _inputs(1, (2, 8, 8, 32), (2, 128))
    j, t = _pair(jlayers.ResnetBlock(64, 8, dtype=F32),
                 tlayers.ResnetBlock(32, 64, 8, temb_dim=128), to_jax(x, temb))
    return j(*to_jax(x, temb)), t(*to_torch(x, temb))


def _resnet_vae():
    # activations of variance 1e-4, so that the GroupNorm eps (1e-5 here)
    # moves the output well above the tolerance
    (x,) = _inputs(2, (2, 8, 8, 16), scale=1e-2)
    j, t = _pair(jlayers.ResnetBlock(16, 8, dtype=F32),
                 tlayers.ResnetBlock(16, 16, 8), to_jax(x))
    return j(*to_jax(x)), t(*to_torch(x))


def _transformer2d():
    # small activations: the pre-norm's eps (1e-6) must show
    (x,) = _inputs(3, (2, 4, 4, 32), scale=1e-3)
    (ctx,) = _inputs(13, (2, 16, 24))
    j, t = _pair(jlayers.Transformer2D(2, 1, 8, F32),
                 tlayers.Transformer2D(32, 2, 24, 1, 8), to_jax(x, ctx))
    return j(*to_jax(x, ctx)), t(*to_torch(x, ctx))


def _self_attention2d():
    (x,) = _inputs(4, (2, 4, 4, 32))
    j, t = _pair(jlayers.SelfAttention2D(8, F32),
                 tlayers.SelfAttention2D(32, 8), to_jax(x))
    return j(*to_jax(x)), t(*to_torch(x))


def _downsample():
    (x,) = _inputs(5, (2, 8, 8, 16))
    j, t = _pair(jlayers.Downsample(16, F32), tlayers.Downsample(16), to_jax(x))
    return j(*to_jax(x)), t(*to_torch(x))


def _upsample():
    (x,) = _inputs(6, (2, 4, 4, 16))
    j, t = _pair(jlayers.Upsample(16, F32), tlayers.Upsample(16), to_jax(x))
    return j(*to_jax(x)), t(*to_torch(x))


def _geglu():
    (x,) = _inputs(7, (2, 10, 16))
    j, t = _pair(jlayers.FeedForwardGEGLU(F32), tlayers.FeedForwardGEGLU(16),
                 to_jax(x))
    return j(*to_jax(x)), t(*to_torch(x))


def _down_block():
    x, temb, ctx = _inputs(8, (2, 8, 8, 16), (2, 128), (2, 16, 32))
    args = to_jax(x, temb, ctx)
    j, t = _pair(
        jblocks.DownBlock(32, 2, True, 2, 1, 8, True, dtype=F32),
        tblocks.DownBlock(16, 32, 2, True, 2, 32, 1, 8, True, 128), args)
    jx, jtaps = j(*args)
    tx, ttaps = t(*to_torch(x, temb, ctx))
    return (jx,) + jtaps, (tx,) + ttaps


def _mid_block():
    x, temb, ctx = _inputs(9, (2, 4, 4, 32), (2, 128), (2, 16, 32))
    args = to_jax(x, temb, ctx)
    j, t = _pair(jblocks.MidBlock(32, 2, 1, 8, dtype=F32),
                 tblocks.MidBlock(32, 2, 32, 1, 8, 128), args)
    return j(*args), t(*to_torch(x, temb, ctx))


def _up_block():
    x, s0, s1, s2, temb, ctx = _inputs(
        10, (2, 4, 4, 32), (2, 4, 4, 16), (2, 4, 4, 32), (2, 4, 4, 32),
        (2, 128), (2, 16, 32))
    jargs = (jnp.asarray(x), to_jax(s0, s1, s2)) + to_jax(temb, ctx)
    j, t = _pair(
        jblocks.UpBlock(32, 3, True, 2, 1, 8, True, dtype=F32),
        tblocks.UpBlock(32, 32, (32, 32, 16), True, 2, 32, 1, 8, True, 128),
        jargs)
    jx, _ = j(*jargs)
    tx = t(torch.from_numpy(x), to_torch(s0, s1, s2), *to_torch(temb, ctx))
    return jx, tx


def _clip():
    ids = np.array(jclip.blank_ids(JT.text))
    j, t = _pair(jclip.CLIPTextEncoder(JT.text, F32),
                 tclip.CLIPTextEncoder(TT.text), (jnp.asarray(ids),))
    assert np.array_equal(tclip.blank_ids(TT.text).numpy(), ids)
    return j(jnp.asarray(ids)), t(torch.from_numpy(ids).long())


def _vae(seed=11):
    s = JT.vae.sample_size
    # small inputs, so that every GroupNorm eps of the VAE shows
    x, z = _inputs(seed, (2, s, s, 3), (2, s // 2, s // 2, 4), scale=1e-2)
    jm = jvae.AutoencoderKL(JT.vae, F32)
    shapes = flax_shapes(jm, jnp.asarray(x), jax.random.key(0))
    params = random_params(shapes, seed)
    tm = tvae.AutoencoderKL(TT.vae)
    load_flax(tm, flatten(params["params"]))
    jmean, jlogvar = jm.apply(params, jnp.asarray(x), method="encode")
    jdec = jm.apply(params, jnp.asarray(z), method="decode")
    tmean, tlogvar = tm.encode(torch.from_numpy(x))
    tdec = tm.decode(torch.from_numpy(z))
    return (jmean, jlogvar, jdec), (tmean, tlogvar, tdec)


def _dual_stream(seed=12):
    u = JT.unet
    s, b = u.sample_size, 2
    img, attr, ctx = _inputs(seed, (b, s, s, 4), (b, s, s, u.attr_channels),
                             (b, JT.text.max_length, u.cross_attention_dim))
    t_img = np.array([999, 321], np.int32)
    t_attr = np.zeros(b, np.int32)
    jm = jdual.DualStreamModel(u, F32)
    shapes = flax_shapes(jm, *to_jax(img, attr), jnp.asarray(t_img),
                         jnp.asarray(t_attr), jnp.asarray(ctx))
    params = random_params(shapes, seed)
    tm = tdual.DualStreamModel(TT.unet)
    flat = flatten(params["params"])
    assert any(k.startswith("controldec/") for k in flat)
    # strict: every key is loaded, the attribute decoder's included
    assert load_flax(tm, flat) == len(flat)
    jdown, jmid = jm.apply(params, jnp.asarray(attr), jnp.asarray(t_attr),
                           jnp.asarray(ctx), method="encode_attr")
    jpred = jm.apply(params, jnp.asarray(img), jnp.asarray(t_img),
                     jnp.asarray(ctx), jdown, jmid,
                     method="image_stream_with_residuals")
    with torch.no_grad():
        tdown, tmid = tm.encode_attr(torch.from_numpy(attr),
                                     torch.from_numpy(t_attr).long(),
                                     torch.from_numpy(ctx))
        tpred = tm.image_stream_with_residuals(
            torch.from_numpy(img), torch.from_numpy(t_img).long(),
            torch.from_numpy(ctx), tdown, tmid)
    return (jpred, jmid) + tuple(jdown), (tpred, tmid) + tuple(tdown)


CASES = {
    "resnet_temb": _resnet_temb, "resnet_vae": _resnet_vae,
    "transformer2d": _transformer2d, "self_attention2d": _self_attention2d,
    "downsample": _downsample, "upsample": _upsample, "geglu": _geglu,
    "down_block": _down_block, "mid_block": _mid_block,
    "up_block": _up_block, "clip_text": _clip, "vae": _vae,
    "dual_stream": _dual_stream,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_parity(name):
    with torch.no_grad():
        want, got = CASES[name]()
    _compare(got, want, name)
