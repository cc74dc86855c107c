"""The attention routes of the PyTorch port: the plain versions of K2s
(`ops/splash_attention.py`) and K3 (`ops/attn_kernel.py`) against the JAX
package's kernels in interpret mode on the CPU, and the `UNIRENDER_ATTN`
router of `models/layers.py`.

Tolerances.  K2s: the port's plain version against
`tpu_splash_attention(..., interpret=True)` at the shape of
tests/test_flash_attention.py's splash test, f32: 2e-5 (both evaluate the
same softmax in f32; summation order only).  K3: the shapes and
tolerances of tests/test_attn_kernel.py (2e-5 in f32, 2e-2 in bf16, where
the JAX kernel rounds P to bf16 before P V and the plain version keeps it
in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirenderer_tpu.ops.attn_kernel import unet_flash_attention as jax_k3
from unirenderer_tpu.ops.flash_attention import tpu_splash_attention
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.models import layers
from unirenderer_tpu_torch.ops import attn_kernel as k3
from unirenderer_tpu_torch.ops import flash_attention as k2
from unirenderer_tpu_torch.ops import splash_attention as k2s
from unirenderer_tpu_torch.pipelines import (
    UniRendererPipeline, forward_self_attention_calls, kernel_cases,
)

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _qkv(seed, q_shape, k_shape=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k_shape = k_shape or q_shape
    return tuple(rng.standard_normal(s).astype(np.float32).astype(dtype)
                 for s in (q_shape, k_shape, k_shape))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_splash_plain_matches_jax_splash():
    q, k, v = _qkv(0, (1, 256, 2, 40))
    want = tpu_splash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=128, block_kv=128,
                                interpret=True)
    got = k2s.splash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    _close(got, want, 2e-5)


def test_splash_refuses_untileable_shapes():
    q = torch.zeros((1, 77, 2, 40))
    with pytest.raises(ValueError):
        k2s.splash_attention(q, q, q)
    q = torch.zeros((1, 256, 2, 160))
    with pytest.raises(ValueError):
        k2s.splash_attention(q, q, q)


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("running_max", [True, False])
def test_unet_flash_plain_matches_jax(pipelined, running_max):
    q, k, v = _qkv(1, (2, 256, 2, 40))
    want = jax_k3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=128, block_k=128, pipelined=pipelined,
                  running_max=running_max, interpret=True)
    got = k3.unet_flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), block_q=128,
        block_k=128, pipelined=pipelined, running_max=running_max)
    _close(got, want, 2e-5)


def test_unet_flash_plain_rectangular_blocks():
    q, _, _ = _qkv(2, (1, 128, 2, 40))
    _, k, v = _qkv(3, (1, 512, 2, 40))
    want = jax_k3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=128, block_k=256, interpret=True)
    got = k3.unet_flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), block_q=128,
        block_k=256)
    _close(got, want, 2e-5)


def test_unet_flash_plain_bf16():
    q, k, v = (jnp.asarray(x, jnp.bfloat16)
               for x in _qkv(4, (1, 256, 2, 80)))
    want = jax_k3(q, k, v, block_q=128, block_k=128, interpret=True)
    got = k3.unet_flash_attention(
        *(torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
          for x in (q, k, v)), block_q=128, block_k=128)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 2e-2)


def test_unet_flash_rejects_nondivisible_blocks():
    q = torch.zeros((1, 200, 2, 40))
    with pytest.raises(ValueError, match="not divisible"):
        k3.unet_flash_attention(q, q, q, block_q=128, block_k=128)
    # the default blocks are capped at S: any S up to 512 divides them
    assert k3.unet_flash_attention(q, q, q).shape == q.shape


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

B = 2
SELF = [(B, 4096, 8, 40), (B, 1024, 8, 80), (B, 256, 8, 160),
        (B, 64, 8, 160)]                    # the flagship's levels
TILEABLE = SELF[:2]
WRAPPERS = {"flash": k2.flash_attention, "splash": k2s.splash_attention,
            "unet_flash": k3.unet_flash_attention}


@pytest.fixture
def no_compute(monkeypatch):
    """The wrappers run (and record `.seen`), their plain versions are
    stubbed: the flagship shapes would take seconds each on the CPU."""
    monkeypatch.setattr(k2, "attention_reference", lambda q, k, v: q)
    monkeypatch.setattr(k2s, "splash_attention_reference",
                        lambda q, k, v: q)
    monkeypatch.setattr(k3, "unet_flash_reference",
                        lambda q, k, v, running_max=True: q)
    for w in WRAPPERS.values():
        w.seen.clear()


@pytest.mark.parametrize("value", [None, "auto", "flash", "splash",
                                   "unet_flash"])
def test_router_sends_each_flagship_shape_where_the_table_says(
        monkeypatch, no_compute, value):
    if value is None:
        monkeypatch.delenv("UNIRENDER_ATTN", raising=False)
    else:
        monkeypatch.setenv("UNIRENDER_ATTN", value)
    calls = []
    for s in SELF:
        q = torch.empty(s)
        calls.append(((s, s), layers.attention(q, q, q, is_self=True)))
        kv = torch.empty((B, 77) + s[2:])               # cross-attention
        calls.append(((s, kv.shape), layers.attention(q, kv, kv,
                                                      is_self=False)))
    route = value if value in ("splash", "unet_flash") else None
    want = {name: set() for name in WRAPPERS}
    for (qs, ks), _ in calls:
        to = route if (route and qs == ks and qs in TILEABLE) else "flash"
        want[to].add((tuple(qs), tuple(ks)))
    assert {n: w.seen for n, w in WRAPPERS.items()} == want
    if route:
        assert want[route] == {(s, s) for s in TILEABLE}


def test_router_refuses_unknown_values(monkeypatch):
    q = torch.zeros((1, 128, 2, 16))
    for value in ("xla_dpa", "dmajor", "Splash", ""):
        monkeypatch.setenv("UNIRENDER_ATTN", value)
        with pytest.raises(ValueError, match="auto, flash, splash, "
                                             "unet_flash"):
            layers.attention(q, q, q, is_self=True)


@pytest.mark.parametrize("value", ["splash", "unet_flash"])
def test_route_takes_every_tileable_self_attention_of_a_request(
        monkeypatch, value):
    """A forward request at tiny(16) (its 256-token level tiles) under the
    route: the route's wrapper is called exactly as often as
    `forward_self_attention_calls` works out from the config (chip_smoke's
    assertion on the card), with the shapes `kernel_cases` lists as
    tileable self-attention; K2 takes the rest; the image is the default
    route's to f32 rounding."""
    cfg = tcfg.tiny(16)
    pipe = UniRendererPipeline.create(cfg, torch.Generator().manual_seed(0),
                                      device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    res = cfg.vae.sample_size
    req = {k: rng.uniform(-1, 1, (B, res, res, 3)).astype(np.float32)
           for k in ("normal", "albedo", "spec_light", "diff_light", "env",
                     "mask")}
    req.update(metallic=[0.2, 0.7], roughness=[0.5, 0.1], num_steps=1)

    def run():
        return pipe.mask2image_3mod_albedo(
            **req, generator=torch.Generator().manual_seed(0))

    monkeypatch.delenv("UNIRENDER_ATTN", raising=False)
    default = run()
    wrapper = WRAPPERS[value]
    name = {"splash": "splash_attention",
            "unet_flash": "unet_flash_attention"}[value]
    count = [0]

    def counted(*a, **kw):
        count[0] += 1
        return wrapper(*a, **kw)

    monkeypatch.setattr(layers, name, counted)
    monkeypatch.setenv("UNIRENDER_ATTN", value)
    for w in WRAPPERS.values():
        w.seen.clear()
    out = run()
    assert count[0] == forward_self_attention_calls(cfg, B, res, 1) > 0
    _, attn = kernel_cases(cfg, B, res)
    routed = {(q, k) for q, k in attn
              if q == k and k2.tileable(q[1], k[1], q[3])}
    assert wrapper.seen == routed
    assert k2.flash_attention.seen == attn - routed
    np.testing.assert_allclose(out.numpy(), default.numpy(), atol=1e-4)
