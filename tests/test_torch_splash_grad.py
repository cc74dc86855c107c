"""The splash route has no backward, in the JAX package and in the port.

The JAX package's `tpu_splash_attention` builds its library kernel with
forward block sizes only (`_splash_kernel`: `BlockSizes(block_q=...,
block_kv=...)`), so `jax.grad` through it raises in the library's
backward rule before any kernel runs; a TPU raises the same way.  The
port's `UNIRENDER_ATTN=splash` route refuses a gradient as well
(`models/layers.NO_BACKWARD`), and without one serves the JAX forward:
f32, 2e-5 (both evaluate the same softmax in f32; summation order only,
as tests/test_torch_attention_routes.py holds K2s).  The splash kernel
folds the route's pre-scale of Q into its staging; the bits it stages are
`prescale_q`'s, which are JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirenderer_tpu.ops.flash_attention import tpu_splash_attention
from unirenderer_tpu_torch.models.layers import attention
from unirenderer_tpu_torch.ops.flash_attention import (
    prescale_factor, prescale_q,
)

SHAPE = (1, 256, 2, 40)


def _qkv():
    rng = np.random.default_rng(8)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3)]


def _jax_splash(q, k, v):
    return tpu_splash_attention(q, k, v, block_q=128, block_kv=128,
                                interpret=True)


def test_jax_splash_has_no_backward():
    q, k, v = (jnp.asarray(x) for x in _qkv())
    with pytest.raises(ValueError, match="backward blocks"):
        jax.grad(lambda a: _jax_splash(a, k, v).sum())(q)


def test_port_splash_refuses_grad_and_serves_the_jax_forward(monkeypatch):
    monkeypatch.setenv("UNIRENDER_ATTN", "splash")
    arrays = _qkv()
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in arrays)
    with pytest.raises(RuntimeError, match="no backward"):
        attention(q, k, v, is_self=True)
    with torch.no_grad():
        got = attention(q, k, v, is_self=True)
    want = _jax_splash(*(jnp.asarray(x) for x in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_splash_prescale_matches_jax_bits():
    """The splash kernel stages Q as bf16(q * bf16(1/sqrt(D))), the bits of
    `prescale_q`; JAX's `q * scale` on bf16 Q gives the same bits."""
    rng = np.random.default_rng(9)
    for d in (40, 80, 24):
        q = rng.standard_normal((2, 64, 3, d)).astype(np.float32) * 4
        qj = jnp.asarray(q).astype(jnp.bfloat16)
        want = np.asarray((qj * (1.0 / math.sqrt(d))).astype(jnp.float32))
        qt = torch.from_numpy(q).bfloat16()
        got = prescale_q(qt, 1.0 / math.sqrt(d))
        np.testing.assert_array_equal(got.float().numpy(), want)
        factor = prescale_factor(torch.bfloat16, 1.0 / math.sqrt(d))
        by_hand = (qt.float() * factor).bfloat16()
        assert torch.equal(by_hand, got)
