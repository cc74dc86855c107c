"""Gradients of the port's kernels K1 and K2 (their `torch.autograd.Function`s
with the plain versions on the CPU) against the JAX package, in float32.

  * K2: the plain backward (`attention_backward_reference`) and the
    autograd Function against JAX's `tpu_flash_attention` gradients with
    the Pallas forward and dq/dkv kernels in interpret mode, as
    tests/test_flash_attention.py runs them, at (1, 128, 2, 40):
    max|port - jax| <= 1e-4 * max|jax| (that test's own tolerance between
    the kernel and the reference); and against autograd of
    `attention_reference` at a cross-attention shape (Sk = 77) and at
    D = 160, to 1e-5 * max (the same f32 function, two algorithms);
  * the forward's log-sum-exp against `torch.logsumexp`, to 1e-6 (the
    card holds K2's own against it, on its bf16 inputs);
  * K1: the Function's gradient against `jax.vjp` of the JAX
    `fused_groupnorm_silu` (its custom VJP differentiates the plain
    version, as the port's backward does), to 1e-5 * max;
  * the splash and unet_flash routes raise under autograd and still serve
    without it;
  * `train_step_launches` equals the calls one tiny train step (remat on,
    both branches) makes to the CPU stand-ins of the kernels: K1's
    forward, K2's forward (with or without the log-sum-exp) and K2's
    backward, the recompute of the checkpointed blocks included.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_port_helpers import assert_rel_close
from unirenderer_tpu.ops.flash_attention import tpu_flash_attention
from unirenderer_tpu.ops.groupnorm import (
    fused_groupnorm_silu as jax_groupnorm,
)
from unirenderer_tpu_torch.models.layers import attention
from unirenderer_tpu_torch.ops.flash_attention import (
    attention_backward_reference, attention_lse_reference,
    attention_reference, flash_attention, flash_attention_backward,
)
from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.fixture(scope="module")
def jax_flash_grads():
    """q, k, v, the output gradient and JAX's dq, dk, dv of sum(o * do)
    with the Pallas flash forward and backward kernels interpreted."""
    q, k, v, do = _arrays(11, *[(1, 128, 2, 40)] * 4)

    def loss(q, k, v):
        return jnp.sum(tpu_flash_attention(q, k, v) * do)

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return (q, k, v, do), [np.asarray(g) for g in grads]


def test_plain_backward_matches_jax_flash_kernels(jax_flash_grads):
    (q, k, v, do), want = jax_flash_grads
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = attention_lse_reference(tq, tk, tv)
    got = attention_backward_reference(tq, tk, tv, o, lse, tdo)
    for name, g, w in zip("qkv", got, want):
        assert_rel_close(g, w, 1e-4, f"d{name}")


def test_autograd_function_matches_jax_flash_kernels(jax_flash_grads):
    (q, k, v, do), want = jax_flash_grads
    leaves = _leaves(q, k, v)
    out = flash_attention(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        assert_rel_close(g, w, 1e-4, f"d{name}")


@pytest.mark.parametrize("qs,ks", [
    ((2, 64, 2, 40), (2, 77, 2, 40)),       # cross-attention, masked keys
    ((1, 64, 2, 160), (1, 64, 2, 160)),     # the flagship's D = 160
])
def test_autograd_function_matches_autograd_of_reference(qs, ks):
    q, k, v, do = _arrays(12, qs, ks, ks, qs)
    leaves = _leaves(q, k, v)
    got = torch.autograd.grad(flash_attention(*leaves), leaves,
                              torch.from_numpy(do))
    ref_leaves = _leaves(q, k, v)
    want = torch.autograd.grad(attention_reference(*ref_leaves), ref_leaves,
                               torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        assert_rel_close(g, w.numpy(), 1e-5, f"d{name} at {qs} x {ks}")
    # the wrapper's own entry point gives the same on the CPU
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = attention_lse_reference(tq, tk, tv)
    direct = flash_attention_backward(tq, tk, tv, o, lse,
                                      torch.from_numpy(do))
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


def test_lse_reference():
    q, k, v = _arrays(13, (2, 50, 3, 24), (2, 77, 3, 24), (2, 77, 3, 24))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = attention_lse_reference(tq, tk, tv)
    s = torch.einsum("bshd,bthd->bhst", tq, tk) / np.sqrt(24)
    assert lse.shape == (2, 3, 50) and lse.dtype == torch.float32
    assert_rel_close(lse, torch.logsumexp(s, -1).numpy(), 1e-6, "lse")
    assert_rel_close(o, attention_reference(tq, tk, tv).numpy(), 1e-5, "o")


def test_no_graph_without_grad():
    q, k, v = _leaves(*_arrays(14, *[(1, 16, 2, 8)] * 3))
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
        x = torch.randn(1, 4, 4, 16, requires_grad=True)
        w = torch.ones(16, requires_grad=True)
        assert fused_groupnorm_silu(x, w, w, 4, 1e-5, True).grad_fn is None


@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_groupnorm_gradient_matches_jax_vjp(silu, eps):
    x, scale, bias, dy = _arrays(15, (2, 6, 5, 32), (32,), (32,),
                                 (2, 6, 5, 32))
    scale = 1.0 + 0.1 * scale
    _, pullback = jax.vjp(
        lambda a, s, b: jax_groupnorm(a, s, b, 8, eps, silu),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = pullback(jnp.asarray(dy))
    leaves = _leaves(x, scale, bias)
    out = fused_groupnorm_silu(*leaves, 8, eps, silu)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
        assert_rel_close(g, np.asarray(w), 1e-5, name)


@pytest.mark.parametrize("route", ["splash", "unet_flash"])
def test_routes_without_backward_raise_under_grad(route, monkeypatch):
    monkeypatch.setenv("UNIRENDER_ATTN", route)
    q, k, v = _leaves(*_arrays(16, *[(1, 128, 2, 32)] * 3))
    with pytest.raises(RuntimeError, match="no backward"):
        attention(q, k, v, is_self=True)
    with torch.no_grad():                   # serving keeps the route
        out = attention(q, k, v, is_self=True)
    assert_rel_close(out, attention_reference(q, k, v).detach().numpy(),
                     1e-5, route)


@pytest.mark.parametrize("inverse", [False, True])
def test_train_step_launches_count_one_step(monkeypatch, tmp_path, inverse):
    from unirenderer_tpu_torch.core import config as tcfg
    from unirenderer_tpu_torch.ops import flash_attention as fa
    from unirenderer_tpu_torch.ops import groupnorm as gn
    from unirenderer_tpu_torch.train.train_step import train_step_launches
    from unirenderer_tpu_torch.train.trainer import (
        Trainer, synthetic_batches,
    )
    cfg = tcfg.tiny()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                            remat=True))
    tr = Trainer(cfg, str(tmp_path), device="cpu")
    counts = Counter()

    def counted(module, name, kernel):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            counts[kernel] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counted(gn, "_forward", "groupnorm_silu")
    counted(fa, "attention_reference", "flash_attention")
    counted(fa, "attention_lse_reference", "flash_attention")
    counted(fa, "attention_backward_reference", "flash_attention_backward")
    tr.step(next(synthetic_batches(cfg, 2, device="cpu")), inverse)
    assert dict(counts) == train_step_launches(cfg, 2, inverse)
