"""K1 (GroupNorm+SiLU), K2 (flash) and K3 (unet_flash) as the redesigned
kernels read their inputs, on the CPU: K1's plain version with the model's
bf16 parameters against the JAX package's reference, the plain mirror of
K1's statistics (its row ranges and merge order) against two-pass
statistics where the one-pass form fails, the Q that K3 stages against the
JAX route's pre-scale, and K2's score arithmetic (f32 scores of the bf16
inputs, scaled in f32) against the JAX library kernel, where the staging
of bf16(q * scale * log2 e) it replaced fails.  The kernels themselves run
on the card (tests/test_torch_card.py).

Tolerances: K1 against JAX 1e-5 * max|ref| in f32 (the same formula, f32
reductions in another order); the chunked statistics within 1e-6 of the
mean's size and 1e-5 relative of the variance, computed in f64 (the mirror
sums in f32); Q's staging bit for bit; K2's scores 2^-14 * max|ref| (see
the test).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_port_helpers import assert_rel_close
from unirenderer_tpu.ops.flash_attention import tpu_flash_attention
from unirenderer_tpu.ops.groupnorm import (
    groupnorm_silu_reference as jax_groupnorm,
)
from unirenderer_tpu_torch.ops import attn_kernel as k3
from unirenderer_tpu_torch.ops.groupnorm import (
    chunked_stats_reference, groupnorm_silu_reference, merge_span,
)

# C/G = 10 (the UNet's 320-channel levels) and C/G = 4 (the VAE's 128)
GN_CASES = [((2, 8, 8, 320), 32, 1e-5, True),
            ((2, 8, 8, 128), 32, 1e-6, False)]

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bi = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(sc).bfloat16(),
            torch.from_numpy(bi).bfloat16())


@pytest.mark.parametrize("shape,groups,eps,silu", GN_CASES)
def test_plain_k1_with_bf16_params_matches_jax(shape, groups, eps, silu):
    x, sc, bi = _gn_inputs(shape, 0)
    got = groupnorm_silu_reference(x, sc, bi, groups, eps, silu)
    want = jax_groupnorm(jnp.asarray(x.numpy()),
                         jnp.asarray(sc.float().numpy(), jnp.bfloat16),
                         jnp.asarray(bi.float().numpy(), jnp.bfloat16),
                         groups, eps, silu)
    assert got.dtype == torch.float32
    assert_rel_close(got.numpy(), np.asarray(want, np.float32), 1e-5,
                     "plain K1, bf16 parameters")


@pytest.mark.parametrize("shape,groups,eps,silu", GN_CASES)
def test_plain_k1_reads_bf16_params_as_their_f32_upcast(shape, groups, eps,
                                                         silu):
    x, sc, bi = _gn_inputs(shape, 1)
    got = groupnorm_silu_reference(x, sc, bi, groups, eps, silu)
    want = groupnorm_silu_reference(x, sc.float(), bi.float(), groups, eps,
                                    silu)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def offset_activations():
    """100 + N(0, 1) over 2^20 elements a group: (1, 512, 512, 128), G 32."""
    rng = np.random.default_rng(2)
    x = 100.0 + rng.standard_normal((1, 512, 512, 128), dtype=np.float32)
    xd = torch.from_numpy(x).double().reshape(1, -1, 32, 4)
    mean = xd.mean(dim=(1, 3))
    var = ((xd - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    return torch.from_numpy(x), mean, var


@pytest.mark.parametrize("n_chunks", [1, 7, 132])
def test_chunked_stats_hold_where_one_pass_fails(offset_activations,
                                                 n_chunks):
    x, mean, var = offset_activations
    span = merge_span(512 * 512, 128, 32)
    assert span == 16
    got_mean, got_var = chunked_stats_reference(x, 32, n_chunks, span)
    assert (got_mean.double() - mean).abs().max().item() <= 1e-6 * 100
    assert ((got_var.double() - var) / var).abs().max().item() <= 1e-5
    # E[x^2] - mean^2 in f32 loses the variance at this offset
    xf = x.reshape(1, -1, 32, 4)
    one_pass = (xf * xf).mean(dim=(1, 3)) - xf.mean(dim=(1, 3)) ** 2
    assert ((one_pass.double() - var) / var).abs().max().item() > 1e-2


@pytest.mark.parametrize("d", [24, 40, 80, 128])
def test_k3_staged_q_is_the_jax_prescale(d):
    """K3 stages Q as bf16(q * bf16(1/sqrt(D) * log2 e)), the product
    rounded from f32: the bits of JAX's `q * jnp.asarray(factor, q.dtype)`
    on bf16 Q (unirenderer_tpu/ops/attn_kernel.py:132)."""
    rng = np.random.default_rng(d)
    q = (rng.standard_normal((2, 64, 3, d)) * 4).astype(np.float32)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    want = np.asarray((qj * jnp.asarray(1.0 / math.sqrt(d) * math.log2(
        math.e), jnp.bfloat16)).astype(jnp.float32))
    qt = torch.from_numpy(q).bfloat16()
    staged = (qt.float() * k3.qscale(d)).bfloat16()
    np.testing.assert_array_equal(staged.float().numpy(), want)
    # the plain version's pre-scale is the same
    assert torch.equal(k3.prescale_q(qt, k3._factor(d)), staged)


def _k2_mirror(q, k, v, staged_q):
    """Plain mirror of K2's softmax(Q K^T / sqrt(D)) V over (B, S, H, D)
    bf16 inputs in log2 units, the rest in f32: with `staged_q`, the
    arithmetic before the repair (Q staged as bf16(q * log2(e)/sqrt(D)),
    the product rounded from f32, then f32 products); without it, the
    kernel's now (f32 products of the bf16 Q, times the f32 factor
    log2(e)/sqrt(D), csrc/mma_bf16.cuh `score_scale`)."""
    factor = torch.tensor(math.log2(math.e) / math.sqrt(q.shape[-1]),
                          dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    if staged_q:
        s2 = torch.einsum("bshd,bthd->bhst", (qf * factor).bfloat16().float(),
                          kf)
    else:
        s2 = torch.einsum("bshd,bthd->bhst", qf, kf) * factor
    p = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    return torch.einsum("bhst,bthd->bshd", p / p.sum(-1, keepdim=True), vf)


def test_k2_scales_f32_scores_as_the_jax_library_kernel():
    """JAX's `tpu_flash_attention` (the library Pallas kernel, interpreted,
    at tests/test_torch_attention_grad.py's (1, 128, 2, 40), seed 11)
    multiplies the f32 scores of its inputs by sm_scale.  On bf16 values
    (given to it as f32, so its output is not rounded) the repaired score
    arithmetic reads 5.9e-7 * max|jax| and the old staging of the scaled Q
    in bf16 2.1e-3 * max|jax| (seeds 12-14: <= 4.1e-7 against 2.1e-3 to
    4.7e-3).  The tolerance 2^-14 = 6.1e-5 lies between them."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 40)).astype(
        np.float32)).bfloat16() for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tpu_flash_attention(
            *(jnp.asarray(x.float().numpy()) for x in (q, k, v))))
    tol = 2.0 ** -14 * np.abs(want).max()
    new = np.abs(_k2_mirror(q, k, v, staged_q=False).numpy() - want).max()
    old = np.abs(_k2_mirror(q, k, v, staged_q=True).numpy() - want).max()
    assert new <= tol < old, (new, old, tol)
