"""The f32 attention kernels' three-pass TF32 arithmetic
(csrc/mma_tf32.cuh, used by csrc/flash_attention_f32.cu for K2 / K2s / K3
and csrc/flash_attention_bwd_f32.cu for K2 bwd), modelled in plain torch
on the CPU:

  * `tf32` rounds f32 to TF32 as `cvt.rna.tf32.f32` does (round to
    nearest, ties away from zero: add half the weight of the 13 dropped
    bits to the magnitude, then clear them), and `mm3` takes a product as
    the kernels do: lo_a hi_b + hi_a lo_b + hi_a hi_b with hi = tf32(x)
    and lo = tf32(x - hi), each TF32 x TF32 product exact in f32, the
    sums in f32;
  * the forward (S = Q K^T, the softmax, P V) and the backward (the five
    products the gradients need) through that model, at small()'s shapes
    and a ragged (1, 1000, 2, 40) x 333: within 2^-18 of max|ref| of the
    same function in f64;
  * the same model against the JAX package's `tpu_flash_attention` and
    its `jax.grad`, the Pallas kernels in interpret mode on the
    (1, 128, 2, 40) inputs of tests/test_torch_attention_grad.py, at the
    f32 kernels' gates: 2^-14 of max|jax| forward, 2^-12 backward;
  * one TF32 pass (hi hi alone) misses the forward's 2^-14: why the
    kernels take three.
The model lives here and on no path of the package: on the card the
kernels do this arithmetic (tests/test_torch_card.py holds them to the
plain versions), and on the CPU the wrappers run the plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unirenderer_tpu.ops.flash_attention import tpu_flash_attention

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()

LOG2E = 1.4426950408889634
MODEL_REL = 2.0 ** -18          # the 3-pass model against f64
F32_ATTN = 2.0 ** -14           # the f32 kernels' gates (chip_smoke.py)
F32_BWD = 2.0 ** -12

SHAPES = [
    ((2, 256, 4, 32), (2, 256, 4, 32)),     # small()'s self-attention
    ((2, 256, 4, 32), (2, 16, 4, 32)),      # small()'s cross, x16 keys
    ((1, 1000, 2, 40), (1, 333, 2, 40)),    # ragged Sq and Sk
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (kept in f32), round to nearest, ties away."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 as three TF32 passes: the cross terms, then hi hi."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 pass."""
    return tf32(a) @ tf32(b)


def mm64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _heads(*ts):
    """(B, S, H, D) -> (B, H, S, D)"""
    return [t.transpose(1, 2) for t in ts]


def forward(q, k, v, mm):
    """O (B, S, H, D) and the log-sum-exp (B, H, S) of softmax(Q K^T /
    sqrt(D)) V in q's type, the products by `mm`."""
    qh, kh, vh = _heads(q, k, v)
    sm = 1.0 / math.sqrt(q.shape[-1])
    s = mm(qh, kh.transpose(-1, -2)) * sm
    m = s.amax(-1, keepdim=True)
    p = torch.exp2((s - m) * LOG2E)
    l = p.sum(-1, keepdim=True)
    o = mm(p, vh) / l
    return o.transpose(1, 2), (m + torch.log(l))[..., 0]


def backward(q, k, v, o, lse, do, mm):
    """dQ, dK, dV from the forward's O and log-sum-exp, as the kernels
    take them: Delta = rowsum(dO O), P = exp(S sm - L), dP = dO V^T,
    dS = P (dP - Delta), dV = P^T dO, dQ = dS K sm, dK = dS^T Q sm."""
    qh, kh, vh, oh, doh = _heads(q, k, v, o, do)
    sm = 1.0 / math.sqrt(q.shape[-1])
    delta = (doh * oh).sum(-1, keepdim=True)
    p = torch.exp2((mm(qh, kh.transpose(-1, -2)) * sm - lse[..., None])
                   * LOG2E)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta)
    dv = mm(p.transpose(-1, -2), doh)
    dq = mm(ds, kh) * sm
    dk = mm(ds.transpose(-1, -2), qh) * sm
    return [t.transpose(1, 2) for t in (dq, dk, dv)]


def _inputs(seed, qs, ks):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in (qs, ks, ks, qs)]


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return ((got - want).abs().max() / want.abs().max()).item()


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                        # TF32's step at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 1 + ulp + ulp / 2, 0.0, -3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + 2 * ulp,
                         0.0, -3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi + lo carries ~22 bits of x
    assert ((hi.double() + lo.double() - y.double()).abs()
            <= 2.0 ** -21 * y.double().abs()).all()


@pytest.mark.parametrize("qs,ks", SHAPES)
def test_three_pass_forward_is_f32_accurate(qs, ks):
    q, k, v, _ = _inputs(1, qs, ks)
    o, lse = forward(q, k, v, mm3)
    o64, lse64 = forward(q.double(), k.double(), v.double(), mm64)
    assert _rel(o, o64) <= MODEL_REL, _rel(o, o64)
    assert (lse.double() - lse64).abs().max().item() <= MODEL_REL


@pytest.mark.parametrize("qs,ks", SHAPES)
def test_three_pass_backward_is_f32_accurate(qs, ks):
    q, k, v, do = _inputs(2, qs, ks)
    o, lse = forward(q, k, v, mm3)
    got = backward(q, k, v, o, lse, do, mm3)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = forward(q64, k64, v64, mm64)
    want = backward(q64, k64, v64, o64, lse64, do64, mm64)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= MODEL_REL, (name, _rel(g, w))


@pytest.fixture(scope="module")
def jax_flash():
    """The inputs of tests/test_torch_attention_grad.py's JAX fixture and
    JAX's forward and dq, dk, dv of sum(o * do), the Pallas flash kernels
    interpreted."""
    rng = np.random.default_rng(11)
    q, k, v, do = [rng.standard_normal((1, 128, 2, 40)).astype(np.float32)
                   for _ in range(4)]
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(tpu_flash_attention, q, k, v)
        grads = vjp(jnp.asarray(do))
    return (q, k, v, do), np.array(o), [np.array(g) for g in grads]


def test_three_pass_forward_matches_jax_flash(jax_flash):
    (q, k, v, _), want, _ = jax_flash
    o, _ = forward(*(torch.from_numpy(a) for a in (q, k, v)), mm3)
    assert _rel(o, want) <= F32_ATTN, _rel(o, want)


def test_three_pass_backward_matches_jax_flash_grads(jax_flash):
    (q, k, v, do), _, want = jax_flash
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = forward(tq, tk, tv, mm3)
    got = backward(tq, tk, tv, o, lse, tdo, mm3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= F32_BWD, (name, _rel(g, w))


def test_one_pass_tf32_misses_the_forward_gate():
    qs, ks = SHAPES[0]
    q, k, v, _ = _inputs(1, qs, ks)
    o, _ = forward(q, k, v, mm1)
    o64, _ = forward(q.double(), k.double(), v.double(), mm64)
    assert _rel(o, o64) > F32_ATTN, _rel(o, o64)
