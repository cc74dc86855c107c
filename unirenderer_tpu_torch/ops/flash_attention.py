"""K2: non-causal flash attention over (B, S, H, D) tensors, with its
backward.

Counterpart of `unirenderer_tpu/ops/flash_attention.py`
(`tpu_flash_attention`, the library Pallas TPU flash kernel, and under
`jax.grad` its dq/dkv kernels) and of the XLA paths the TPU routed the
other attention shapes to (`models/layers.py` `dmajor_attention`).  On a
CUDA tensor the wrapper launches the hand-written kernel of
`csrc/flash_attention.cu` for every shape the UNet sees (self and cross,
D a multiple of 8 up to 160) and raises on anything it does not take; on a
CPU tensor it runs the plain PyTorch version below.  It serves every
attention call under the default route (`models/layers.py` `attention`);
the splash and unet_flash routes (`ops/splash_attention.py`,
`ops/attn_kernel.py`) take the tileable self-attention shapes when
selected, and only without a gradient.

Under autograd (grad enabled and an input that requires it) the call is a
`torch.autograd.Function`: the forward also writes each row's log-sum-exp,
and the backward is `flash_attention_backward`, the kernel of
`csrc/flash_attention_bwd.cu` on CUDA tensors and the plain
`attention_backward_reference` on CPU ones.  Without a gradient the
forward is the serving launch, which writes no log-sum-exp.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from unirenderer_tpu_torch.ops import _build

MAX_HEAD_DIM = 160


def tileable(sq: int, sk: int, d: int) -> bool:
    """The shapes the TPU's library kernels tile (`flash_attention_available`
    of the JAX package): S and Sk multiples of 128, D up to 128 or a
    multiple of 128.  The splash and unet_flash routes take these only."""
    return sq % 128 == 0 and sk % 128 == 0 and (d <= 128 or d % 128 == 0)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Plain version: softmax(Q K^T / sqrt(D)) V in f32 over (B, S, H, D)
    (the function `dmajor_attention` computes), cast to `out_dtype` (q's
    type by default)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(
        out_dtype or q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor):
    """Plain version of the forward under autograd: (softmax(Q K^T /
    sqrt(D)) V in q's type, the f32 log-sum-exp of each row's scaled
    logits (B, H, Sq))."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)
    return o, lse


def staged_lse_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain log-sum-exp of the kernel's own logits (B, H, Sq), f32: Q
    scaled by softmax_scale * log2(e) in f32 and rounded to bf16 as the
    kernel stages it (csrc/flash_attention.cu's `qscale`), the products in
    f32, back in natural units.  Holds the kernel's log-sum-exp apart from
    the bf16 rounding of Q, which `attention_lse_reference` includes."""
    qscale = (torch.tensor(1.4426950408889634, dtype=torch.float32)
              / torch.tensor(float(q.shape[-1])).sqrt()).item()
    qs = (q.float() * qscale).bfloat16().float()
    s2 = torch.einsum("bshd,bthd->bhst", qs, k.float())
    return torch.logsumexp(s2 * math.log(2.0), dim=-1)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor,
                                 out_dtype: Optional[torch.dtype] = None):
    """Plain backward, the textbook recompute in f32 from the forward's
    output and log-sum-exp (written out, not autograd of
    `attention_reference`, so that the card holds the kernel against the
    same algorithm):

        P = exp(Q K^T / sqrt(D) - L)    dV = P^T dO    dP = dO V^T
        Delta = rowsum(dO * O)          dS = P * (dP - Delta)
        dQ = dS K / sqrt(D)             dK = dS^T Q / sqrt(D)

    -> (dq, dk, dv) in `out_dtype` (q's type by default)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.einsum("bhst,bshd->bthd", p, gf)
    dp = torch.einsum("bshd,bthd->bhst", gf, vf)
    delta = (gf * o.float()).sum(-1).transpose(1, 2)         # (B, H, Sq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    dt = out_dtype or q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attn_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_forward.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.flash_attn_forward.restype = ctypes.c_int
        lib.flash_attn_forward_lse.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               p, p]
        lib.flash_attn_forward_lse.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if lib.flash_attn_backward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_backward.argtypes = [p] * 13 + [i] * 5 + [p, p]
        lib.flash_attn_backward.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"attention kernels take bfloat16, {name} is "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} needs a unit stride on D, other strides "
                         f"a multiple of 8 and 16-byte alignment, got "
                         f"strides {t.stride()}")


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   max_head_dim: int):
    """What every attention kernel of csrc/ takes: bf16 (B, S, H, D)
    operands on one device, D a multiple of 8 up to `max_head_dim`, unit
    stride on D, other strides multiples of 8.  Returns (b, sq, sk, h, d)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d % 8 != 0 or d > max_head_dim or b * h > 65535:
        raise ValueError(f"the kernel takes D a multiple of 8 up to "
                         f"{max_head_dim} and B*H <= 65535, got {q.shape}")
    _check("q", q, (b, sq, h, d))
    _check("k", k, (b, sk, h, d))
    _check("v", v, (b, sk, h, d))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    return b, sq, sk, h, d


def prescale_factor(dtype: torch.dtype, factor: float) -> float:
    """`factor` rounded to `dtype`, as a host number."""
    return torch.tensor(factor, dtype=dtype).item()


def prescale_q(q: torch.Tensor, factor: float) -> torch.Tensor:
    """q * factor with the factor rounded to q's type, the product rounded
    to q's type (JAX's `q * factor` with a weakly typed or q-typed factor),
    as the splash and unet_flash routes pre-scale Q.  The rounded factor
    is a host number: no copy to the device."""
    return q * prescale_factor(q.dtype, factor)


def packed_strides(*tensors: torch.Tensor):
    """The (batch, seq, head) element strides of each tensor, in order, as
    the C array the kernels read."""
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(t.stride(i) for t in tensors for i in range(3)))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            with_lse: bool = False):
    """The forward kernel -> o, or (o, lse) with `with_lse`."""
    b, sq, sk, h, d = check_operands(q, k, v, MAX_HEAD_DIM)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = packed_strides(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if with_lse:
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        rc = _lib().flash_attn_forward_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, ctypes.addressof(strides),
            stream)
    else:
        rc = _lib().flash_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, sq, sk, d, ctypes.addressof(strides), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor):
    """The forward under autograd -> (o, lse (B, H, Sq) f32): the kernel
    on CUDA tensors, the plain version on CPU ones."""
    flash_attention.seen.add((tuple(q.shape), tuple(k.shape)))
    if q.device.type == "cpu":
        return attention_lse_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v, with_lse=True)


def _launch_backward(q, k, v, o, lse, do):
    b, sq, sk, h, d = check_operands(q, k, v, MAX_HEAD_DIM)
    _check("o", o, (b, sq, h, d))
    _check("do", do, (b, sq, h, d))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 ({b}, {h}, {sq}), "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if not (q.device == o.device == do.device == lse.device):
        raise ValueError("the backward's operands must be on one device")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    # workspaces: Delta, Q staged as the forward staged it, and the f32
    # sums of dQ (and of dK, dV when the kernel splits the query tiles)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, sq), **f32)
    qs = torch.empty((b * h, sq, d), dtype=q.dtype, device=q.device)
    dq_acc = torch.empty((b * h, sq, d), **f32)
    dkv_acc = torch.empty((2, b * h, sk, d), **f32)
    strides = packed_strides(q, k, v, o, do, dq, dk, dv)
    rc = _bwd_lib().flash_attn_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), qs.data_ptr(), dq_acc.data_ptr(),
        dkv_acc.data_ptr(), b, h, sq, sk, d, ctypes.addressof(strides),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {rc}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor):
    """(dq, dk, dv) of attention from its inputs, output o, log-sum-exp
    (B, H, Sq) f32 and output gradient do: the kernel on CUDA tensors, the
    plain version on CPU ones."""
    flash_attention_backward.seen.add((tuple(q.shape), tuple(k.shape)))
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch_backward(q, k, v, o, lse, do)


class _FlashAttention(torch.autograd.Function):
    """K2 under autograd: the forward saves q, k, v, o and the
    log-sum-exp; the backward is `flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_with_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, o, lse, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention over q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D):
    the kernel on CUDA tensors, the plain version on CPU ones;
    differentiable (through `flash_attention_backward`) when grad is
    enabled and an input requires it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    flash_attention.seen.add((tuple(q.shape), tuple(k.shape)))
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v)


# forward kernel launches so far (the CUDA branch only, with or without the
# log-sum-exp), and every (q shape, k shape) the wrapper has been called with
flash_attention.launches = 0
flash_attention.seen = set()
# backward kernel launches (one per call: the kernels of
# csrc/flash_attention_bwd.cu) and the (q shape, k shape) of every call
flash_attention_backward.launches = 0
flash_attention_backward.seen = set()
