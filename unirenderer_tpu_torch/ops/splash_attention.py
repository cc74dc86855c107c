"""K2s: the splash-attention route, non-causal attention forward over
(B, S, H, D) tensors.

Counterpart of `unirenderer_tpu/ops/flash_attention.py`
`tpu_splash_attention` (the library Pallas TPU splash kernel, a `FullMask`
per head, a grid over heads with `vmap` over the batch), which the TPU ran
under `UNIRENDER_ATTN=splash` for the tileable self-attention shapes.  As
there, Q is pre-scaled by 1/sqrt(D) and rounded to Q's type, and nothing
else scales it.  On a CUDA tensor the wrapper launches the hand-written
kernel of `csrc/splash_attention.cu` (bf16, a head-major grid), which
takes the factor rounded to bf16 and applies it to Q while it stages Q
(the same bits as `prescale_q`), and raises on anything it does not take,
non-tileable shapes included; on a CPU tensor it runs the plain version
below.  f32 operands go to the splash entry point of the f32 attention
kernel (`csrc/flash_attention_f32.cu`), which stages Q as f32(q *
f32(1/sqrt(D))), the same bits as `prescale_q` in f32, and takes the
scores unscaled.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from unirenderer_tpu_torch.ops import _build
from unirenderer_tpu_torch.ops.flash_attention import (
    check_operands, count_launch, f32_lib, packed_strides, prescale_factor,
    prescale_q, tileable,
)

MAX_HEAD_DIM = 128


def splash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               out_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """Plain version: softmax(Q' K^T) V in f32 over (B, S, H, D), where Q'
    is q pre-scaled by 1/sqrt(D) in q's type; cast to `out_dtype` (q's
    type by default)."""
    qs = prescale_q(q, 1.0 / math.sqrt(q.shape[-1]))
    s = torch.einsum("bshd,bthd->bhst", qs.float(), k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(
        out_dtype or q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("splash_attention")
    if lib.splash_attn_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.splash_attn_forward.argtypes = [p, p, p, p, i, i, i, i, i, p,
                                            ctypes.c_float, p]
        lib.splash_attn_forward.restype = ctypes.c_int
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    b, sq, sk, h, d = check_operands(q, k, v, MAX_HEAD_DIM)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = packed_strides(q, k, v, o)
    fn = (f32_lib().splash_attn_forward_f32 if q.dtype == torch.float32
          else _lib().splash_attn_forward)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, sq, sk, d, ctypes.addressof(strides),
            prescale_factor(q.dtype, 1.0 / math.sqrt(d)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"splash attention launch failed: CUDA error {rc}")
    count_launch(splash_attention, q.dtype)
    return o


def splash_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Attention over q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D)
    for tileable shapes: the kernel on CUDA tensors, the plain version on
    CPU ones."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    if not tileable(sq, sk, d):
        raise ValueError(f"splash attention takes S, Sk multiples of 128 and "
                         f"D <= 128 or a multiple of 128, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    splash_attention.seen.add((tuple(q.shape), tuple(k.shape)))
    if q.device.type == "cpu":
        return splash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v)


# kernel launches so far (the CUDA branch only; `launches_f32`: those of
# the f32 kernel alone), and every (q shape, k shape) the wrapper has been
# called with
splash_attention.launches = 0
splash_attention.launches_f32 = 0
splash_attention.seen = set()
