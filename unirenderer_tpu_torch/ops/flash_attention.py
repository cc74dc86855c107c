"""K2: non-causal flash attention over (B, S, H, D) tensors, forward only.

Counterpart of `unirenderer_tpu/ops/flash_attention.py`
(`tpu_flash_attention`, the library Pallas TPU flash kernel) and of the
XLA paths the TPU routed the other attention shapes to
(`models/layers.py` `dmajor_attention`).  On a CUDA tensor the wrapper
launches the hand-written kernel of `csrc/flash_attention.cu` for every
shape the UNet sees (self and cross, D a multiple of 8 up to 160) and
raises on anything it does not take; on a CPU tensor it runs the plain
PyTorch version below.
"""

from __future__ import annotations

import ctypes
import math

import torch

from unirenderer_tpu_torch.ops import _build

MAX_HEAD_DIM = 160


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain version: softmax(Q K^T / sqrt(D)) V in f32 over (B, S, H, D)
    (the function `dmajor_attention` computes), cast back to q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attn_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_forward.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.flash_attn_forward.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash attention takes bfloat16, {name} is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} needs a unit stride on D, other strides "
                         f"a multiple of 8 and 16-byte alignment, got "
                         f"strides {t.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d % 8 != 0 or d > MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"flash attention takes D a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} and B*H <= 65535, got {q.shape}")
    _check("q", q, (b, sq, h, d))
    _check("k", k, (b, sk, h, d))
    _check("v", v, (b, sk, h, d))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    rc = _lib().flash_attn_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, h, sq, sk, d, ctypes.addressof(strides),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention over q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D):
    the kernel on CUDA tensors, the plain version on CPU ones."""
    flash_attention.seen.add((tuple(q.shape), tuple(k.shape)))
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v)


# kernel launches so far (the CUDA branch only), and every
# (q shape, k shape) the wrapper has been called with
flash_attention.launches = 0
flash_attention.seen = set()
