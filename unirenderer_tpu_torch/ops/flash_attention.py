"""K2: non-causal flash attention over (B, S, H, D) tensors, forward only.

Counterpart of `unirenderer_tpu/ops/flash_attention.py`
(`tpu_flash_attention`, the library Pallas TPU flash kernel) and of the
XLA paths the TPU routed the other attention shapes to
(`models/layers.py` `dmajor_attention`).  On a CUDA tensor the wrapper
launches the hand-written kernel of `csrc/flash_attention.cu` for every
shape the UNet sees (self and cross, D a multiple of 8 up to 160) and
raises on anything it does not take; on a CPU tensor it runs the plain
PyTorch version below.  It serves every attention call under the default
route (`models/layers.py` `attention`); the splash and unet_flash routes
(`ops/splash_attention.py`, `ops/attn_kernel.py`) take the tileable
self-attention shapes when selected.
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attn_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_forward.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.flash_attn_forward.restype = ctypes.c_int
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


def prescale_q(q: torch.Tensor, factor: float) -> torch.Tensor:
    """q * factor with the factor rounded to q's type, the product rounded
    to q's type (JAX's `q * factor` with a weakly typed or q-typed factor),
    as the splash and unet_flash routes pre-scale Q.  The rounded factor
    is a host number: no copy to the device."""
    return q * torch.tensor(factor, dtype=q.dtype).item()


def packed_strides(*tensors: torch.Tensor):
    """The (batch, seq, head) element strides of each tensor, in order, as
    the C array the kernels read."""
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(t.stride(i) for t in tensors for i in range(3)))


def _launch(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    b, sq, sk, h, d = check_operands(q, k, v, MAX_HEAD_DIM)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = packed_strides(q, k, v, o)
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
