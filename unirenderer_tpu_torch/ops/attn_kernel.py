"""K3: the unet_flash route, non-causal attention forward over
(B, S, H, D) tensors, warp-specialised for Hopper (TMA, wgmma, ping-pong).

Counterpart of `unirenderer_tpu/ops/attn_kernel.py` (`unet_flash_attention`,
whose Pallas kernel is `_kernel`), the TPU's forward-only kernel for the
UNet's self-attention, reached under `UNIRENDER_ATTN=unet_flash`.  As
there: Q is pre-scaled by softmax_scale * log2(e) in Q's type and the
softmax is exp2; `running_max=False` drops the running max and the
accumulator rescale (exact for bounded logits: the scaled scores must stay
below ~126, where f32 exp2 overflows); `pipelined` overlaps a tile's
scores with the previous tile's update; S and Sk must divide the blocks
(block_q 512, block_k 1024, each capped at S / Sk), or the call raises
ValueError, as the JAX kernel does.  On a CUDA tensor the wrapper launches
the hand-written kernel of `csrc/attn_kernel.cu` (bf16, D a multiple of 8
up to 128), which stages Q as bf16(q * bf16(factor)) itself (the bits of
`prescale_q`): one launch per call, nothing else.  f32 operands go to the
unet_flash entry point of the f32 attention kernel
(`csrc/flash_attention_f32.cu`): Q staged as f32(q * f32(factor)), the
factor in q's type as JAX rounds it (not the bf16 one), exp2 with or
without the running max; it has one schedule, so `pipelined` (the order
of the work, not its result) changes nothing there.  It raises on
anything the kernels do not take; on a CPU tensor it runs the plain
version below.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from unirenderer_tpu_torch.ops import _build
from unirenderer_tpu_torch.ops.flash_attention import (
    check_operands, count_launch, f32_lib, packed_strides, prescale_factor,
    prescale_q,
)

MAX_HEAD_DIM = 128
LOG2E = math.log2(math.e)


def _factor(d: int) -> float:
    """softmax_scale * log2(e), which JAX folds into Q in Q's type
    (attn_kernel.py:132 of the JAX package)."""
    return 1.0 / math.sqrt(d) * LOG2E


@functools.lru_cache(maxsize=None)
def qscale(d: int) -> float:
    """The factor the kernel stages Q with: `_factor(d)` rounded to bf16."""
    return prescale_factor(torch.bfloat16, _factor(d))


def unet_flash_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         running_max: bool = True,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain version in f32 over (B, S, H, D): scores of the pre-scaled Q
    in log2 units, p = exp2(s - rowmax) (exp2(s) without `running_max`),
    o = (p V) / sum(p); cast to `out_dtype` (q's type by default)."""
    qs = prescale_q(q, _factor(q.shape[-1]))
    s = torch.einsum("bshd,bthd->bhst", qs.float(), k.float())
    if running_max:
        s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s)
    o = torch.einsum("bhst,bthd->bshd", p, v.float())
    return (o / p.sum(dim=-1).transpose(1, 2)[..., None]).to(
        out_dtype or q.dtype)


def _blocks(sq: int, sk: int, block_q: int, block_k: int):
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"S={sq}/{sk} not divisible by blocks {bq}/{bk}")
    return bq, bk


def _lib() -> ctypes.CDLL:
    lib = _build.load("attn_kernel")
    if lib.unet_flash_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.unet_flash_forward.argtypes = [p, p, p, p, i, i, i, i, i, p,
                                           ctypes.c_float, i, i, p]
        lib.unet_flash_forward.restype = ctypes.c_int
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pipelined: bool, running_max: bool) -> torch.Tensor:
    b, sq, sk, h, d = check_operands(q, k, v, MAX_HEAD_DIM)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    packed = packed_strides(q, k, v, o)      # alive until the launch
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, sq, sk, d, ctypes.addressof(packed))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32:
        rc = f32_lib().unet_flash_forward_f32(
            *args, prescale_factor(torch.float32, _factor(d)),
            int(running_max), stream)
    else:
        rc = _lib().unet_flash_forward(*args, qscale(d), int(pipelined),
                                       int(running_max), stream)
    if rc != 0:
        raise RuntimeError(f"unet_flash attention launch failed: CUDA error "
                           f"{rc}")
    count_launch(unet_flash_attention, q.dtype)
    return o


def unet_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, block_q: int = 512, block_k: int = 1024,
                         pipelined: bool = True,
                         running_max: bool = True) -> torch.Tensor:
    """Attention over q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D):
    the kernel on CUDA tensors, the plain version on CPU ones.  Raises
    ValueError unless Sq and Sk divide the (capped) blocks."""
    _blocks(q.shape[1], k.shape[1], block_q, block_k)
    unet_flash_attention.seen.add((tuple(q.shape), tuple(k.shape)))
    if q.device.type == "cpu":
        return unet_flash_reference(q, k, v, running_max)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v, pipelined, running_max)


# kernel launches so far (the CUDA branch only; `launches_f32`: those of
# the f32 kernel alone), and every (q shape, k shape) the wrapper has been
# called with
unet_flash_attention.launches = 0
unet_flash_attention.launches_f32 = 0
unet_flash_attention.seen = set()
