"""K1: fused GroupNorm(+SiLU) over NHWC activations.

Counterpart of `unirenderer_tpu/ops/groupnorm.py` (`fused_groupnorm_silu`,
whose Pallas kernel is `_kernel` via `_fused_fwd`).  On a CUDA tensor the
wrapper launches the hand-written kernel of `csrc/groupnorm.cu` (bf16 only)
and raises on anything it does not take; on a CPU tensor it runs the plain
PyTorch version below.

Under autograd the call is a `torch.autograd.Function` whose backward is
autograd through the plain version, recomputed from the saved x, scale
and bias: exactly the JAX package's `_vjp_bwd`.  The TPU has no backward
kernel, and neither does the port.
"""

from __future__ import annotations

import ctypes
import math

import torch

from unirenderer_tpu_torch.ops import _build


def groupnorm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, groups: int, eps: float,
                             silu: bool) -> torch.Tensor:
    """Plain version (flax nn.GroupNorm semantics, NHWC, stats in f32)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(x.shape) * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("groupnorm")
    if lib.gn_silu_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gn_workspace_bytes.argtypes = [i, i, i, i]
        lib.gn_workspace_bytes.restype = ctypes.c_longlong
        lib.gn_silu_forward.argtypes = [p, p, p, p, p, i, i, i, i,
                                        ctypes.c_float, i, p]
        lib.gn_silu_forward.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            groups: int, eps: float, silu: bool) -> torch.Tensor:
    c = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"groupnorm kernel takes bfloat16, got {x.dtype}")
    if x.dim() < 2 or c % 8 != 0 or c % groups != 0 or c > 8192:
        raise ValueError(f"groupnorm kernel needs C % 8 == 0 and "
                         f"C % groups == 0, got shape {tuple(x.shape)}, "
                         f"groups={groups}")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("groupnorm kernel needs a contiguous, 16-byte "
                         "aligned input")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},)")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale/bias must be on the input's device")
    batch = x.shape[0]
    hw = math.prod(x.shape[1:-1])
    lib = _lib()
    scale32 = scale.float().contiguous()
    bias32 = bias.float().contiguous()
    ws = torch.empty(lib.gn_workspace_bytes(batch, hw, c, groups),
                     dtype=torch.uint8, device=x.device)
    y = torch.empty_like(x)
    rc = lib.gn_silu_forward(
        x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
        ws.data_ptr(), batch, hw, c, groups, float(eps), int(bool(silu)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm kernel launch failed: CUDA error {rc}")
    fused_groupnorm_silu.launches += 1
    return y


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             groups: int, eps: float, silu: bool) -> torch.Tensor:
    fused_groupnorm_silu.seen.add((tuple(x.shape), groups, eps, bool(silu)))
    if x.device.type == "cpu":
        return groupnorm_silu_reference(x, scale, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"no groupnorm kernel for device {x.device}")
    return _launch(x, scale, bias, groups, eps, silu)


class _FusedGroupNormSiLU(torch.autograd.Function):
    """K1 under autograd: the kernel (or the plain version) forward; the
    backward differentiates the plain version, recomputed from the saved
    inputs (the JAX package's `_vjp_bwd`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, silu)
        return _forward(x, scale, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        with torch.enable_grad():
            y = groupnorm_silu_reference(*inputs, *ctx.args)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wrt, dy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None, None, None)


def fused_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float,
                         silu: bool) -> torch.Tensor:
    """GroupNorm over x (B, ..., C) with per-channel affine and optional
    SiLU; the kernel on a CUDA tensor, the plain version on a CPU one;
    differentiable when grad is enabled and an input requires it."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _FusedGroupNormSiLU.apply(x, scale, bias, groups, eps, silu)
    return _forward(x, scale, bias, groups, eps, silu)


# kernel launches so far (the CUDA branch only), and every
# (shape, groups, eps, silu) the wrapper has been called with
fused_groupnorm_silu.launches = 0
fused_groupnorm_silu.seen = set()
