"""K1: fused GroupNorm(+SiLU) over NHWC activations.

Counterpart of `unirenderer_tpu/ops/groupnorm.py` (`fused_groupnorm_silu`,
whose Pallas kernel is `_kernel` via `_fused_fwd`).  On a CUDA tensor the
wrapper launches one hand-written kernel per call (x in bf16 or f32, y in
x's type, as the JAX kernel writes `x.dtype`; scale and bias in bf16 or
f32, read in their own type: the wrapper casts nothing), and raises on
anything it does not take (f16 and f64 included: no JAX entry point
computes in them); on a CPU tensor it runs the plain PyTorch version
below.  Which kernel is decided from the shape before the launch: f32 x
whose per-element slice one thread-block cluster holds goes to
`csrc/groupnorm_f32.cu` (a cluster per batch element); every other shape,
and bf16 always, to `csrc/groupnorm.cu` (one cooperative grid).

Under autograd the call is a `torch.autograd.Function` whose backward is
autograd through the plain version, recomputed from the saved x, scale
and bias: exactly the JAX package's `_vjp_bwd`.  The TPU has no backward
kernel, and neither does the port.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from unirenderer_tpu_torch.ops import _build

# the parameter types the kernel reads, and its flag for each
_PARAM_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# the activation types it reads and writes, and their channels per 16-byte
# vector (C must be a multiple); a block has at most 4096 / vec threads, one
# column vector each, so C is at most 4096
VEC = {torch.bfloat16: 8, torch.float32: 4}
MAX_CHANNELS = 4096


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


def merge_span(hw: int, c: int, groups: int, vec: int = 8) -> int:
    """Lanes the kernel gives each group when it merges the chunks: the
    largest power of two up to 32 with groups * span <= its threads (C /
    vec column vectors, `vec` = `VEC[x.dtype]`, times min(4096 / vec //
    (C / vec), HW) row lanes, in whole warps)."""
    nv = c // vec
    threads = -(-nv * min(MAX_CHANNELS // vec // nv, hw) // 32) * 32
    span = 32
    while span > 1 and groups * span > threads:
        span //= 2
    return span


def chunked_stats_reference(x: torch.Tensor, groups: int, n_chunks: int,
                            span: int = 32) -> tuple:
    """The kernel's statistics, in its order, in f32: x (B, ..., C) split
    into `n_chunks` contiguous row ranges per batch element (the kernel's
    blocks); per chunk and channel the mean and M2 (two passes here; in the
    kernel a Welford walk per row lane and a tree over the lanes); the
    channels of a group merged at equal counts (the mean of the means; M2
    plus n times the squared spread of the means); the chunks merged by
    Chan's formula in the kernel's fixed order: `span` lanes a group, lane
    l taking chunks l, l + span, ... in turn, then a tree over the lanes
    (offsets span / 2, ..., 1).  Returns each (batch, group)'s mean and
    variance, (B, G) each."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xf = x.float().reshape(b, -1, c)
    hw = xf.shape[1]
    rows = -(-hw // max(1, min(n_chunks, hw)))
    parts = []                      # per chunk: (n, mean, M2), (B, G) each
    for r0 in range(0, hw, rows):
        r1 = min(hw, r0 + rows)
        chunk = xf[:, r0:r1].reshape(b, r1 - r0, groups, cg)
        ch_mean = chunk.mean(dim=1)                       # (B, G, cg)
        ch_m2 = ((chunk - ch_mean[:, None]) ** 2).sum(dim=1)
        g_mean = ch_mean.sum(dim=-1) / cg
        g_m2 = (ch_m2 + (r1 - r0) * (ch_mean - g_mean[..., None]) ** 2
                ).sum(dim=-1)
        parts.append((float((r1 - r0) * cg), g_mean, g_m2))

    def merge(a, bb):
        (na, ma, qa), (nb, mb, qb) = a, bb
        if nb == 0:
            return a
        if na == 0:
            return bb
        nt = na + nb
        d = mb - ma
        f = torch.tensor(nb, dtype=torch.float32) / nt
        return (nt, ma + d * f, qa + qb + d * d * na * f)

    zero = (0.0, torch.zeros(b, groups), torch.zeros(b, groups))
    lanes = []
    for lane in range(span):
        acc = zero
        for ch in range(lane, len(parts), span):
            acc = merge(acc, parts[ch])
        lanes.append(acc)
    off = span // 2
    while off:
        lanes = [merge(lanes[i], lanes[i + off]) if i < off else lanes[i]
                 for i in range(span)]
        off //= 2
    n, mean, m2 = lanes[0]
    return mean, torch.clamp(m2 / n, min=0.0)


def cluster_stats_reference(x: torch.Tensor, groups: int,
                            ctas: int) -> tuple:
    """The cluster kernel's statistics (csrc/groupnorm_f32.cu), in its
    order, in f32: x (B, ..., C) split into `ctas` contiguous row ranges
    of ceil(HW / ctas) rows per batch element (the cluster's ranks; the
    last ones may hold fewer, or none); per rank and channel the mean and
    M2 (two passes here; in the kernel a Welford walk per thread, its row
    lanes merged at once by Chan's formula for k parts); the channels of
    a group merged at equal counts (the mean of the means; M2 plus n times
    the squared spread of the means); the ranks merged by Chan's formula
    in rank order, 0 first.
    Returns each (batch, group)'s mean and variance, (B, G) each."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xf = x.float().reshape(b, -1, c)
    hw = xf.shape[1]
    rows = -(-hw // ctas)
    n, mean, m2 = 0.0, torch.zeros(b, groups), torch.zeros(b, groups)
    for rank in range(ctas):
        r0, r1 = min(hw, rank * rows), min(hw, (rank + 1) * rows)
        if r1 == r0:
            continue
        part = xf[:, r0:r1].reshape(b, r1 - r0, groups, cg)
        ch_mean = part.mean(dim=1)                        # (B, G, cg)
        ch_m2 = ((part - ch_mean[:, None]) ** 2).sum(dim=1)
        p_mean = ch_mean.sum(dim=-1) / cg
        p_m2 = (ch_m2 + (r1 - r0) * (ch_mean - p_mean[..., None]) ** 2
                ).sum(dim=-1)
        p_n = float((r1 - r0) * cg)
        if n == 0:
            n, mean, m2 = p_n, p_mean, p_m2
            continue
        nt = n + p_n
        d = p_mean - mean
        f = torch.tensor(p_n, dtype=torch.float32) / nt
        n, mean, m2 = nt, mean + d * f, m2 + p_m2 + d * d * n * f
    return mean, torch.clamp(m2 / n, min=0.0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("groupnorm")
    if lib.gn_silu_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gn_max_blocks.argtypes = []
        lib.gn_max_blocks.restype = i
        for fn in (lib.gn_silu_forward, lib.gn_silu_forward_f32):
            fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i,
                           p]
            fn.restype = ctypes.c_int
        lib.gn_plan.argtypes = [i, i, i, i, i, i, p]
        lib.gn_plan.restype = ctypes.c_int
    return lib


def _lib_f32() -> ctypes.CDLL:
    lib = _build.load("groupnorm_f32")
    if lib.gn_cluster_forward_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gn_cluster_forward_f32.argtypes = [p, p, p, p, i, i, i, i,
                                               ctypes.c_float, i, i, p]
        lib.gn_cluster_forward_f32.restype = i
        lib.gn_cluster_plan.argtypes = [i, i, i, i, i, p]
        lib.gn_cluster_plan.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    with torch.cuda.device(device_index):
        return _lib().gn_max_blocks()


@functools.lru_cache(maxsize=None)
def _cluster_plan(batch: int, hw: int, c: int, groups: int,
                  param_type: int, device_index) -> dict:
    """The cluster kernel's plan of an f32 shape on the card: `ctas` a
    cluster (0: the kernel does not take the shape; see the note of
    csrc/groupnorm_f32.cu for the rule), `rows_per_block`, `threads`,
    `smem_bytes`."""
    lib = _lib_f32()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = lib.gn_cluster_plan(batch, hw, c, groups, param_type,
                                 ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"groupnorm cluster plan for ({batch}, {hw}, "
                           f"{c}) failed: CUDA error {rc}")
    return dict(ctas=out[0], rows_per_block=out[1], threads=out[2],
                smem_bytes=out[3])


def plan(shape, groups: int, dtype: torch.dtype = torch.bfloat16,
         param_dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """The launch plan for x of `shape` and `dtype` on the card, without a
    launch: `branch` ("cluster": csrc/groupnorm_f32.cu, a cluster of
    `ctas` CTAs per batch element; "cached" / "re-read": csrc/groupnorm.cu's
    cooperative grid, keeping x's rows in shared memory or having the
    apply read them again), `cached` (True where x is read from device
    memory once), `blocks`, `rows_per_block`, `threads`, `smem_bytes`."""
    shape = tuple(shape)
    c = shape[-1]
    hw = math.prod(shape[1:-1])
    device = torch.device(device if device is not None else "cuda")
    if dtype == torch.float32:
        cl = _cluster_plan(shape[0], hw, c, groups,
                           _PARAM_TYPES[param_dtype], device.index)
        if cl["ctas"]:
            return dict(branch="cluster", cached=True,
                        blocks=shape[0] * cl["ctas"], **cl)
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = _lib().gn_plan(
            shape[0], hw, c, groups, int(dtype == torch.float32),
            _PARAM_TYPES[param_dtype], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"groupnorm plan for {shape} failed: CUDA error "
                           f"{rc}")
    return dict(branch="cached" if out[0] else "re-read",
                cached=bool(out[0]), blocks=out[1], rows_per_block=out[2],
                threads=out[3], smem_bytes=out[4])


def _launch_cluster(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, batch: int, hw: int, groups: int,
                    eps: float, silu: bool) -> torch.Tensor:
    """csrc/groupnorm_f32.cu on a checked f32 x that its plan takes: no
    workspace, one launch."""
    y = torch.empty_like(x)
    rc = _lib_f32().gn_cluster_forward_f32(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        batch, hw, x.shape[-1], groups, float(eps), int(bool(silu)),
        _PARAM_TYPES[scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm cluster kernel launch failed: CUDA "
                           f"error {rc}")
    fused_groupnorm_silu.launches += 1
    fused_groupnorm_silu.launches_f32 += 1
    fused_groupnorm_silu.launches_cluster += 1
    return y


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            groups: int, eps: float, silu: bool) -> torch.Tensor:
    c = x.shape[-1]
    if x.dtype not in VEC:
        raise TypeError(f"groupnorm kernel takes bfloat16 or float32, got "
                        f"{x.dtype}")
    vec = VEC[x.dtype]
    if x.dim() < 2 or c % vec != 0 or c % groups != 0 or c > MAX_CHANNELS:
        raise ValueError(f"groupnorm kernel needs C % {vec} == 0 for "
                         f"{x.dtype} and C % groups == 0, got shape "
                         f"{tuple(x.shape)}, groups={groups}")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("groupnorm kernel needs a contiguous, 16-byte "
                         "aligned input")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},)")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale/bias must be on the input's device")
    if scale.dtype != bias.dtype or scale.dtype not in _PARAM_TYPES:
        raise TypeError(f"scale/bias must share one type of bfloat16 or "
                        f"float32, got {scale.dtype}/{bias.dtype}")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("scale/bias must be contiguous")
    batch = x.shape[0]
    hw = math.prod(x.shape[1:-1])
    if x.dtype == torch.float32 and _cluster_plan(
            batch, hw, c, groups, _PARAM_TYPES[scale.dtype],
            x.device.index)["ctas"]:
        return _launch_cluster(x, scale, bias, batch, hw, groups, eps, silu)
    lib = _lib()
    # one float2 per (block, group): written whole before it is read
    ws = torch.empty(_max_blocks(x.device.index) * groups * 8,
                     dtype=torch.uint8, device=x.device)
    y = torch.empty_like(x)
    fn = lib.gn_silu_forward_f32 if x.dtype == torch.float32 \
        else lib.gn_silu_forward
    rc = fn(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        ws.data_ptr(), batch, hw, c, groups, float(eps), int(bool(silu)),
        _PARAM_TYPES[scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm kernel launch failed: CUDA error {rc}")
    fused_groupnorm_silu.launches += 1
    if x.dtype == torch.float32:
        fused_groupnorm_silu.launches_f32 += 1
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


# kernel launches so far (the CUDA branch only; `launches_f32`: those of
# the f32 forms alone; `launches_cluster`: those of the cluster kernel,
# all f32), and every (shape, groups, eps, silu) the wrapper has been
# called with
fused_groupnorm_silu.launches = 0
fused_groupnorm_silu.launches_f32 = 0
fused_groupnorm_silu.launches_cluster = 0
fused_groupnorm_silu.seen = set()
