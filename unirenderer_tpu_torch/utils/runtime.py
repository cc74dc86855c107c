"""Runtime set-up shared by the port's CLIs (counterpart of
`unirenderer_tpu/utils/runtime.py` `setup_runtime`).

Two environment variables, as in the JAX package:

  * `UNIRENDER_PLATFORM` (`cpu`, `gpu` or `cuda`): the device a CLI runs
    on when it is not given `--device`; unset, the card (`cuda`).  Asking
    for the card where there is none raises: nothing falls back to the
    CPU.
  * `UNIRENDER_COMPILE_CACHE`: the directory the hand-written kernels
    (`ops/_build.py`) and the OBJ scanner (`data/obj_io.py`) are built
    into; unset, the package's git-ignored `_build/`.

f32 on the card means f32: PyTorch runs f32 convolutions through cuDNN in
TF32 by default (`torch.backends.cudnn.allow_tf32`), which keeps 10 bits
of mantissa.  The CLIs that compute in f32 call `disable_tf32()` first;
the library's f32 paths on the card (the train step's gradients, the
VAE step, the pipeline's sampling and VAE calls) run under `exact_f32()`,
which restores the caller's flags after.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Dict, Optional

import torch

PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device with no card raises (nothing
    falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA card is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


def setup_runtime(device: Optional[str] = None) -> torch.device:
    """Apply `UNIRENDER_COMPILE_CACHE` and return the device to run on:
    `device` when given, else `UNIRENDER_PLATFORM`'s, else the card.
    Call it first in every CLI's main()."""
    cache = os.environ.get("UNIRENDER_COMPILE_CACHE")
    if cache:
        from unirenderer_tpu_torch.data import obj_io
        from unirenderer_tpu_torch.ops import _build
        _build.BUILD_DIR = obj_io.BUILD_DIR = Path(cache).resolve()
    if device is None:
        plat = os.environ.get("UNIRENDER_PLATFORM") or "cuda"
        if plat not in PLATFORMS:
            raise ValueError(f"UNIRENDER_PLATFORM={plat!r}: the port takes "
                             f"{', '.join(PLATFORMS)}")
        device = PLATFORMS[plat]
    return resolve_device(device)


def disable_tf32() -> None:
    """f32 products and convolutions in f32 for the rest of the process
    (cuBLAS and cuDNN without TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def exact_f32(enabled: bool = True):
    """Within (when `enabled`): cuBLAS and cuDNN without TF32; the caller's
    flags are restored on exit."""
    if not enabled:
        yield
        return
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    disable_tf32()
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' launches so far in this process, by
    wrapper (every type), and of the f32 forms alone (`<name>_f32`)."""
    from unirenderer_tpu_torch.ops.attn_kernel import unet_flash_attention
    from unirenderer_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward,
    )
    from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
    from unirenderer_tpu_torch.ops.rasterize import rasterize
    from unirenderer_tpu_torch.ops.splash_attention import splash_attention
    out = {"rasterize": rasterize.launches}
    for name, fn in (("groupnorm_silu", fused_groupnorm_silu),
                     ("flash_attention", flash_attention),
                     ("flash_attention_backward", flash_attention_backward),
                     ("splash_attention", splash_attention),
                     ("attn_kernel", unet_flash_attention)):
        out[name] = fn.launches
        out[f"{name}_f32"] = fn.launches_f32
    return out
