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
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

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
