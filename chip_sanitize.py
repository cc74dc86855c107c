#!/usr/bin/env python3
"""Kernel calls of `chip_smoke.py` for compute-sanitizer, on one card.

    compute-sanitizer --tool memcheck python3 chip_sanitize.py phase2-head
    compute-sanitizer --tool racecheck python3 chip_sanitize.py k1 2,64,64,320
    compute-sanitizer --tool synccheck python3 chip_sanitize.py k2 2,4096,8,40
    CUDA_LAUNCH_BLOCKING=1 python3 chip_sanitize.py checked
    python3 chip_sanitize.py versions

Modes:
  phase2-head  chip_smoke.py phase 2's K1 cases, then its K2 forward cases,
               in its order and on its inputs (the same seeded generator),
               each against its plain version; no timing (the timer calls
               nothing)
  checked      K1 and K2 built with -DUNIRENDER_INDEX_CHECK (every computed
               global index checked against its tensor's extent, a device
               trap naming it when one is outside; `csrc/index_check.cuh`),
               then every K1 and K2 forward case of phase 2 in its order,
               the sampling modes' cases included, against the plain
               versions
  versions     nvcc's, compute-sanitizer's and the driver's versions, and
               each compute-sanitizer the toolkit directories hold
  k1 B,H,W,C   one K1 call (GroupNorm + SiLU, 32 groups, bf16 parameters)
  k2 B,S,H,D   one K2 forward, one with the log-sum-exp and one K2 bwd on
               self-attention of that shape
  k4           one K4 call at the flagship collate's shape

Each call is followed by a sync, so a fault is reported at its kernel.
Exits 0 when every call and check passed (the sanitizer's own exit code
reports what it found).
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys
import time


def _shape(arg: str):
    return tuple(int(x) for x in arg.split(","))


def _run(cmd) -> str:
    """A command's first output line, or why there is none."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"not run: {e}"
    text = (out.stdout + out.stderr).strip().splitlines()
    return " | ".join(line for line in text if line.strip()) or (
        f"exit {out.returncode}, no output")


def versions() -> int:
    from unirenderer_tpu_torch.ops import _build
    import torch
    print(f"nvcc: {_run([_build.nvcc_path(), '--version'])}", flush=True)
    print("driver: " + _run(["nvidia-smi", "--query-gpu=driver_version,"
                             "name,power.limit", "--format=csv,noheader"]),
          flush=True)
    print(f"torch {torch.__version__}, built for CUDA {torch.version.cuda}",
          flush=True)
    found = sorted(set(glob.glob("/usr/local/cuda*/bin/compute-sanitizer")
                       + glob.glob("/usr/local/cuda*/compute-sanitizer/"
                                   "compute-sanitizer")
                       + [p for p in [shutil.which("compute-sanitizer")]
                          if p]))
    for path in found:
        print(f"{path} ({os.path.realpath(path)}): "
              f"{_run([path, '--version'])}", flush=True)
    if not found:
        print("compute-sanitizer: none found", flush=True)
    return 0


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_sanitize: no CUDA device", file=sys.stderr)
        return 2
    mode = argv[0]
    if mode == "versions":
        return versions()
    import chip_smoke as cs
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    if mode == "checked":
        # load the checked K1 and K2 first: the wrappers take them
        for name in ("groupnorm", "flash_attention"):
            _build.load(name, _build.INDEX_CHECK)
    else:
        _build.build()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    if mode in ("phase2-head", "checked"):
        import torch.nn.functional as F
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cases = cs.phase2_cases(config.flagship())
        later = ((cases["later_gn"], cases["modes_gn"], cases["modes_attn"])
                 if mode == "checked" else ([], [], []))
        results = cs.phase_kernels(torch, F, lambda fn: 0.0,
                                   cases["gn_jobs"], cases["attn_jobs"],
                                   [], [], [], *later)
        print(f"{len(results) - 1} cases passed", flush=True)
    elif mode == "k1":
        from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
        shape = _shape(argv[1])
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        w = torch.ones(shape[-1], device="cuda", dtype=torch.bfloat16)
        fused_groupnorm_silu(x, w, w, 32, 1e-5, True)
        torch.cuda.synchronize()
    elif mode == "k2":
        from unirenderer_tpu_torch.ops.flash_attention import (
            flash_attention, flash_attention_backward,
            flash_attention_with_lse,
        )
        shape = _shape(argv[1])
        q, k, v, do = (torch.randn(shape, generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        flash_attention(q, k, v)
        torch.cuda.synchronize()
        o, lse = flash_attention_with_lse(q, k, v)
        torch.cuda.synchronize()
        flash_attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    elif mode == "k4":
        from unirenderer_tpu_torch.ops.rasterize import rasterize
        d = config.flagship().data
        res = d.resolution * d.ssaa
        pos, tri = cs.deformed_spheres(torch, 2, 90, d.v_pad, d.t_pad,
                                       cs.SEED)
        rasterize(pos, tri, res, res)
        torch.cuda.synchronize()
    else:
        print(f"chip_sanitize: unknown mode {mode}", file=sys.stderr)
        return 2
    print(f"chip_sanitize {' '.join(argv)}: ok in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
