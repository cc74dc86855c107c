"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` has a plain `extern "C"` interface and includes no
PyTorch header (only the shared `csrc/*.cuh` device code), so one `nvcc`
call builds it into a shared library in seconds.  The library goes to
`_build/` beside this package (ignored by git) under a name that carries a
hash of the source, the headers and the flags, so a second process on the
same machine reuses it.  It is loaded with `ctypes`.

A missing `nvcc` or a failed build raises: nothing falls back.

`extra_flags` (`INDEX_CHECK`: every computed global index of K1 and K2
checked against its tensor's extent, `csrc/index_check.cuh`) builds a
separate library; the first `load` of a name in a process fixes its
flags, and the wrappers take whatever is loaded.  The package itself
never passes flags.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("groupnorm", "flash_attention", "flash_attention_bwd",
           "splash_attention", "attn_kernel", "rasterize",
           "flash_attention_f32", "flash_attention_bwd_f32",
           "groupnorm_f32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the checked build of chip_sanitize.py
INDEX_CHECK = ("-DUNIRENDER_INDEX_CHECK",)

# The sources whose many template instances make them the build's long
# pole: nvcc spreads their optimisation over the machine's cores, which
# the other sources have left by then.
SPLIT_COMPILE = ("flash_attention_f32", "flash_attention_bwd_f32")

_loaded: Dict[str, Tuple[ctypes.CDLL, Tuple[str, ...]]] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float          # 0.0 when an earlier build was reused
    log: str                # nvcc's output, with the -Xptxas -v report


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def source_flags(name: str, extra_flags: Tuple[str, ...] = ()
                 ) -> Tuple[str, ...]:
    """nvcc's flags for `csrc/<name>.cu`: the common ones, the split of
    the long-pole sources, then `extra_flags`."""
    split = ("-split-compile=0",) if name in SPLIT_COMPILE else ()
    return NVCC_FLAGS + split + tuple(extra_flags)


def library_path(name: str, extra_flags: Tuple[str, ...] = ()) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    flags = " ".join(source_flags(name, extra_flags))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES,
          extra_flags: Tuple[str, ...] = ()) -> Dict[str, BuildResult]:
    """Build every named source not yet built (with `extra_flags` after
    the default ones), one nvcc per source, all started together.
    Returns each library's path, build time and log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    for name in names:
        out = library_path(name, extra_flags)
        log_path = out.with_suffix(".log")
        if out.exists():
            log = log_path.read_text() if log_path.exists() else ""
            results[name] = BuildResult(name, out, 0.0, log)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *source_flags(name, extra_flags), "-o",
               str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, log_path, time.perf_counter(), cmd)
    failures = []
    for name, (proc, tmp, out, log_path, t0, cmd) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, seconds, log)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return results


def load(name: str,
         extra_flags: Optional[Tuple[str, ...]] = None) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built at first use with
    `extra_flags` (none by default).  Without `extra_flags` a later call
    takes the library already loaded; with them, one loaded with other
    flags raises."""
    if name not in _loaded:
        flags = tuple(extra_flags or ())
        path = build([name], flags)[name].path
        _loaded[name] = (ctypes.CDLL(str(path)), flags)
    lib, flags = _loaded[name]
    if extra_flags is not None and tuple(extra_flags) != flags:
        raise RuntimeError(f"{name} is loaded with flags {flags}, not "
                           f"{tuple(extra_flags)}")
    return lib
