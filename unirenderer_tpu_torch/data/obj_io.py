"""OBJ / MTL loading (counterpart of `unirenderer_tpu/data/obj_io.py`).

Two parsers give the same arrays: the C++ scanner of `native/objio.cpp`,
compiled here with `g++` into the package's git-ignored `_build/` and
bound with `ctypes` (`use_native=True`, the default), and a numpy one
(`use_native=False`).  A failed build or load of the scanner raises:
nothing falls back to the numpy parser.

After parsing, the (position, texcoord, normal) corners are unified into
one vertex set with one index buffer, the layout the renderer
interpolates with; missing normals come from `render/mesh.auto_normals`,
tangents from `render/mesh.compute_tangents`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from unirenderer_tpu_torch.render.mesh import (
    auto_normals, compute_tangents, unit_normalize_mesh,
)

NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "objio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def native_library_path() -> Path:
    """Where the scanner's library goes: a name that carries a hash of the
    source and the flags, so a changed source is built anew."""
    digest = hashlib.sha256(NATIVE_SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libobjio_{digest[:16]}.so"


def build_native() -> Path:
    """Compile `native/objio.cpp` with g++ (once per source) -> its path.
    Raises if the compiler is missing or fails."""
    out = native_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(NATIVE_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def native_lib() -> ctypes.CDLL:
    """The scanner, built at first use and loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_native()))
            fpp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
            ipp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int))
            lp = ctypes.POINTER(ctypes.c_long)
            lib.objio_parse.argtypes = [ctypes.c_char_p, fpp, lp, fpp, lp,
                                        fpp, lp, ipp, ipp, ipp, lp]
            lib.objio_parse.restype = ctypes.c_int
            lib.objio_free.argtypes = [ctypes.c_void_p]
            lib.objio_free.restype = None
            _LIB = lib
    return _LIB


def _parse_obj_native(path: str):
    lib = native_lib()
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    v_pos, v_tex, v_nrm = fp(), fp(), fp()
    f_pos, f_tex, f_nrm = ip(), ip(), ip()
    n_pos, n_tex, n_nrm, n_tri = (ctypes.c_long(), ctypes.c_long(),
                                  ctypes.c_long(), ctypes.c_long())
    rc = lib.objio_parse(
        os.fsencode(path), ctypes.byref(v_pos), ctypes.byref(n_pos),
        ctypes.byref(v_tex), ctypes.byref(n_tex),
        ctypes.byref(v_nrm), ctypes.byref(n_nrm),
        ctypes.byref(f_pos), ctypes.byref(f_tex), ctypes.byref(f_nrm),
        ctypes.byref(n_tri))
    if rc != 0:
        raise OSError(f"objio_parse({path}) returned {rc}")

    def take(ptr, n, width, dtype):
        out = (np.ctypeslib.as_array(ptr, shape=(n * width,)).reshape(
            n, width).copy() if n else np.zeros((0, width), dtype))
        lib.objio_free(ptr)
        return out

    t = n_tri.value
    return (take(v_pos, n_pos.value, 3, np.float32),
            take(v_tex, n_tex.value, 2, np.float32),
            take(v_nrm, n_nrm.value, 3, np.float32),
            take(f_pos, t, 3, np.int32), take(f_tex, t, 3, np.int32),
            take(f_nrm, t, 3, np.int32))


def _fix_index(i: int, n: int) -> int:
    """1-based or negative (relative) OBJ index -> 0-based; 0 (absent) ->
    -1."""
    return i - 1 if i > 0 else (n + i if i < 0 else -1)


def _parse_obj_python(path: str):
    v, vt, vn = [], [], []
    fp_, ft_, fn_ = [], [], []
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                v.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                vt.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                vn.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corners = []
                for c in parts[1:]:
                    sub = c.split("/")
                    vi = int(sub[0])
                    ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
                    ni = int(sub[2]) if len(sub) > 2 and sub[2] else 0
                    corners.append((_fix_index(vi, len(v)),
                                    _fix_index(ti, len(vt)),
                                    _fix_index(ni, len(vn))))
                for k in range(2, len(corners)):        # fan triangulation
                    tri = [corners[0], corners[k - 1], corners[k]]
                    fp_.append([c[0] for c in tri])
                    ft_.append([c[1] for c in tri])
                    fn_.append([c[2] for c in tri])

    def to(a, width, dtype):
        return np.asarray(a, dtype) if a else np.zeros((0, width), dtype)

    return (to(v, 3, np.float32), to(vt, 2, np.float32),
            to(vn, 3, np.float32), to(fp_, 3, np.int32),
            to(ft_, 3, np.int32), to(fn_, 3, np.int32))


def parse_mtl(path: str) -> Dict[str, Dict]:
    """Kd colour (default 0.8 grey) and map_Kd path per material; {} when
    the file does not exist."""
    mats: Dict[str, Dict] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = {"kd": np.array([0.8, 0.8, 0.8], np.float32)}
            elif cur and parts[0].lower() == "kd":
                mats[cur]["kd"] = np.asarray(
                    [float(x) for x in parts[1:4]], np.float32)
            elif cur and parts[0].lower() == "map_kd":
                mats[cur]["map_kd"] = os.path.join(
                    os.path.dirname(path), parts[-1])
    return mats


def load_obj(path: str, normalize: bool = True, use_native: bool = True):
    """Load an OBJ and unify its corners into one vertex buffer.

    Returns v_pos (V, 3), t_idx (T, 3) int32, v_nrm, v_tex, v_tng, kd (3,)
    and kd_map (the first material's map_Kd path or None) from the .mtl of
    the same name."""
    parsed = (_parse_obj_native(path) if use_native
              else _parse_obj_python(path))
    v_pos, v_tex, v_nrm, f_pos, f_tex, f_nrm = parsed
    if len(f_pos) == 0 or len(v_pos) == 0:
        raise ValueError(f"empty mesh: {path}")

    if normalize:
        v_pos = unit_normalize_mesh(v_pos)

    corners = np.stack([f_pos.reshape(-1), f_tex.reshape(-1),
                        f_nrm.reshape(-1)], axis=1)
    uniq, inverse = np.unique(corners, axis=0, return_inverse=True)
    t_idx = inverse.reshape(-1, 3).astype(np.int32)
    new_pos = v_pos[uniq[:, 0]]
    # a corner without a texcoord reads uv (0, 0)
    new_tex = (v_tex[uniq[:, 1]] if len(v_tex)
               else np.zeros((len(uniq), 2), np.float32))
    new_tex[uniq[:, 1] < 0] = 0.0
    if len(v_nrm):
        has = uniq[:, 2] >= 0
        new_nrm = np.zeros((len(uniq), 3), np.float32)
        new_nrm[has] = v_nrm[np.maximum(uniq[:, 2], 0)][has]
        if not has.all():
            fallback = auto_normals(new_pos, t_idx)
            new_nrm[~has] = fallback[~has]
    else:
        new_nrm = auto_normals(new_pos, t_idx)

    v_tng = compute_tangents(new_pos, t_idx, new_tex, t_idx, new_nrm, t_idx)

    kd = np.array([0.8, 0.8, 0.8], np.float32)
    kd_map = None
    mats = parse_mtl(os.path.splitext(path)[0] + ".mtl")
    if mats:
        m = next(iter(mats.values()))
        kd = m.get("kd", kd)
        kd_map = m.get("map_kd")

    return {"v_pos": new_pos, "t_idx": t_idx, "v_nrm": new_nrm,
            "v_tex": new_tex, "v_tng": v_tng, "kd": kd, "kd_map": kd_map}
