"""Mesh preprocessing CLI of the port (counterpart of `tools/obj2mesh.py`):
every `.obj` under --src -> `load_obj(normalize=True)` (the g++-built
scanner of `native/objio.cpp`, corners unified, normals and tangents) ->
one compressed `.npz` a mesh in --dst, the layout `data/objaverse.py`
reads (`kd_map`, the first material's map_Kd path, as a unicode array).

    python -m unirenderer_tpu_torch.data.obj2mesh --src DIR --dst DIR \\
        [--workers 8]

The output of `<src>/a/b.obj` is `<dst>/a_b.npz`.  Meshes load on a pool
of --workers threads; a mesh that fails is printed and skipped.  The
scanner is built before any mesh is read: a failed build stops the CLI
with a non-zero code (nothing falls back to the numpy parser).
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from unirenderer_tpu_torch.data.obj_io import load_obj, native_lib


def mesh_arrays(path: str) -> dict:
    """The arrays obj2mesh writes for one OBJ."""
    m = load_obj(path, normalize=True)
    out = {k: v for k, v in m.items() if isinstance(v, np.ndarray)}
    if m.get("kd_map"):
        out["kd_map"] = np.asarray(m["kd_map"], dtype="U")
    return out


def process_obj(src: str, dst: str) -> bool:
    """Write `src`'s arrays to `dst`; False (the error printed) if the
    mesh could not be read."""
    try:
        np.savez_compressed(dst, **mesh_arrays(src))
        return True
    except Exception:             # one bad mesh must not stop the rest
        print(f"[obj2mesh] failed: {src}", file=sys.stderr)
        traceback.print_exc()
        return False


def find_jobs(src: str, dst: str) -> List[Tuple[str, str]]:
    """(obj path, npz path) of every .obj under `src`."""
    jobs = []
    for root, _, files in os.walk(src):
        for f in files:
            if f.lower().endswith(".obj"):
                path = os.path.join(root, f)
                rel = os.path.relpath(path, src)
                jobs.append((path, os.path.join(
                    dst, rel.replace(os.sep, "_")[:-4] + ".npz")))
    return jobs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unirenderer_tpu_torch.data.obj2mesh",
        description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    native_lib()                  # raises if the scanner cannot be built
    os.makedirs(args.dst, exist_ok=True)
    jobs = find_jobs(args.src, args.dst)
    print(f"[obj2mesh] {len(jobs)} meshes", flush=True)
    with ThreadPoolExecutor(args.workers) as ex:
        results = list(ex.map(lambda job: process_obj(*job), jobs))
    print(f"[obj2mesh] ok={sum(results)} "
          f"failed={len(results) - sum(results)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
