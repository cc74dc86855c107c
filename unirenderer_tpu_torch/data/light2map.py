"""Environment-map preprocessing CLI of the port (counterpart of
`tools/light2map.py`): each HDR latlong (`.hdr`, or an (H, W, 3) `.npy`)
in --src -> a --res cubemap -> its average-pooled mip chain down to
--min-res, each level GGX-prefiltered with --samples samples, and the
Lambertian irradiance of the coarsest level (`render/light.
env_from_latlong` on --device) -> `specular_{i}.npy` and `diffuse.npy`
(f32) in `<dst>/<name>/`, the layout `data/objaverse.py` reads.

    python -m unirenderer_tpu_torch.data.light2map --src DIR --dst DIR \\
        [--res 512] [--min-res 16] [--samples 256] [--device cuda]

Files are read in sorted order; one that fails is printed and skipped.
Each env's line gives its seconds (the prefilter ending in a device
synchronisation, and the writes); on the card the last line gives the
peak device memory.  `--device` defaults to $UNIRENDER_PLATFORM, else
cuda.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

import numpy as np
import torch

from unirenderer_tpu_torch.data.hdr import read_hdr
from unirenderer_tpu_torch.render.light import env_from_latlong


def read_latlong(path: str) -> np.ndarray:
    """(H, W, 3) f32 radiance of a `.hdr` or `.npy` file."""
    if path.lower().endswith(".hdr"):
        return read_hdr(path)
    return np.asarray(np.load(path), np.float32)


def prefilter(latlong: np.ndarray, res: int, min_res: int, samples: int,
              device) -> dict:
    """{"specular_{i}": (6, R_i, R_i, 3), "diffuse": ...} as f32 numpy."""
    env = env_from_latlong(torch.as_tensor(latlong, device=device), res=res,
                           min_res=min_res, num_samples=samples)
    out = {f"specular_{i}": s.cpu().numpy()
           for i, s in enumerate(env.specular)}
    out["diffuse"] = env.diffuse.cpu().numpy()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unirenderer_tpu_torch.data.light2map",
        description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--min-res", type=int, default=16)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    args = ap.parse_args(argv)
    from unirenderer_tpu_torch.utils.runtime import setup_runtime
    device = setup_runtime(args.device)

    os.makedirs(args.dst, exist_ok=True)
    files = [f for f in sorted(os.listdir(args.src))
             if f.lower().endswith((".hdr", ".npy"))]
    print(f"[light2map] {len(files)} envs on {device}", flush=True)
    for f in files:
        t = time.perf_counter()
        try:
            maps = prefilter(read_latlong(os.path.join(args.src, f)),
                             args.res, args.min_res, args.samples, device)
            out_dir = os.path.join(args.dst, os.path.splitext(f)[0])
            os.makedirs(out_dir, exist_ok=True)
            for name, arr in maps.items():
                np.save(os.path.join(out_dir, f"{name}.npy"), arr)
        except Exception:         # one bad file must not stop the rest
            print(f"[light2map] failed: {f}", file=sys.stderr)
            traceback.print_exc()
            continue
        print(f"[light2map] ok {f} in {time.perf_counter() - t:.3f} s",
              flush=True)
    if device.type == "cuda":
        print(f"[light2map] peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
