"""Background removal CLI of the port (counterpart of `tools/remove_bg.py`):
an image's RGB over white outside its mask, `rgb * mask + (1 - mask)`.

    batch : python -m unirenderer_tpu_torch.data.remove_bg \\
                --images DIR --masks DIR --out DIR
    single: python -m unirenderer_tpu_torch.data.remove_bg \\
                --image f.png --mask m.png --out o.png

In batch mode every .png / .jpg / .jpeg in --images takes the mask of
the same name in --masks; one without a mask is skipped.  Images are read
as RGB and masks as 8-bit gray, both scaled to [0, 1]; the output is
written as 8-bit RGB.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def apply_mask_white_bg(img01: np.ndarray, mask01: np.ndarray) -> np.ndarray:
    """rgb * mask + white * (1 - mask); a mask (H, W) or (H, W, C), its
    first channel used."""
    if mask01.ndim == 2:
        mask01 = mask01[..., None]
    mask01 = mask01[..., :1]
    return img01[..., :3] * mask01 + (1.0 - mask01)


def _load(path: str, mode: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert(mode), np.float32) / 255.0


def _save(path: str, arr01: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.clip(arr01, 0, 1) * 255).astype(np.uint8)).save(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unirenderer_tpu_torch.data.remove_bg",
        description=__doc__.split("\n")[0])
    ap.add_argument("--image")
    ap.add_argument("--mask")
    ap.add_argument("--images")
    ap.add_argument("--masks")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.image:
        if not args.mask:
            ap.error("--image needs --mask")
        _save(args.out, apply_mask_white_bg(_load(args.image, "RGB"),
                                            _load(args.mask, "L")))
        print(f"wrote {args.out}")
        return 0
    if not (args.images and args.masks):
        ap.error("give --image and --mask, or --images and --masks")

    os.makedirs(args.out, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(args.images)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        mask_path = os.path.join(args.masks, f)
        if not os.path.exists(mask_path):
            print(f"skip (no mask): {f}", file=sys.stderr)
            continue
        _save(os.path.join(args.out, f), apply_mask_white_bg(
            _load(os.path.join(args.images, f), "RGB"),
            _load(mask_path, "L")))
        n += 1
    print(f"processed {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
