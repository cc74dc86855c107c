"""Radiance RGBE (.hdr) reader and writer in numpy (the port's copy of
`unirenderer_tpu/data/hdr.py`): RLE-compressed and flat scanlines in,
flat scanlines out."""

from __future__ import annotations

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """Returns (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    # header
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    pos = 0
    width = height = None
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"-Y"):
            parts = line.split()
            height, width = int(parts[1]), int(parts[3])
            break
        if width is not None:
            break
    assert width and height
    rgbe = np.zeros((height, width, 4), np.uint8)
    for y in range(height):
        # new-style RLE scanline?
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and ((data[pos + 2] << 8) | data[pos + 3]) == width
                and width >= 8 and width < 32768):
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    n = data[pos]
                    pos += 1
                    if n > 128:                     # run
                        rgbe[y, x:x + n - 128, c] = data[pos]
                        pos += 1
                        x += n - 128
                    else:                           # literal
                        rgbe[y, x:x + n, c] = np.frombuffer(
                            data, np.uint8, n, pos)
                        pos += n
                        x += n
        else:                                       # flat scanline
            row = np.frombuffer(data, np.uint8, width * 4, pos)
            rgbe[y] = row.reshape(width, 4)
            pos += width * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 as flat (non-RLE) Radiance HDR."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    _, e = np.frexp(maxc[nz])
    exp[nz] = e
    scale = np.zeros((h, w), np.float32)
    scale[nz] = np.ldexp(1.0, 8 - exp[nz])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
