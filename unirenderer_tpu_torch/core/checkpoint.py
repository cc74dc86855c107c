"""A numpy-only reader and writer of the JAX package's params-only `.npz`
exports.

Counterparts of `unirenderer_tpu/core/checkpoint.py` `load_params_npz` and
`save_params_npz`, but flat: they take and return the flax paths joined
with `/` (the file's keys), which is what `core/convert.py` maps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def load_params_npz(path: str) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """-> ({flax path: array, float leaves as f32}, step or None)."""
    flat: Dict[str, np.ndarray] = {}
    step = None
    with np.load(path) as z:
        for key in z.files:
            if key == "__step__":
                s = int(z[key])
                step = None if s < 0 else s
                continue
            arr = z[key]
            flat[key] = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
    return flat, step


def save_params_npz(path: str, flat: Dict[str, np.ndarray],
                    step: Optional[int] = None) -> None:
    """Write {flax path: array} as one compressed npz in the JAX format:
    float leaves stored as f16 (the JAX writer's default), others as they
    are, and the step under `__step__` (-1 for none), so the JAX package's
    `load_params_npz` reads it."""
    out = {}
    for key, arr in flat.items():
        a = np.asarray(arr)
        out[key] = a.astype(np.float16) if a.dtype.kind == "f" else a
    np.savez_compressed(path, __step__=np.int64(-1 if step is None
                                                 else step), **out)
