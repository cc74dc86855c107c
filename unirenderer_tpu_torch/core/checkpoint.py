"""A numpy-only reader of the JAX package's params-only `.npz` exports.

Counterpart of `unirenderer_tpu/core/checkpoint.py` `load_params_npz`,
but flat: it returns the flax paths joined with `/` (the keys
`save_params_npz` writes), which is what `core/convert.py` takes.
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
