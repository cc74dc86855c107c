"""Image metrics (counterpart of `unirenderer_tpu/eval/metrics.py`; the
pixel PSNR only, so far)."""

from __future__ import annotations

import numpy as np


def psnr(img, ref, data_range: float = 1.0) -> float:
    """10 log10(range^2 / MSE) in float64; inf when equal."""
    mse = float(np.mean((np.asarray(img, np.float64)
                         - np.asarray(ref, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))
