"""Image metrics (counterpart of `unirenderer_tpu/eval/metrics.py`): the
pixel PSNR, the normal-angle metric, and the masked per-image mean the
harness's metallic/roughness error reads (`tools/eval_quality.py`
`_masked_mean`).  numpy only."""

from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(img, ref, data_range: float = 1.0) -> float:
    """10 log10(range^2 / MSE) in float64; inf when equal."""
    mse = float(np.mean((np.asarray(img, np.float64)
                         - np.asarray(ref, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


class NormalMetric:
    """Angle error between normal maps (normalised per pixel): mean,
    median, rmse and the shares under 11.25 / 22.5 / 30 degrees, over
    every pixel of every `update`, optionally inside a mask."""

    def __init__(self):
        self.angles = []

    def update(self, pred, gt, mask: Optional[np.ndarray] = None) -> None:
        pred = np.asarray(pred, np.float64).reshape(-1, 3)
        gt = np.asarray(gt, np.float64).reshape(-1, 3)
        if mask is not None:
            m = np.asarray(mask).reshape(-1) > 0
            pred, gt = pred[m], gt[m]
        pn = pred / np.maximum(np.linalg.norm(pred, axis=-1, keepdims=True),
                               1e-8)
        gn = gt / np.maximum(np.linalg.norm(gt, axis=-1, keepdims=True),
                             1e-8)
        cos = np.clip((pn * gn).sum(-1), -1.0, 1.0)
        self.angles.append(np.degrees(np.arccos(cos)))

    def summary(self):
        a = np.concatenate(self.angles)
        return dict(mean=float(a.mean()), median=float(np.median(a)),
                    rmse=float(np.sqrt((a ** 2).mean())),
                    a1=float((a < 11.25).mean()),
                    a2=float((a < 22.5).mean()),
                    a3=float((a < 30.0).mean()))


def masked_mean(maps, mask01) -> np.ndarray:
    """Per-image mean of `maps` (B, H, W) over the object mask (B, Hm, Wm),
    the mask nearest-resampled (index i * Hm // H) where the sizes
    differ."""
    maps = np.asarray(maps)
    mask01 = np.asarray(mask01)
    b, h, w = maps.shape
    if mask01.shape[1:] != (h, w):
        yi = np.arange(h) * mask01.shape[1] // h
        xi = np.arange(w) * mask01.shape[2] // w
        mask01 = mask01[:, yi][:, :, xi]
    m = mask01.astype(np.float32)
    return (maps * m).sum(axis=(1, 2)) / np.maximum(m.sum(axis=(1, 2)), 1e-6)
