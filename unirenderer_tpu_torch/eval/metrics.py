"""Quality metrics (counterpart of `unirenderer_tpu/eval/metrics.py`),
numpy only: PSNR and MSE, the segmentation confusion matrix (`SegMetric`),
depth errors (`DepthMetric`), the normal angle (`NormalMetric`), the
Frechet distance and FID over a pluggable feature function (the
InceptionV3 trunk is `eval/inception.py`), and the masked per-image mean
the harness's metallic/roughness error reads (`tools/eval_quality.py`
`_masked_mean`)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def psnr(img, ref, data_range: float = 1.0) -> float:
    """10 log10(range^2 / MSE) in float64; inf when equal."""
    mse = float(np.mean((np.asarray(img, np.float64)
                         - np.asarray(ref, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def mse(img, ref) -> float:
    return float(np.mean((np.asarray(img) - np.asarray(ref)) ** 2))


class SegMetric:
    """Streaming confusion matrix -> pixel accuracy, mIoU, fwIoU."""

    def __init__(self, num_classes: int):
        self.n = num_classes
        self.confusion = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred, label) -> None:
        pred = np.asarray(pred).reshape(-1)
        label = np.asarray(label).reshape(-1)
        valid = (label >= 0) & (label < self.n)
        idx = self.n * label[valid].astype(np.int64) + pred[valid]
        self.confusion += np.bincount(
            idx, minlength=self.n ** 2).reshape(self.n, self.n)

    def pixel_accuracy(self) -> float:
        return float(np.diag(self.confusion).sum()
                     / max(self.confusion.sum(), 1))

    def _iou(self) -> Tuple[np.ndarray, np.ndarray]:
        """(IoU per class, union per class)."""
        inter = np.diag(self.confusion).astype(np.float64)
        union = self.confusion.sum(1) + self.confusion.sum(0) - inter
        return inter / np.maximum(union, 1), union

    def miou(self) -> float:
        iou, union = self._iou()
        return float(iou[union > 0].mean())

    def fw_iou(self) -> float:
        iou, _ = self._iou()
        freq = self.confusion.sum(1) / max(self.confusion.sum(), 1)
        return float((freq[freq > 0] * iou[freq > 0]).sum())


class DepthMetric:
    """Per-update abs-rel, RMSE and the 1.25 / 1.25^2 / 1.25^3 ratio
    shares over valid (gt > 1e-8, optionally masked) pixels; `summary`
    averages the updates."""

    def __init__(self):
        self.records = []

    def update(self, pred, gt, mask: Optional[np.ndarray] = None) -> None:
        pred = np.asarray(pred, np.float64).reshape(-1)
        gt = np.asarray(gt, np.float64).reshape(-1)
        if mask is not None:
            m = np.asarray(mask).reshape(-1) > 0
            pred, gt = pred[m], gt[m]
        valid = gt > 1e-8
        pred, gt = pred[valid], gt[valid]
        if len(gt) == 0:
            return
        abs_rel = np.mean(np.abs(pred - gt) / gt)
        rmse = np.sqrt(np.mean((pred - gt) ** 2))
        ratio = np.maximum(pred / gt, gt / np.maximum(pred, 1e-8))
        self.records.append((abs_rel, rmse, np.mean(ratio < 1.25),
                             np.mean(ratio < 1.25 ** 2),
                             np.mean(ratio < 1.25 ** 3)))

    def summary(self):
        a = np.asarray(self.records).mean(0)
        return dict(abs_rel=float(a[0]), rmse=float(a[1]),
                    delta1=float(a[2]), delta2=float(a[3]),
                    delta3=float(a[4]))


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


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Square root of a (near-)PSD symmetric matrix by eigh, negative
    eigenvalues clipped to 0."""
    mat = (mat + mat.T) / 2
    w, v = np.linalg.eigh(mat)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with sqrt(S1 S2)'s
    trace from sqrt(S1^1/2 S2 S1^1/2)."""
    diff = mu1 - mu2
    s1h = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1h @ sigma2 @ s1h)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


class FIDComputer:
    """Streaming features of a feature function; `stats` gives their mean
    and covariance (float64) for `frechet_distance`."""

    def __init__(self, feature_fn: Callable[[np.ndarray], np.ndarray]):
        self.feature_fn = feature_fn
        self._feats = []

    def update(self, images) -> None:
        """images (B, H, W, 3) in [0, 1]."""
        self._feats.append(np.asarray(self.feature_fn(images)))

    def stats(self) -> Tuple[np.ndarray, np.ndarray]:
        f = np.concatenate(self._feats, axis=0).astype(np.float64)
        return f.mean(0), np.cov(f, rowvar=False)


def fid(images_a, images_b,
        feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """FID between two image sets (B, H, W, 3) in [0, 1]."""
    ca, cb = FIDComputer(feature_fn), FIDComputer(feature_fn)
    ca.update(images_a)
    cb.update(images_b)
    return frechet_distance(*ca.stats(), *cb.stats())
