"""Object masks for the real-image inverse path (the port's numpy/scipy
copy of `unirenderer_tpu/eval/segmentation.py`: the same heuristics, seeds
and sampling caps, so the same image gives the same mask bits).

The reference drives SAM2 in-process from point/box prompts
(eval/test_real.py:520-533, eval/test_app.py:169-192).  SAM2 is a large
external torch stack; here segmentation is pluggable behind ONE contract,
so any segmenter (SAM2 included) slots in without code changes.

MASK FILE CONTRACT
------------------
A mask is a single-object foreground map aligned with the input image:
  * `.png` (any mode): pixel > 127 in the first channel = object, or
  * `.npy`: array (H, W) / (H, W, 1) / (H, W, 3), value > 0.5 = object.
It is resized (nearest) to the working resolution and binarized.

Producing a compatible mask WITH SAM2 (run in any torch environment,
mirrors reference test_real.py:520-533):

    python - <<'PY'
    import numpy as np, torch
    from PIL import Image
    from sam2.build_sam import build_sam2
    from sam2.sam2_image_predictor import SAM2ImagePredictor
    img = np.asarray(Image.open("input.png").convert("RGB"))
    pred = SAM2ImagePredictor(build_sam2(
        "configs/sam2.1/sam2.1_hiera_l.yaml", "sam2.1_hiera_large.pt"))
    pred.set_image(img)
    # center-point prompt (reference default) or box=np.array([x0,y0,x1,y1])
    h, w = img.shape[:2]
    masks, scores, _ = pred.predict(
        point_coords=np.array([[w // 2, h // 2]]),
        point_labels=np.array([1]), multimask_output=False)
    Image.fromarray((masks[0] * 255).astype(np.uint8)).save("mask.png")
    PY

then pass `--mask mask.png` to the CLI / upload it in the app.

When no external mask is supplied, two built-in heuristics cover renders
and simple photos: `auto_mask` (non-white-background) and
`box_prompt_mask` (color-model segmentation inside a 2-click box, the
app's box-prompt flow without the SAM2 dependency).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def auto_mask(img01: np.ndarray, thresh: float = 0.95) -> np.ndarray:
    """Heuristic object mask: non-white-background pixels (works for the
    white-composited renders of the training distribution)."""
    bg = (img01 > thresh).all(axis=-1)
    mask = (~bg).astype(np.float32)
    return mask[..., None].repeat(3, -1)


def _fit_gmm(px: np.ndarray, k: int, iters: int = 8,
             seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tiny diagonal-covariance color GMM (numpy EM).  Returns
    (weights (k,), means (k,3), vars (k,3))."""
    rng = np.random.RandomState(seed)
    n = px.shape[0]
    k = min(k, n)
    # k-means++-lite init: spread the first centers over the data
    means = px[rng.choice(n, size=k, replace=False)].astype(np.float64)
    var = np.full((k, 3), max(px.var(), 1e-4), np.float64)
    w = np.full((k,), 1.0 / k)
    x = px.astype(np.float64)
    for _ in range(iters):
        # E: responsibilities under diagonal gaussians
        d2 = ((x[:, None, :] - means[None]) ** 2 / var[None]).sum(-1)
        logp = (np.log(w + 1e-12)[None]
                - 0.5 * (d2 + np.log(var).sum(-1)[None]))
        logp -= logp.max(axis=1, keepdims=True)
        r = np.exp(logp)
        r /= r.sum(axis=1, keepdims=True)
        # M
        nk = r.sum(0) + 1e-8
        w = nk / n
        means = (r.T @ x) / nk[:, None]
        var = (r.T @ (x ** 2)) / nk[:, None] - means ** 2
        var = np.maximum(var, 1e-4)
    return w, means, var


def _gmm_loglik(px: np.ndarray, gmm) -> np.ndarray:
    w, means, var = gmm
    x = px.astype(np.float64)
    d2 = ((x[:, None, :] - means[None]) ** 2 / var[None]).sum(-1)
    logp = (np.log(w + 1e-12)[None]
            - 0.5 * (d2 + np.log(var).sum(-1)[None]))
    m = logp.max(axis=1)
    return m + np.log(np.exp(logp - m[:, None]).sum(axis=1))


def _sample(img01: np.ndarray, mask2d: np.ndarray, cap: int = 4000,
            seed: int = 0) -> np.ndarray:
    """The pixels under `mask2d`, at most `cap` of them drawn without
    replacement (the model fit's subsample at large resolutions)."""
    px = img01[mask2d].reshape(-1, 3)
    if px.shape[0] > cap:
        idx = np.random.RandomState(seed).choice(
            px.shape[0], cap, replace=False)
        px = px[idx]
    return px


def box_prompt_mask(img01: np.ndarray, box: Sequence[int],
                    bg_quantile: float = 0.6,  # kept for API compat
                    k: int = 5, gc_iters: int = 4) -> np.ndarray:
    """Segment the object inside a user box (x0, y0, x1, y1) — the app's
    2-click flow (reference test_app.py:169-192) without SAM2.

    GrabCut-style iterated color modelling (numpy-only): foreground and
    background are each a k-component diagonal GMM (background seeded
    from pixels OUTSIDE the box — the hard constraint, as in GrabCut);
    pixels inside the box are re-labelled by likelihood ratio each round
    and the models are refit.  An edge-aware local vote stands in for the
    graph-cut pairwise term, then the connected component containing the
    box centre is kept.  Beats the single-Gaussian background model on
    multi-coloured real-photo backgrounds; still short of SAM2 — supply
    an external mask (MASK FILE CONTRACT above) for hard cases.
    Returns (H, W, 3) float mask in {0, 1}.
    """
    from scipy import ndimage

    h, w = img01.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in box)
    x0, x1 = max(0, min(x0, x1)), min(w, max(x0, x1))
    y0, y1 = max(0, min(y0, y1)), min(h, max(y0, y1))
    if x1 - x0 < 2 or y1 - y0 < 2:
        return auto_mask(img01)

    outside = np.ones((h, w), bool)
    outside[y0:y1, x0:x1] = False
    if not outside.any():                    # box covers the whole image
        return auto_mask(img01)

    inside = ~outside
    fg = inside.copy()                       # init: whole box is FG
    flat = img01.reshape(-1, 3)
    in_flat = inside.reshape(-1)
    for it in range(gc_iters):
        bg_px = _sample(img01, outside | (inside & ~fg), seed=it)
        fg_px = _sample(img01, fg, seed=100 + it)
        if fg_px.shape[0] < k or bg_px.shape[0] < k:
            break
        gmm_bg = _fit_gmm(bg_px, k, seed=it)
        gmm_fg = _fit_gmm(fg_px, k, seed=100 + it)
        ratio = np.full(flat.shape[0], -1e9)
        ratio[in_flat] = (_gmm_loglik(flat[in_flat], gmm_fg)
                          - _gmm_loglik(flat[in_flat], gmm_bg))
        ratio = ratio.reshape(h, w)
        # pairwise stand-in: average the FG score over an edge-aware
        # neighbourhood (smooth regions vote together, edges separate)
        score = np.clip(ratio, -20, 20)
        grad = np.linalg.norm(np.gradient(img01.mean(-1)), axis=0)
        blend = np.exp(-(grad / max(grad.mean(), 1e-4)) ** 2)
        sm = ndimage.uniform_filter(score, size=5)
        score = blend * sm + (1 - blend) * score
        new_fg = inside & (score > 0)
        if (new_fg == fg).all():
            fg = new_fg
            break
        fg = new_fg
        if not fg.any():
            break

    lab, n = ndimage.label(fg)
    if n:
        cy, cx = (y0 + y1) // 2, (x0 + x1) // 2
        keep = lab[cy, cx]
        if keep == 0:                        # center not fg: largest blob
            keep = 1 + np.bincount(lab[lab > 0]).argmax()
        fg = lab == keep
        fg = ndimage.binary_closing(fg, np.ones((3, 3)))
        fg = ndimage.binary_fill_holes(fg)
    mask = fg.astype(np.float32)
    return mask[..., None].repeat(3, -1)


def point_prompt_mask(img01: np.ndarray, points: Sequence[int],
                      k: int = 5, gc_iters: int = 4,
                      seed_frac: float = 0.04,
                      spatial_weight: float = 4.0) -> np.ndarray:
    """Segment the object under user CLICKS — the reference app's SAM2
    point-prompt flow (test_app.py:169-192, test_real.py:520-533) without
    the SAM2 dependency.

    `points` is a flat sequence x0,y0[,x1,y1,...]; positive coordinates
    are positive clicks (object), a coordinate pair given as NEGATIVE
    values (-x,-y) is a background click.  Same iterated-GMM machinery as
    `box_prompt_mask`, with point-derived hard seeds: FG = disks around
    positive clicks, BG = image border + disks around negative clicks,
    plus a mild distance-from-click prior (clicks are local statements in
    a way a box is not).  The connected component containing the first
    positive click is returned.  Returns (H, W, 3) float mask in {0, 1}.
    """
    from scipy import ndimage

    h, w = img01.shape[:2]
    pts = [int(v) for v in points]
    assert len(pts) >= 2 and len(pts) % 2 == 0, "need x,y[,x,y...]"
    pos = [(abs(pts[i]), abs(pts[i + 1]))
           for i in range(0, len(pts), 2)
           if pts[i] >= 0 and pts[i + 1] >= 0]
    neg = [(abs(pts[i]), abs(pts[i + 1]))
           for i in range(0, len(pts), 2)
           if pts[i] < 0 or pts[i + 1] < 0]
    if not pos:
        return auto_mask(img01)
    pos = [(min(w - 1, x), min(h - 1, y)) for x, y in pos]

    r = max(2, int(seed_frac * min(h, w)))
    yy, xx = np.mgrid[0:h, 0:w]
    fg_seed = np.zeros((h, w), bool)
    for x, y in pos:
        fg_seed |= (xx - x) ** 2 + (yy - y) ** 2 <= r * r
    bg_seed = np.zeros((h, w), bool)
    b = max(1, min(h, w) // 50)              # border ring
    bg_seed[:b, :] = bg_seed[-b:, :] = True
    bg_seed[:, :b] = bg_seed[:, -b:] = True
    for x, y in neg:
        bg_seed |= (xx - x) ** 2 + (yy - y) ** 2 <= r * r
    bg_seed &= ~fg_seed

    # distance-from-nearest-positive-click prior, 0 at the click,
    # `spatial_weight` logits at the farthest image corner
    d2 = np.min(np.stack([(xx - x) ** 2.0 + (yy - y) ** 2 for x, y in pos]),
                axis=0)
    prior = spatial_weight * np.sqrt(d2) / np.sqrt(h * h + w * w)

    fg = fg_seed.copy()
    flat = img01.reshape(-1, 3)
    undecided = ~(fg_seed | bg_seed)
    for it in range(gc_iters):
        bg_px = _sample(img01, bg_seed | (undecided & ~fg), seed=it)
        fg_px = _sample(img01, fg | fg_seed, seed=100 + it)
        if fg_px.shape[0] < k or bg_px.shape[0] < k:
            break
        gmm_bg = _fit_gmm(bg_px, k, seed=it)
        gmm_fg = _fit_gmm(fg_px, k, seed=100 + it)
        ratio = (_gmm_loglik(flat, gmm_fg)
                 - _gmm_loglik(flat, gmm_bg)).reshape(h, w) - prior
        score = np.clip(ratio, -20, 20)
        grad = np.linalg.norm(np.gradient(img01.mean(-1)), axis=0)
        blend = np.exp(-(grad / max(grad.mean(), 1e-4)) ** 2)
        sm = ndimage.uniform_filter(score, size=5)
        score = blend * sm + (1 - blend) * score
        new_fg = (fg_seed | (score > 0)) & ~bg_seed
        if (new_fg == fg).all():
            fg = new_fg
            break
        fg = new_fg

    lab, n = ndimage.label(fg)
    if n:
        x0, y0 = pos[0]
        keep = lab[y0, x0]
        if keep == 0:
            keep = 1 + np.bincount(lab[lab > 0]).argmax()
        fg = lab == keep
        fg = ndimage.binary_closing(fg, np.ones((3, 3)))
        fg = ndimage.binary_fill_holes(fg)
    mask = fg.astype(np.float32)
    return mask[..., None].repeat(3, -1)


def load_mask(path: str, size: Optional[int] = None) -> np.ndarray:
    """Load an external mask per the MASK FILE CONTRACT above.

    Returns (H, W, 3) float in {0, 1}, resized to (size, size) if given.
    """
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 3:
            arr = arr[..., 0]
        m = (arr.astype(np.float32) > 0.5).astype(np.float32)
        if size is not None and m.shape != (size, size):
            from PIL import Image
            m = np.asarray(Image.fromarray(
                (m * 255).astype(np.uint8)).resize((size, size),
                                                   Image.NEAREST),
                           np.float32) / 255.0
            m = (m > 0.5).astype(np.float32)
    else:
        from PIL import Image
        with Image.open(path) as img:
            if size is not None:
                img = img.resize((size, size), Image.NEAREST)
            arr = np.asarray(img)
        if arr.ndim == 3:
            arr = arr[..., 0]
        m = (arr.astype(np.float32) > 127).astype(np.float32)
    return m[..., None].repeat(3, -1)
