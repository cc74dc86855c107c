"""K4: triangle rasterization, attribute interpolation and SSAA pooling.

Counterpart of `unirenderer_tpu/ops/rasterize.py` (`rasterize`,
`interpolate`, `ssaa_downsample`) and of its Pallas TPU kernel
`unirenderer_tpu/ops/rasterize_pallas.py` (`_make_kernel` via
`rasterize_pallas`).  Output follows nvdiffrast's convention: per pixel
(u, v, z_ndc, id + 1) with perspective-correct barycentrics, id 0 on a
miss, all four zero there.  Screen y points down; pixel centres are at
(x + 0.5, y + 0.5).

`rasterize` takes a batch of views at once: clip positions (B, V, 4) and
triangles (B, T, 3) (or one view, (V, 4) and (T, 3)).  On a CUDA tensor
the wrapper launches the hand-written kernels of `csrc/rasterize.cu` over
the batch (a memset and four kernels: the per-triangle set-up of `_setup`
with the count of each triangle's 16x16 tiles, a scan, the fill of the
tile lists, the raster) and raises on anything they do not take; on a
CPU tensor it runs `rasterize_reference`, the plain version, which the
card check also compares the kernel with.  The set-up (`_setup`: 9 edge
coefficients, twice the signed area, 3 z and 3 1/w, the screen bounding
box) is torch in the plain version and the set-up kernel's, bit for bit;
`rast_bins_reference` is the plain mirror of the kernels' tile lists.

Every pixel keeps the lexicographic minimum of (z, triangle index) over
the triangles that cover it (and, when peeling, lie beyond
`prev_z + 1e-6`).  A triangle covers a pixel when its three edge
functions have the sign of its area there and the pixel centre lies in
its screen box.  The box test matters only for near-degenerate slivers:
their f32 edge coefficients can define half-planes that all agree on
pixels many pixels away from the sliver, and the JAX rasterizers cover
such pixels wherever their tile culling lets the sliver through.  With
it, the result does not depend on how a version bins triangles.  Both versions evaluate the edge functions in float64
(rounded once to float32) and the barycentrics and z with the same f32
operations in the same order, one rounding each, so they agree bit for
bit.  A pixel centre exactly on an edge shared by two triangles is
covered by one of them (the lower index at equal z); the JAX rasterizers
leave some of those pixels empty, as their f32 matmul or FMA rounding
decides.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from unirenderer_tpu_torch.ops import _build

BIG = 1e30                 # depth of "no hit"
TILE = 16                  # csrc/rasterize.cu's tile side in pixels
MAX_BIN_TILES = 64         # a triangle on more tiles goes to its view's
                           # wide list: the tile lists hold <= 64 a triangle
# (pixels x triangles) evaluated at once by the plain version
_REFERENCE_BLOCK = 1 << 22


class RastBins(NamedTuple):
    """The tile lists of a batch of views: the triangles whose screen box
    holds a pixel centre of the tile, for those on at most MAX_BIN_TILES
    tiles; the others ("wide") in one list per view, which every tile of
    the view walks."""
    start: torch.Tensor       # (B * n_tiles + 1,) int32 list offsets
    pairs: torch.Tensor       # (start[-1],) int32 triangle indices
    wide_count: torch.Tensor  # (B,) int32
    wide: torch.Tensor        # (B, T) int32, the first wide_count[b] used


class RastOutput(NamedTuple):
    """Per-pixel hit info, each (B, H, W) (or (H, W) for one view)."""
    bary_u: torch.Tensor     # perspective-correct barycentric of vertex 0
    bary_v: torch.Tensor     # of vertex 1
    z: torch.Tensor          # NDC depth (z/w) of the hit, 0 on a miss
    tri_id: torch.Tensor     # int32, 0 = miss, else triangle index + 1


def _setup(pos_clip: torch.Tensor, tri: torch.Tensor, height: int,
           width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-triangle records (B, T, 16) = (a0, b0, c0, a1, b1, c1, a2, b2,
    c2, area, z0, z1, z2, 1/w0, 1/w1, 1/w2), edge k being E_k(p) =
    a_k px + b_k py + c_k opposite vertex k, and screen boxes (B, T, 4) =
    (xmin, xmax, ymin, ymax).  A triangle with a vertex behind the eye,
    a repeated index or |area| <= 1e-12 gets area 0 and the empty box
    (+inf, -inf, +inf, -inf)."""
    b, t = tri.shape[:2]
    w_clip = pos_clip[..., 3]
    w_safe = torch.where(w_clip.abs() < 1e-9,
                         torch.where(w_clip < 0, -1e-9, 1e-9), w_clip)
    inv_w = 1.0 / w_safe
    sx = (pos_clip[..., 0] * inv_w * 0.5 + 0.5) * width
    sy = (pos_clip[..., 1] * inv_w * 0.5 + 0.5) * height
    sz = pos_clip[..., 2] * inv_w
    behind = w_clip <= 1e-9

    idx = tri.long().reshape(b, t * 3)

    def corners(per_vertex):
        return torch.gather(per_vertex, 1, idx).reshape(b, t, 3)

    tx, ty, tz, tw = corners(sx), corners(sy), corners(sz), corners(inv_w)
    i0, i1, i2 = tri[..., 0], tri[..., 1], tri[..., 2]
    bad = (corners(behind.to(torch.uint8)).amax(-1).bool()
           | (i0 == i1) | (i1 == i2) | (i0 == i2))

    x0, x1, x2 = tx.unbind(-1)
    y0, y1, y2 = ty.unbind(-1)

    def edge(ax, ay, bx, by):
        return ay - by, bx - ax, ax * by - ay * bx

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    area = a2 * x2 + b2 * y2 + c2
    area = torch.where(bad | (area.abs() <= 1e-12), 0.0, area)
    rec = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, area,
                       tz[..., 0], tz[..., 1], tz[..., 2],
                       tw[..., 0], tw[..., 1], tw[..., 2]], dim=-1)
    empty = (area == 0)[..., None]
    inf = float("inf")
    box = torch.stack([tx.amin(-1), tx.amax(-1), ty.amin(-1), ty.amax(-1)],
                      dim=-1)
    box = torch.where(empty, torch.tensor([inf, -inf, inf, -inf],
                                          device=box.device), box)
    return rec.contiguous(), box.contiguous()


def _chunk_boxes(box: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, T, 4) triangle boxes -> (B, ceil(T / chunk), 4) chunk boxes."""
    b, t = box.shape[:2]
    pad = (-t) % chunk
    if pad:
        inf = float("inf")
        empty = torch.tensor([inf, -inf, inf, -inf], device=box.device)
        box = torch.cat([box, empty.expand(b, pad, 4)], dim=1)
    box = box.reshape(b, -1, chunk, 4)
    return torch.stack([box[..., 0].amin(-1), box[..., 1].amax(-1),
                        box[..., 2].amin(-1), box[..., 3].amax(-1)], dim=-1)


def pixel_ranges(box: torch.Tensor, height: int, width: int):
    """(B, T, 4) screen boxes -> the first and last pixel column and row
    (xl, xh, yl, yh), each (B, T) float64, whose centres (x + 0.5,
    y + 0.5) the box holds, clamped to the image, and whether there is any
    such pixel.  x + 0.5 >= xmin iff x >= ceil(xmin - 0.5), exact in
    float64 for an f32 xmin."""
    bd = box.double()
    xl = torch.ceil(bd[..., 0] - 0.5).clamp(min=0)
    xh = torch.floor(bd[..., 1] - 0.5).clamp(max=width - 1)
    yl = torch.ceil(bd[..., 2] - 0.5).clamp(min=0)
    yh = torch.floor(bd[..., 3] - 0.5).clamp(max=height - 1)
    ok = ((box[..., 0] <= box[..., 1]) & (box[..., 2] <= box[..., 3])
          & (xl <= xh) & (yl <= yh))
    return xl, xh, yl, yh, ok


def tile_ranges(box: torch.Tensor, height: int, width: int):
    """(B, T, 4) screen boxes -> per triangle the first and last tile
    column and row (tx0, tx1, ty0, ty1) whose pixel centres the box holds
    (`pixel_ranges`), each (B, T) int64, and the number of such tiles (0
    for an empty box)."""
    *ranges, ok = pixel_ranges(box, height, width)
    tx0, tx1, ty0, ty1 = (torch.where(ok, v, 0).long() // TILE
                          for v in ranges)
    n = torch.where(ok, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    return tx0, tx1, ty0, ty1, n


def rast_bins_reference(box: torch.Tensor, height: int,
                        width: int) -> RastBins:
    """Plain mirror of the kernels' count / scan / fill: the tile lists of
    (B, T, 4) screen boxes, each list in increasing triangle index (the
    kernels' order depends on their atomics), the wide lists likewise, -1
    past each view's count."""
    nb, t = box.shape[:2]
    n_tx, n_ty = -(-width // TILE), -(-height // TILE)
    tx0, tx1, ty0, ty1, n = tile_ranges(box, height, width)
    binned = (n > 0) & (n <= MAX_BIN_TILES)
    wide_mask = n > MAX_BIN_TILES
    b_idx, t_idx = binned.nonzero(as_tuple=True)
    reps = n[b_idx, t_idx]
    b_rep = b_idx.repeat_interleave(reps)
    t_rep = t_idx.repeat_interleave(reps)
    # the k-th tile of a triangle's range, row by row
    k = torch.arange(int(reps.sum()), device=box.device) - (
        torch.cumsum(reps, 0) - reps).repeat_interleave(reps)
    cols = (tx1 - tx0 + 1)[b_rep, t_rep]
    tile = ((ty0[b_rep, t_rep] + k // cols) * n_tx
            + tx0[b_rep, t_rep] + k % cols + b_rep * (n_tx * n_ty))
    order = torch.argsort(tile * t + t_rep)
    counts = torch.bincount(tile, minlength=nb * n_tx * n_ty)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    wide = torch.full((nb, t), -1, dtype=torch.int32, device=box.device)
    wide_count = wide_mask.sum(1).to(torch.int32)
    for bi in range(nb):
        idx = wide_mask[bi].nonzero()[:, 0]
        wide[bi, :idx.numel()] = idx.to(torch.int32)
    return RastBins(start.to(torch.int32), t_rep[order].to(torch.int32),
                    wide_count, wide)


def rasterize_reference(pos_clip: torch.Tensor, tri: torch.Tensor,
                        height: int, width: int, chunk: int = 256,
                        prev_z: Optional[torch.Tensor] = None) -> RastOutput:
    """Plain version over (B, V, 4) / (B, T, 3): per view, per chunk of
    `chunk` triangles, every triangle evaluated densely over the pixel
    rectangle of the chunk's box (one pixel of margin, clamped to the
    image), in row blocks of at most `_REFERENCE_BLOCK` pixel-triangle
    pairs."""
    nb, t = tri.shape[:2]
    dev = pos_clip.device
    rec, box = _setup(pos_clip, tri, height, width)
    cbox = _chunk_boxes(box, chunk).cpu()
    best_z = torch.full((nb, height, width), BIG, device=dev)
    best_u = torch.zeros((nb, height, width), device=dev)
    best_v = torch.zeros((nb, height, width), device=dev)
    best_id = torch.zeros((nb, height, width), dtype=torch.int32,
                          device=dev)
    for bi in range(nb):
        for ci in range(cbox.shape[1]):
            xmin, xmax, ymin, ymax = cbox[bi, ci].tolist()
            if not xmin <= xmax:                  # no live triangle
                continue
            xa = max(int(xmin) - 2, 0)
            xb = min(int(xmax) + 2, width)
            ya = max(int(ymin) - 2, 0)
            yb = min(int(ymax) + 2, height)
            if xa >= xb or ya >= yb:
                continue
            r = rec[bi, ci * chunk:(ci + 1) * chunk]
            bx = box[bi, ci * chunk:(ci + 1) * chunk]
            rows = max(1, _REFERENCE_BLOCK // ((xb - xa) * r.shape[0]))
            for y in range(ya, yb, rows):
                y_end = min(y + rows, yb)
                _reference_block(
                    r, bx, ci * chunk, y, y_end, xa, xb,
                    None if prev_z is None else prev_z[bi, y:y_end, xa:xb],
                    best_z[bi], best_u[bi], best_v[bi], best_id[bi])
    best_z = torch.where(best_id == 0, 0.0, best_z)
    return RastOutput(best_u, best_v, best_z, best_id)


def _edge(px, py, a, b, c):
    """E(p) = a px + b py + c in float64, rounded once to float32: the
    products of f32 values are exact in f64, so the cancellation near an
    edge costs no accuracy (an f32 evaluation loses ~1e-5 of a barycentric
    there)."""
    return ((px.double() * a.double() + py.double() * b.double())
            + c.double()).float()


def _reference_block(r, bx, first, ya, yb, xa, xb, pz, best_z, best_u,
                     best_v, best_id):
    """Evaluate the triangles `r` (C, 16) with boxes `bx` (C, 4) over
    pixels [ya, yb) x [xa, xb) and fold the lexicographic (z, index)
    minimum into the best-so-far images (H, W) in place."""
    dev = r.device
    py = (torch.arange(ya, yb, device=dev, dtype=torch.float32)
          + 0.5)[:, None, None]
    px = (torch.arange(xa, xb, device=dev, dtype=torch.float32)
          + 0.5)[None, :, None]
    (a0, b0, c0, a1, b1, c1, a2, b2, c2, ar,
     z0, z1, z2, w0, w1, w2) = r.unbind(-1)
    e0 = _edge(px, py, a0, b0, c0)               # (rows, cols, C)
    e1 = _edge(px, py, a1, b1, c1)
    e2 = _edge(px, py, a2, b2, c2)
    inside = ((((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (ar > 0))
               | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0) & (ar < 0)))
              & (px >= bx[:, 0]) & (px <= bx[:, 1])
              & (py >= bx[:, 2]) & (py <= bx[:, 3]))
    ar_safe = torch.where(ar == 0, 1.0, ar)
    su = e0 / ar_safe
    sv = e1 / ar_safe
    sw = 1.0 - su - sv
    denom = su * w0 + sv * w1 + sw * w2
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    pu = su * w0 / denom
    pv = sv * w1 / denom
    pw = 1.0 - pu - pv
    zhit = pu * z0 + pv * z1 + pw * z2
    zcand = torch.where(inside, zhit, BIG)
    if pz is not None:
        zcand = torch.where(zcand > (pz + 1e-6)[..., None], zcand, BIG)
    zmin = zcand.amin(-1, keepdim=True)
    lane = torch.arange(r.shape[0], device=dev)
    kmin = torch.where(zcand == zmin, lane, r.shape[0]).amin(
        -1, keepdim=True)                        # lowest index at the min
    u_sel = torch.gather(pu, -1, kmin)[..., 0]
    v_sel = torch.gather(pv, -1, kmin)[..., 0]
    zmin, kmin = zmin[..., 0], kmin[..., 0]
    old_z = best_z[ya:yb, xa:xb]
    better = zmin < old_z
    best_z[ya:yb, xa:xb] = torch.where(better, zmin, old_z)
    best_u[ya:yb, xa:xb] = torch.where(better, u_sel, best_u[ya:yb, xa:xb])
    best_v[ya:yb, xa:xb] = torch.where(better, v_sel, best_v[ya:yb, xa:xb])
    best_id[ya:yb, xa:xb] = torch.where(
        better, (kmin + first + 1).to(torch.int32), best_id[ya:yb, xa:xb])


def _lib() -> ctypes.CDLL:
    lib = _build.load("rasterize")
    if lib.rast_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rast_forward.argtypes = [p, p, i, p, i, i, i, i, i, i] + [p] * 9
        lib.rast_forward.restype = ctypes.c_int
    return lib


def _launch(pos_clip: torch.Tensor, tri: torch.Tensor, height: int,
            width: int, prev_z: Optional[torch.Tensor]):
    """The kernels -> (RastOutput, the set-up's records (B, T, 16) and
    boxes (B, T, 4), RastBins with `pairs` at its full size)."""
    dev = pos_clip.device
    if pos_clip.dtype != torch.float32:
        raise TypeError(f"rasterize kernel takes float32 clip positions, "
                        f"got {pos_clip.dtype}")
    if tri.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"rasterize kernel takes integer triangles, got "
                        f"{tri.dtype}")
    if tri.device != dev:
        raise ValueError("triangles must be on the clip positions' device")
    nb, nv = pos_clip.shape[:2]
    t = tri.shape[1]
    n_tiles = -(-width // TILE) * -(-height // TILE)
    if height <= 0 or width <= 0 or nb == 0 or nb > 65535 or nv == 0:
        raise ValueError(f"rasterize kernel needs H, W, V > 0 and "
                         f"0 < B <= 65535, got B={nb} V={nv} H={height} "
                         f"W={width}")
    if (nb * t * MAX_BIN_TILES >= 2 ** 31 or nb * height * width >= 2 ** 31
            or nb * n_tiles + nb >= 2 ** 31):
        raise ValueError("rasterize kernel: too many triangles or pixels "
                         "for 32-bit indexing")
    if pos_clip.data_ptr() % 16:
        raise ValueError("rasterize kernel needs 16-byte aligned clip "
                         "positions")
    if prev_z is not None:
        if (prev_z.shape != (nb, height, width)
                or prev_z.dtype != torch.float32 or prev_z.device != dev
                or not prev_z.is_contiguous()):
            raise ValueError(f"prev_z must be a contiguous float32 "
                             f"({nb}, {height}, {width}) tensor on {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    rec = torch.empty((nb, t, 16), **f32)
    box = torch.empty((nb, t, 4), **f32)
    ints = torch.empty(2 * nb * n_tiles + nb + 1 + nb * t * (MAX_BIN_TILES
                                                             + 1),
                       dtype=torch.int32, device=dev)
    counts, start, pairs, wide = ints.split(
        [nb * n_tiles + nb, nb * n_tiles + 1, nb * t * MAX_BIN_TILES,
         nb * t])
    uvz = torch.empty((3, nb, height, width), **f32)
    tri_id = torch.empty((nb, height, width), dtype=torch.int32, device=dev)
    rc = _lib().rast_forward(
        pos_clip.data_ptr(), tri.data_ptr(), int(tri.dtype == torch.int64),
        None if prev_z is None else prev_z.data_ptr(), nb, nv, t, height,
        width, MAX_BIN_TILES, rec.data_ptr(), box.data_ptr(), counts.data_ptr(),
        start.data_ptr(), pairs.data_ptr(), wide.data_ptr(), uvz.data_ptr(),
        tri_id.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize kernel launch failed: CUDA error {rc}")
    rasterize.launches += 1
    return (RastOutput(uvz[0], uvz[1], uvz[2], tri_id), rec, box,
            RastBins(start, pairs, counts[nb * n_tiles:], wide.view(nb, t)))


def rasterize_with_bins(pos_clip: torch.Tensor, tri: torch.Tensor,
                        height: int, width: int,
                        prev_z: Optional[torch.Tensor] = None):
    """The kernels on (B, V, 4) / (B, T, 3) CUDA tensors -> (RastOutput,
    the set-up kernel's records (B, T, 16) and boxes (B, T, 4), RastBins
    as the kernels left them: each tile's list in the order its atomics
    gave, `pairs` cut to the total), for holding the set-up and the
    binning against `_setup` and `rast_bins_reference`.  One launch of
    the wrapper (`rasterize.launches`)."""
    if pos_clip.device.type != "cuda":
        raise ValueError("rasterize_with_bins runs the kernels: it needs "
                         "CUDA tensors")
    out, rec, box, bins = _launch(pos_clip.contiguous(), tri.contiguous(),
                                  height, width, prev_z)
    total = int(bins.start[-1].item())
    return out, rec, box, bins._replace(pairs=bins.pairs[:total])


def rasterize(pos_clip: torch.Tensor, tri: torch.Tensor, height: int,
              width: int, chunk: int = 256,
              prev_z: Optional[torch.Tensor] = None) -> RastOutput:
    """Rasterize triangles into (height, width) images.

    pos_clip (B, V, 4) clip-space positions (x, y, z, w); tri (B, T, 3)
    vertex indices; prev_z optional (B, H, W) depth of the previous layer
    for peeling.  Unbatched (V, 4) / (T, 3) / (H, W) inputs give unbatched
    outputs.  `chunk` is the plain version's triangle chunk; it does not
    change the result.  The kernel on a CUDA tensor, the plain version on
    a CPU one."""
    single = pos_clip.dim() == 2
    if single:
        pos_clip, tri = pos_clip[None], tri[None]
        prev_z = None if prev_z is None else prev_z[None]
    if pos_clip.shape[0] != tri.shape[0] or pos_clip.shape[-1] != 4 \
            or tri.shape[-1] != 3 or pos_clip.dim() != 3 or tri.dim() != 3:
        raise ValueError(f"need (B, V, 4) positions and (B, T, 3) "
                         f"triangles, got {tuple(pos_clip.shape)} and "
                         f"{tuple(tri.shape)}")
    pos_clip = pos_clip.contiguous()
    tri = tri.contiguous()
    rasterize.seen.add((tuple(pos_clip.shape), tuple(tri.shape), height,
                        width, prev_z is not None))
    if pos_clip.device.type == "cpu":
        out = rasterize_reference(pos_clip, tri, height, width, chunk,
                                  prev_z)
    elif pos_clip.device.type == "cuda":
        out = _launch(pos_clip, tri, height, width, prev_z)[0]
    else:
        raise ValueError(f"no rasterize kernel for device {pos_clip.device}")
    if single:
        out = RastOutput(*(x[0] for x in out))
    return out


# kernel launches so far (the CUDA branch only), and every
# (positions shape, triangles shape, H, W, peel) the wrapper was called with
rasterize.launches = 0
rasterize.seen = set()


def match_stats(got: RastOutput, want: RastOutput) -> dict:
    """How two rasterizations of the same input differ, in the terms of
    the comparison rule (`within_rule`): pixels whose coverage differs,
    max |z| difference, the share of pixels whose triangle differs (and
    how many of those are not hits on both sides), max |u|, |v|
    difference where the triangles agree, and whether all four images are
    bit-equal."""
    ia, ib = got.tri_id, want.tri_id
    agree = ia == ib
    uv_err = max(((got.bary_u - want.bary_u).abs()[agree].max().item()
                  if agree.any() else 0.0),
                 ((got.bary_v - want.bary_v).abs()[agree].max().item()
                  if agree.any() else 0.0))
    return dict(
        coverage_mismatch=int(((ia > 0) != (ib > 0)).sum().item()),
        z_err=(got.z - want.z).abs().max().item(),
        id_mismatch=1.0 - agree.float().mean().item(),
        id_mismatch_not_both_hit=int(
            (~agree & ((ia == 0) | (ib == 0))).sum().item()),
        uv_err=uv_err,
        bit_equal=all(torch.equal(a, b) for a, b in zip(got, want)))


def within_rule(stats: dict) -> bool:
    """Coverage equal, z within 1e-5, triangle ids different on < 2 % of
    pixels and only where both sides hit, u and v within 1e-5 where the
    ids agree."""
    return (stats["coverage_mismatch"] == 0 and stats["z_err"] <= 1e-5
            and stats["id_mismatch"] < 0.02
            and stats["id_mismatch_not_both_hit"] == 0
            and stats["uv_err"] <= 1e-5)


def interpolate(attr: torch.Tensor, rast: RastOutput,
                tri: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interpolate per-vertex attributes at the rasterized pixels.

    attr (B, V, A), tri (B, T, 3), rast of (B, H, W) (or all unbatched).
    Returns (image (B, H, W, A), mask (B, H, W, 1))."""
    single = attr.dim() == 2
    if single:
        attr, tri = attr[None], tri[None]
        rast = RastOutput(*(x[None] for x in rast))
    nb, nv, na = attr.shape
    tid = torch.clamp(rast.tri_id.long() - 1, min=0).reshape(nb, -1)
    off = (torch.arange(nb, device=attr.device) * nv)[:, None]
    table = attr.reshape(nb * nv, na)
    u, v = rast.bary_u, rast.bary_v
    w = 1.0 - u - v
    out = None
    for k, wk in enumerate((u, v, w)):
        vi = torch.gather(tri[..., k].long(), 1, tid) + off
        term = table[vi].reshape(u.shape + (na,)) * wk[..., None]
        out = term if out is None else out + term
    mask = (rast.tri_id > 0)[..., None]
    out = torch.where(mask, out, 0.0)
    mask = mask.to(attr.dtype)
    if single:
        out, mask = out[0], mask[0]
    return out, mask


def ssaa_downsample(img: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool a supersampled (..., H, W, C) render by `factor`."""
    h, w, c = img.shape[-3:]
    lead = img.shape[:-3]
    x = img.reshape(lead + (h // factor, factor, w // factor, factor, c))
    return x.mean(dim=(-4, -2))
