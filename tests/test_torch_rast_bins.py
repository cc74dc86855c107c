"""K4's binning on the CPU: `rast_bins_reference`, the plain mirror of the
kernels' count / scan / fill (csrc/rasterize.cu), and the raster over its
lists against the plain rasterizer `rasterize_reference` (which
tests/test_torch_rasterize.py holds against both JAX rasterizers).

  * the tile lists are what their definition says (every tile whose pixel
    centres a triangle's box holds, by brute force over the centres), and
    every (triangle, pixel) hit of `rasterize_reference` lies in that
    pixel's tile list or its view's wide list;
  * walking each tile's lists in a shuffled order, as the kernel's atomics
    may leave them, with the kernel's rule (a hit replaces the running best
    when (z, index) is lexicographically smaller) gives `rasterize_reference`
    bit for bit: deformed spheres in a ragged batch with padding, a peel
    layer, a quad whose two triangles tie at equal z on their shared edge,
    and a view with wide triangles;
  * a full-screen triangle lands in every tile's list (or, over more than
    MAX_BIN_TILES tiles, in its view's wide list), and degenerate, behind-
    the-eye and padding triangles in none.

Each hit's (z, u, v) comes from `rasterize_reference`'s own per-block
arithmetic (`_reference_block`) on the triangle alone, so the comparison
is exact; no JAX runs here.
"""

import numpy as np
import pytest
import torch

from unirenderer_tpu_torch.ops import rasterize as R
from unirenderer_tpu_torch.ops.transform import xfm_points
from unirenderer_tpu_torch.render import camera
from unirenderer_tpu_torch.render.mesh import make_sphere

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _quad(z=0.5, half=0.5):
    pos = torch.tensor([[-half, -half, z, 1.0], [half, -half, z, 1.0],
                        [half, half, z, 1.0], [-half, half, z, 1.0]])
    return pos, torch.tensor([[0, 1, 2], [0, 2, 3]], dtype=torch.int32)


def _spheres(views=2, res=10, t_pad=512, seed=0):
    """(B, t_pad, 4) clip positions and (B, t_pad, 3) triangles of a
    sphere from random cameras, the triangles padded with [0, 0, 0]."""
    rng = np.random.default_rng(seed)
    m = make_sphere(res)
    v = np.zeros((t_pad, 3), np.float32)
    v[:m.v_pos.shape[0]] = m.v_pos * rng.uniform(0.8, 1.2, (1, 3))
    t = np.zeros((t_pad, 3), np.int32)
    t[:m.t_pos_idx.shape[0]] = m.t_pos_idx
    pos = []
    for _ in range(views):
        mvp, _ = camera.spherical_camera(rng.uniform(0, 360),
                                         rng.uniform(30, 150), 3.0)
        pos.append(xfm_points(torch.from_numpy(v)[None], mvp[None])[0])
    return torch.stack(pos), torch.from_numpy(t)[None].repeat(views, 1, 1)


def _wide_scene():
    """A near quad over the whole 144 x 160 view (81+ tiles a triangle:
    the wide list), a smaller far one and a sliver."""
    near, tri = _quad(z=0.2, half=1.1)
    far, _ = _quad(z=0.6, half=0.4)
    sliver = torch.tensor([[-0.9, -0.9, 0.4, 1.0], [0.9, -0.85, 0.4, 1.0],
                           [-0.9, -0.86, 0.4, 1.0]])
    pos = torch.cat([near, far, sliver])[None]
    tris = torch.cat([tri, tri + 4,
                      torch.tensor([[8, 9, 10]], dtype=torch.int32)])[None]
    return pos, tris


def _bins(pos, tri, h, w):
    _, box = R._setup(pos, tri, h, w)
    return box, R.rast_bins_reference(box, h, w)


def _tile_lists(bins, b, n_tiles, tile):
    start = bins.start.long()
    i = b * n_tiles + tile
    binned = bins.pairs[start[i]:start[i + 1]].tolist()
    wide = bins.wide[b, :int(bins.wide_count[b])].tolist()
    return binned, wide


def _candidates(rec, box, t, ya, yb, xa, xb, pz):
    """Triangle t alone over pixels [ya, yb) x [xa, xb) with the plain
    version's arithmetic -> (z, u, v, hit), each (yb - ya, xb - xa)."""
    # best-so-far images that _reference_block fills at [ya:yb, xa:xb]
    best = [torch.full((yb, xb), R.BIG), torch.zeros((yb, xb)),
            torch.zeros((yb, xb)), torch.zeros((yb, xb), dtype=torch.int32)]
    R._reference_block(rec[t:t + 1], box[t:t + 1], t, ya, yb, xa, xb, pz,
                       *best)
    z, u, v, tid = (x[ya:yb, xa:xb] for x in best)
    return z, u, v, tid > 0


def _walk(pos, tri, h, w, prev_z=None, seed=0, lexicographic=True):
    """The raster kernel's walk, in torch: per view and tile, its list and
    its view's wide list in a shuffled order; a hit replaces the running
    best when (z, index) is lexicographically smaller (or, with
    `lexicographic=False`, when z is strictly smaller: first seen wins a
    tie)."""
    rng = np.random.default_rng(seed)
    rec, box = R._setup(pos, tri, h, w)
    bins = R.rast_bins_reference(box, h, w)
    nb = pos.shape[0]
    n_tx, n_ty = -(-w // R.TILE), -(-h // R.TILE)
    out_z = torch.zeros((nb, h, w))
    out_u, out_v = torch.zeros((nb, h, w)), torch.zeros((nb, h, w))
    out_id = torch.zeros((nb, h, w), dtype=torch.int32)
    for b in range(nb):
        for tile in range(n_tx * n_ty):
            binned, wide = _tile_lists(bins, b, n_tx * n_ty, tile)
            order = binned + wide
            rng.shuffle(order)
            ya, xa = (tile // n_tx) * R.TILE, (tile % n_tx) * R.TILE
            yb, xb = min(ya + R.TILE, h), min(xa + R.TILE, w)
            pz = None if prev_z is None else prev_z[b, ya:yb, xa:xb]
            best_z = torch.full((yb - ya, xb - xa), R.BIG)
            best_u, best_v = torch.zeros_like(best_z), torch.zeros_like(best_z)
            best_t = torch.full(best_z.shape, 2 ** 31 - 1, dtype=torch.int64)
            for t in order:
                z, u, v, hit = _candidates(rec[b], box[b], t, ya, yb, xa, xb,
                                           pz)
                better = hit & ((z < best_z) | (
                    (z == best_z) & (t < best_t) & lexicographic))
                best_z = torch.where(better, z, best_z)
                best_u = torch.where(better, u, best_u)
                best_v = torch.where(better, v, best_v)
                best_t = torch.where(better, t, best_t)
            hit = best_t < 2 ** 31 - 1
            out_z[b, ya:yb, xa:xb] = torch.where(hit, best_z, 0.0)
            out_u[b, ya:yb, xa:xb] = best_u
            out_v[b, ya:yb, xa:xb] = best_v
            out_id[b, ya:yb, xa:xb] = torch.where(hit, best_t + 1, 0).int()
    return R.RastOutput(out_u, out_v, out_z, out_id)


SCENES = {
    "spheres ragged": lambda: (*_spheres(2, 10, 512, seed=1), 40, 56),
    "quad tie": lambda: (*(x[None] for x in _quad()), 32, 32),
    "wide": lambda: (*_wide_scene(), 144, 160),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tile_lists_are_the_tiles_each_box_holds_a_centre_of(scene):
    """Brute force over the pixel centres: a triangle is in a tile's list
    iff its box holds a centre of that tile and it is on at most
    MAX_BIN_TILES tiles; else in its view's wide list."""
    pos, tri, h, w = SCENES[scene]()
    box, bins = _bins(pos, tri, h, w)
    n_tx, n_ty = -(-w // R.TILE), -(-h // R.TILE)
    cx = torch.arange(w) + 0.5
    cy = torch.arange(h) + 0.5
    for b in range(pos.shape[0]):
        x_in = (cx >= box[b, :, :1]) & (cx <= box[b, :, 1:2])     # (T, W)
        y_in = (cy >= box[b, :, 2:3]) & (cy <= box[b, :, 3:4])    # (T, H)
        tx_in = torch.zeros((tri.shape[1], n_tx), dtype=torch.bool)
        ty_in = torch.zeros((tri.shape[1], n_ty), dtype=torch.bool)
        tx_in.index_put_((torch.arange(tri.shape[1])[:, None].expand_as(x_in),
                          (torch.arange(w) // R.TILE).expand_as(x_in)),
                         x_in, accumulate=True)
        ty_in.index_put_((torch.arange(tri.shape[1])[:, None].expand_as(y_in),
                          (torch.arange(h) // R.TILE).expand_as(y_in)),
                         y_in, accumulate=True)
        on = ty_in[:, :, None] & tx_in[:, None, :]               # (T, ty, tx)
        n_on = on.flatten(1).sum(1)
        wide = (n_on > R.MAX_BIN_TILES).nonzero()[:, 0].tolist()
        for tile in range(n_tx * n_ty):
            binned, got_wide = _tile_lists(bins, b, n_tx * n_ty, tile)
            want = ((on[:, tile // n_tx, tile % n_tx])
                    & (n_on <= R.MAX_BIN_TILES)).nonzero()[:, 0].tolist()
            assert binned == want, (b, tile)
            assert got_wide == wide
    assert int(bins.start[-1]) == bins.pairs.numel()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_every_hit_lies_in_its_tiles_lists(scene):
    pos, tri, h, w = SCENES[scene]()
    _, bins = _bins(pos, tri, h, w)
    ref = R.rasterize_reference(pos, tri, h, w)
    n_tx, n_ty = -(-w // R.TILE), -(-h // R.TILE)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    tiles = (ys // R.TILE) * n_tx + xs // R.TILE
    checked = 0
    for b in range(pos.shape[0]):
        for tile in range(n_tx * n_ty):
            hits = set(ref.tri_id[b][(tiles == tile)
                                     & (ref.tri_id[b] > 0)].tolist())
            binned, wide = _tile_lists(bins, b, n_tx * n_ty, tile)
            assert {i - 1 for i in hits} <= set(binned) | set(wide), (b, tile)
            checked += len(hits)
    assert checked > 0


@pytest.mark.parametrize("scene", sorted(SCENES) + ["spheres peel"])
def test_shuffled_tile_walk_is_bit_equal_to_the_plain_version(scene):
    prev_z = None
    if scene == "spheres peel":
        pos, tri, h, w = SCENES["spheres ragged"]()
        prev_z = R.rasterize_reference(pos, tri, h, w).z
    else:
        pos, tri, h, w = SCENES[scene]()
    want = R.rasterize_reference(pos, tri, h, w, prev_z=prev_z)
    got = _walk(pos, tri, h, w, prev_z, seed=3)
    for name, g, x in zip(R.RastOutput._fields, got, want):
        assert torch.equal(g, x), name
    assert (want.tri_id > 0).any()
    if scene == "wide":
        _, bins = _bins(pos, tri, h, w)
        assert int(bins.wide_count[0]) == 2       # the near quad's halves


def test_quad_tie_is_decided_by_the_index():
    """The quad's two triangles cover pixels on their shared diagonal at
    the same z: first-seen-wins over a shuffled order gives the higher
    index somewhere, the lexicographic rule the plain version's lower."""
    pos, tri, h, w = SCENES["quad tie"]()
    rec, box = R._setup(pos, tri, h, w)
    z0, _, _, hit0 = _candidates(rec[0], box[0], 0, 0, h, 0, w, None)
    z1, _, _, hit1 = _candidates(rec[0], box[0], 1, 0, h, 0, w, None)
    assert (hit0 & hit1 & (z0 == z1)).sum() > 0
    want = R.rasterize_reference(pos, tri, h, w)
    firsts = [_walk(pos, tri, h, w, seed=s, lexicographic=False).tri_id
              for s in range(4)]
    assert any(not torch.equal(f, want.tri_id) for f in firsts)


@pytest.mark.parametrize("h,w,wide", [(48, 64, False), (144, 160, True)])
def test_full_screen_triangle_is_in_every_tiles_lists(h, w, wide):
    pos = torch.tensor([[[-1.0, -1.0, 0.5, 1.0], [3.0, -1.0, 0.5, 1.0],
                         [-1.0, 3.0, 0.5, 1.0]]])
    tri = torch.tensor([[[0, 1, 2]]], dtype=torch.int32)
    _, bins = _bins(pos, tri, h, w)
    n_tiles = -(-w // R.TILE) * -(-h // R.TILE)
    assert (n_tiles > R.MAX_BIN_TILES) == wide
    for tile in range(n_tiles):
        binned, wides = _tile_lists(bins, 0, n_tiles, tile)
        assert binned + wides == [0]
    assert (R.rasterize_reference(pos, tri, h, w).tri_id == 1).all()


def test_degenerate_and_padding_triangles_are_in_no_list():
    """Padding ([0, 0, 0]), a repeated index, a zero-area triangle, one
    behind the eye and one off the screen: no list holds any of them."""
    pos, _ = _quad()
    pos = torch.cat([pos, torch.tensor([[0.0, 0.0, 0.0, -1.0],
                                        [0.25, 0.25, 0.5, 1.0],
                                        [5.0, 5.0, 0.5, 1.0],
                                        [6.0, 5.0, 0.5, 1.0],
                                        [5.0, 6.0, 0.5, 1.0]])])[None]
    tri = torch.tensor([[[0, 0, 0], [0, 0, 1], [0, 2, 5], [0, 1, 4],
                         [6, 7, 8], [0, 0, 0]]], dtype=torch.int32)
    rec, box = R._setup(pos, tri, 32, 32)
    assert int((rec[0, :, 9] != 0).sum()) == 1       # only the off-screen
    bins = R.rast_bins_reference(box, 32, 32)
    assert bins.pairs.numel() == 0 and int(bins.wide_count[0]) == 0
    assert (R.rasterize_reference(pos, tri, 32, 32).tri_id == 0).all()


def test_bins_of_the_kernel_need_cuda_tensors():
    pos, tri = _quad()
    with pytest.raises(ValueError):
        R.rasterize_with_bins(pos[None], tri[None], 16, 16)
