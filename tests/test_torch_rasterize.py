"""K4's plain version (`unirenderer_tpu_torch.ops.rasterize`) against both
JAX rasterizers: the XLA path `rasterize(impl="jax")` and the Pallas tile
kernel `rasterize_pallas(..., interpret=True)`, on every scenario of
tests/test_rasterize_pallas.py; then `interpolate` and `ssaa_downsample`.

The same clip positions and triangles (numpy) go to both packages.
Tolerance: `_assert_match`, the rule of tests/test_rasterize_pallas.py:
coverage equal everywhere, z within 1e-5, triangle ids equal except on
< 2 % of pixels where both sides hit (a tie at a shared edge decided by
rounding), u and v within 1e-5 where the ids agree.  One exception, by
design: a pixel whose centre lies exactly on an edge shared by two
triangles (the 0.3-quad's diagonal at 64^2 passes through 18 of them).
The port's edge functions are exact there (0) and the lower index covers
the pixel; both JAX paths round their f32 edge functions so that some of
those pixels are covered by neither triangle (a crack).  So coverage may
differ only at such pixels, only as a JAX crack the port fills, on < 2 %
of the image; the other checks hold there as for a tie.  Within the port
(batching, chunking, peeling) results are bit-equal: the same operations
run in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirenderer_tpu.ops.rasterize import interpolate as jax_interpolate
from unirenderer_tpu.ops.rasterize import rasterize as jax_rasterize
from unirenderer_tpu.ops.rasterize import ssaa_downsample as jax_ssaa
from unirenderer_tpu.ops.rasterize_pallas import _precompute
from unirenderer_tpu.ops.rasterize_pallas import rasterize_pallas
from unirenderer_tpu.ops.transform import xfm_points as jax_xfm_points
from unirenderer_tpu.render import camera as jax_camera
from unirenderer_tpu_torch.ops import rasterize as R
from unirenderer_tpu_torch.render.mesh import make_sphere

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _quad(z=0.5, w=1.0, half=0.5):
    pos = np.asarray([[-half, -half, z, w], [half, -half, z, w],
                      [half, half, z, w], [-half, half, z, w]], np.float32)
    tri = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, tri


def _on_edge(pos, tri, h, w):
    """(H, W) True where a pixel centre lies exactly on an edge of a live
    triangle whose other two edge functions have its area's sign (the
    edge functions evaluated exactly, in float64 from the f32 set-up)."""
    rec, _ = R._setup(torch.from_numpy(pos)[None], torch.from_numpy(tri)[None],
                      h, w)
    r = rec[0].double()
    py = (torch.arange(h, dtype=torch.float64) + 0.5)[:, None, None]
    px = (torch.arange(w, dtype=torch.float64) + 0.5)[None, :, None]
    e = [px * r[:, 3 * k] + py * r[:, 3 * k + 1] + r[:, 3 * k + 2]
         for k in range(3)]
    sign = torch.sign(r[:, 9])
    closed = (sign != 0) & (e[0] * sign >= 0) & (e[1] * sign >= 0) \
        & (e[2] * sign >= 0)
    zero = (e[0] == 0) | (e[1] == 0) | (e[2] == 0)
    return (closed & zero).any(-1).numpy()


def _assert_match(a, b, on_edge=None):
    """The rule of tests/test_rasterize_pallas.py (see the module doc).
    `b` is the port.  Where given, `on_edge` marks the pixels whose centre
    lies exactly on a triangle edge: the JAX paths leave some of them
    empty (a crack decided by their rounding), the port covers them, and
    only there may coverage differ."""
    ia, ib = np.asarray(a.tri_id), np.asarray(b.tri_id)
    za, zb = np.asarray(a.z, np.float64), np.asarray(b.z, np.float64)
    cracks = (ia == 0) & (ib > 0)
    if on_edge is not None and cracks.any():
        assert on_edge[cracks].all(), "coverage differs off an exact edge"
        assert cracks.mean() < 0.02
        ia, za = np.where(cracks, ib, ia), np.where(cracks, zb, za)
    agree = ia == ib
    np.testing.assert_array_equal(ib > 0, ia > 0)
    np.testing.assert_allclose(zb, za, atol=1e-5)
    disagree = ~agree
    assert disagree.mean() < 0.02, f"{disagree.sum()} non-tie mismatches"
    assert (ia[disagree] > 0).all() and (ib[disagree] > 0).all()
    for f in ("bary_u", "bary_v"):
        ga = np.asarray(getattr(a, f), np.float64)
        gb = np.asarray(getattr(b, f), np.float64)
        np.testing.assert_allclose(gb[agree & ~cracks], ga[agree & ~cracks],
                                   atol=1e-5, err_msg=f)


def _port(pos, tri, h, w, chunk, prev_z=None):
    pos, tri = np.array(pos), np.array(tri)
    return R.rasterize(torch.from_numpy(pos), torch.from_numpy(tri), h, w,
                       chunk=chunk,
                       prev_z=None if prev_z is None
                       else torch.as_tensor(np.asarray(prev_z)))


def _check_both(pos, tri, h, w, chunk, prev=None):
    """Port against the XLA path and the Pallas kernel; returns the three
    results (xla, pallas, port)."""
    pj, tj = jnp.asarray(pos), jnp.asarray(tri)
    prev_j = None if prev is None else jnp.asarray(prev[0])
    prev_p = None if prev is None else jnp.asarray(prev[1])
    prev_t = None if prev is None else prev[2]
    a = jax_rasterize(pj, tj, h, w, chunk=chunk, prev_z=prev_j)
    b = rasterize_pallas(pj, tj, h, w, chunk=chunk, prev_z=prev_p,
                         interpret=True)
    c = _port(pos, tri, h, w, chunk, prev_t)
    on_edge = _on_edge(pos, tri, h, w)
    _assert_match(a, c, on_edge)
    _assert_match(b, c, on_edge)
    return a, b, c


def _sphere_clip(res=8, az=30.0, el=70.0, dist=3.5):
    m = make_sphere(res)
    mvp, _ = jax_camera.spherical_camera(az, el, dist)
    pos = np.array(jax_xfm_points(jnp.asarray(m.v_pos)[None],
                                  mvp[None])[0])
    return pos, np.array(m.t_pos_idx)


@pytest.mark.parametrize("half,hw", [(0.5, 32), (1.0, 16), (0.3, 64)])
def test_quad_matches_jax(half, hw):
    pos, tri = _quad(half=half)
    _, _, c = _check_both(pos, tri, hw, hw, chunk=8)
    assert (c.tri_id > 0).any()


def test_depth_and_multichunk_match_jax():
    posA, triA = _quad(z=0.8, half=1.0)
    posB, _ = _quad(z=0.2, half=0.4)
    posB[:, 0] += 0.013
    pos = np.concatenate([posA, posB])
    tri = np.concatenate([triA, triA + 4])
    _, _, c = _check_both(pos, tri, 32, 32, chunk=2)
    assert (c.tri_id.numpy() >= 3).sum() > 0       # the near quad wins


def test_perspective_matches_jax():
    pos = np.asarray([[-1.0, -1.0, 0.0, 1.0], [3.0, -1.0, 0.0, 2.0],
                      [-1.0, 3.0, 0.0, 2.0]], np.float32)
    tri = np.asarray([[0, 1, 2]], np.int32)
    _check_both(pos, tri, 32, 32, chunk=8)


def test_depth_peel_second_layer_matches_jax():
    posA, triA = _quad(z=0.2, half=1.0)
    posB, _ = _quad(z=0.8, half=1.0)
    pos = np.concatenate([posA, posB])
    tri = np.concatenate([triA, triA + 4])
    a1, b1, c1 = _check_both(pos, tri, 16, 16, chunk=8)
    _, _, c2 = _check_both(pos, tri, 16, 16, chunk=8,
                           prev=(a1.z, b1.z, c1.z))
    assert (c2.tri_id.numpy() >= 3).all()          # peeled to the far quad


def test_degenerate_and_behind_ignored_match_jax():
    pos, tri = _quad(half=0.5)
    pos = np.concatenate([pos, np.asarray([[0.0, 0.0, 0.0, -1.0]],
                                          np.float32)])
    tri = np.concatenate([tri, np.asarray([[0, 0, 1], [0, 1, 4]],
                                          np.int32)])
    _, _, c = _check_both(pos, tri, 16, 16, chunk=8)
    assert c.tri_id.max() <= 2


def test_sphere_mesh_matches_jax():
    pos, tri = _sphere_clip()
    _, _, c = _check_both(pos, tri, 32, 32, chunk=64)
    assert (c.tri_id > 0).any()


def test_ragged_size_matches_jax():
    """H and W that are not multiples of the kernel's 16-pixel tile."""
    pos, tri = _sphere_clip(res=10, az=200.0, el=120.0, dist=3.0)
    _check_both(pos, tri, 20, 37, chunk=32)


def test_setup_records_match_pallas_precompute():
    """The per-triangle records (edge coefficients, area, z, 1/w) against
    the Pallas kernel's set-up, to 1e-5 relative per column."""
    pos, tri = _sphere_clip()
    coef, _, n_chunks = _precompute(jnp.asarray(pos), jnp.asarray(tri),
                                    32, 32, 64)
    want = np.asarray(coef).transpose(0, 2, 1).reshape(-1, 16)
    rec, box = R._setup(torch.from_numpy(pos)[None],
                        torch.from_numpy(tri)[None], 32, 32)
    got = rec[0].numpy()
    t = tri.shape[0]
    assert (want[t:, 9] == 0).all() and (got[:, 9] != 0).any()
    for col in range(16):
        scale = max(np.abs(want[:t, col]).max(), 1e-6)
        err = np.abs(got[:, col] - want[:t, col]).max() / scale
        assert err <= 1e-5, (col, err)
    empty = got[:, 9] == 0
    assert np.isinf(box[0].numpy()[empty]).all()
    assert np.isfinite(box[0].numpy()[~empty]).all()


def test_batch_chunk_and_peel_are_bit_equal_within_the_port():
    """One batched call equals per-view calls; the chunk size changes
    nothing; a peel layer through the batched call equals per view."""
    views = [_sphere_clip(res=9, az=az, el=el, dist=3.2)
             for az, el in ((10.0, 80.0), (250.0, 40.0))]
    pos = torch.from_numpy(np.stack([v[0] for v in views]))
    tri = torch.from_numpy(np.stack([v[1] for v in views]))
    both = R.rasterize(pos, tri, 24, 40, chunk=16)
    other_chunk = R.rasterize(pos, tri, 24, 40, chunk=128)
    for f in range(4):
        assert torch.equal(both[f], other_chunk[f])
        for i in range(2):
            one = R.rasterize(pos[i], tri[i], 24, 40, chunk=32)
            assert torch.equal(both[f][i], one[f])
    peel = R.rasterize(pos, tri, 24, 40, prev_z=both.z.contiguous())
    for i in range(2):
        one = R.rasterize(pos[i], tri[i], 24, 40, prev_z=both.z[i])
        for f in range(4):
            assert torch.equal(peel[f][i], one[f])
    hit = peel.tri_id > 0
    assert hit.any() and (peel.z[hit] > both.z[hit]).all()


def test_wrapper_takes_cpu_and_rejects_other_devices():
    pos, tri = _quad()
    before = R.rasterize.launches
    out = _port(pos, tri, 8, 8, chunk=8)
    assert out.tri_id.shape == (8, 8) and out.tri_id.dtype == torch.int32
    assert R.rasterize.launches == before          # no kernel on the CPU
    with pytest.raises(ValueError):
        R.rasterize(torch.from_numpy(pos).to("meta"),
                    torch.from_numpy(tri).to("meta"), 8, 8)


def test_interpolate_matches_jax():
    """Tolerance 1e-5 absolute: a three-term weighted sum of f32 values of
    magnitude <= 1 on both sides."""
    pos, tri = _sphere_clip()
    rng = np.random.default_rng(3)
    attr = rng.uniform(-1, 1, (pos.shape[0], 5)).astype(np.float32)
    jr = jax_rasterize(jnp.asarray(pos), jnp.asarray(tri), 32, 32, chunk=64)
    want_img, want_mask = jax_interpolate(jnp.asarray(attr), jr,
                                          jnp.asarray(tri))
    rast = R.RastOutput(*(torch.as_tensor(np.asarray(x)) for x in jr))
    got_img, got_mask = R.interpolate(torch.from_numpy(attr), rast,
                                      torch.from_numpy(tri))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=1e-5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    # batched: two copies with different attributes
    attr2 = np.stack([attr, attr[::-1].copy()])
    rast2 = R.RastOutput(*(torch.stack([x, x]) for x in rast))
    img2, _ = R.interpolate(torch.from_numpy(attr2), rast2,
                            torch.from_numpy(np.stack([tri, tri])))
    assert torch.equal(img2[0], got_img)
    want2, _ = jax_interpolate(jnp.asarray(attr2[1]), jr, jnp.asarray(tri))
    np.testing.assert_allclose(img2[1].numpy(), np.asarray(want2),
                               atol=1e-5)


@pytest.mark.parametrize("factor", [2, 4])
def test_ssaa_downsample_matches_jax(factor):
    """Tolerance 1e-6: a mean of factor^2 values in [0, 1]."""
    img = np.random.default_rng(factor).random((2, 16, 24, 3),
                                               dtype=np.float32)
    want = np.asarray(jax_ssaa(jnp.asarray(img), factor))
    got = R.ssaa_downsample(torch.from_numpy(img), factor).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
