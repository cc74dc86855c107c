"""The renderer's ops in the port against the JAX package: transforms,
shading-normal helpers, texture sampling and mips, the FG table, and
cubemaps (sampling, latlong conversions, prefilters, the env mip chain).

Inputs are seeded numpy arrays given to both packages, f32 on the CPU.
Tolerances, each stated with its test: 1e-6 absolute for a few f32
operations on values of order 1; 1e-5 where a sum or a transcendental
(atan2, acos, pow, log2) of f32 values enters; looser only where a long
f32 reduction in another order does (the prefilters), said there.  Bilinear
lookups that straddle a texel boundary can pick the other texel under a
1-ulp difference in the coordinate, so the cubemap and latlong lookups
are compared on the fraction of values that agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirenderer_tpu.ops import bsdf as jbsdf
from unirenderer_tpu.ops import cubemap as jcm
from unirenderer_tpu.ops import texture as jtex
from unirenderer_tpu.ops import transform as jxfm
from unirenderer_tpu_torch.ops import bsdf as tbsdf
from unirenderer_tpu_torch.ops import cubemap as tcm
from unirenderer_tpu_torch.ops import texture as ttex
from unirenderer_tpu_torch.ops import transform as txfm

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, atol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _mostly_close(got, want, atol, frac, what=""):
    """At least `frac` of the values within `atol` (a texel flip under a
    1-ulp coordinate difference moves the rest), and all finite."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    ok = np.abs(got - want) <= atol
    assert ok.mean() >= frac, f"{what}: {ok.mean():.4f} within {atol}"


def _unit(rng, shape):
    d = rng.standard_normal(shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# transforms and normals
# ---------------------------------------------------------------------------


def test_xfm_points_and_vectors_match_jax():
    """1e-5: a 4-term f32 dot product of values up to ~3."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
    mat = rng.uniform(-1, 1, (2, 4, 4)).astype(np.float32)
    _close(txfm.xfm_points(_t(pts), _t(mat)),
           jxfm.xfm_points(jnp.asarray(pts), jnp.asarray(mat)), 1e-5)
    _close(txfm.xfm_vectors(_t(pts), _t(mat)),
           jxfm.xfm_vectors(jnp.asarray(pts), jnp.asarray(mat)), 1e-5)


@pytest.mark.parametrize("perturbed,two_sided", [(False, True), (True, True),
                                                 (True, False)])
def test_prepare_shading_normal_matches_jax(perturbed, two_sided):
    """1e-5: normalisations and a clamped blend of unit vectors."""
    rng = np.random.default_rng(1)
    shape = (3, 7, 5, 3)
    pos = rng.uniform(-1, 1, shape).astype(np.float32)
    view = np.asarray([0.3, 0.2, 4.0], np.float32)
    pert = rng.uniform(-1, 1, shape).astype(np.float32) if perturbed \
        else None
    sm, tg, geo = (_unit(rng, shape) for _ in range(3))
    want = jbsdf.prepare_shading_normal(
        jnp.asarray(pos), jnp.asarray(view),
        None if pert is None else jnp.asarray(pert), jnp.asarray(sm),
        jnp.asarray(tg), jnp.asarray(geo), two_sided_shading=two_sided)
    got = tbsdf.prepare_shading_normal(
        _t(pos), _t(view), None if pert is None else _t(pert), _t(sm),
        _t(tg), _t(geo), two_sided_shading=two_sided)
    _close(got, want, 1e-5)
    x, n = _unit(rng, shape), _unit(rng, shape)
    _close(tbsdf.reflect(_t(x), _t(n)),
           jbsdf.reflect(jnp.asarray(x), jnp.asarray(n)), 1e-6)
    _close(tbsdf.length(_t(pos)), jbsdf.length(jnp.asarray(pos)), 1e-6)


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wrap", ["clamp", "wrap"])
def test_sample_texture2d_matches_jax(wrap):
    """1e-5: four weighted taps of values in [0, 1]; the batched form reads
    each element's own texture."""
    rng = np.random.default_rng(2)
    tex = rng.random((2, 12, 9, 3), dtype=np.float32)
    uv = rng.uniform(-0.3, 1.3, (2, 6, 5, 2)).astype(np.float32)
    got = ttex.sample_texture2d(_t(tex), _t(uv), wrap=wrap)
    for b in range(2):
        want = jtex.sample_texture2d(jnp.asarray(tex[b]), jnp.asarray(uv[b]),
                                     wrap=wrap)
        _close(got[b], want, 1e-5, f"batch {b}")
        _close(ttex.sample_texture2d(_t(tex[b]), _t(uv[b]), wrap=wrap),
               want, 1e-5)


def test_texture_mips_and_mip_sampling_match_jax():
    """Mips 1e-6 (means of 4); trilinear lookups 1e-5 (8 weighted taps);
    levels 1e-5 (a log2)."""
    rng = np.random.default_rng(3)
    base = rng.random((16, 16, 3), dtype=np.float32)
    jm = jtex.build_texture_mips(jnp.asarray(base))
    tm = ttex.build_texture_mips(_t(base))
    assert [tuple(m.shape) for m in tm] == [m.shape for m in jm]
    for a, b in zip(tm, jm):
        _close(a, b, 1e-6)
    tm2 = ttex.build_texture_mips(_t(np.stack([base, base[::-1]])))
    assert torch.equal(tm2[3][0], tm[3])
    uv = rng.uniform(-0.2, 1.2, (4, 6, 2)).astype(np.float32)
    deriv = rng.uniform(-0.2, 0.2, (4, 6, 4)).astype(np.float32)
    lvl = rng.uniform(-1, 6, (4, 6)).astype(np.float32)
    _close(ttex.uv_mip_level(_t(deriv), 16, 16),
           jtex.uv_mip_level(jnp.asarray(deriv), 16, 16), 1e-5)
    for wrap in ("wrap", "clamp"):
        _close(ttex.sample_texture2d_mip(tm, _t(uv), uv_deriv=_t(deriv),
                                         wrap=wrap),
               jtex.sample_texture2d_mip(jm, jnp.asarray(uv),
                                         uv_deriv=jnp.asarray(deriv),
                                         wrap=wrap), 1e-5, wrap)
        _close(ttex.sample_texture2d_mip(tm, _t(uv), mip_level=_t(lvl),
                                         wrap=wrap),
               jtex.sample_texture2d_mip(jm, jnp.asarray(uv),
                                         mip_level=jnp.asarray(lvl),
                                         wrap=wrap), 1e-5, wrap)


def test_screen_uv_derivs_matches_jax():
    """Exact up to 1e-6: differences and a round."""
    rng = np.random.default_rng(4)
    texc = rng.random((2, 8, 10, 2), dtype=np.float32)
    got = ttex.screen_uv_derivs(_t(texc), wrap=True)
    for b in range(2):
        _close(got[b], jtex.screen_uv_derivs(jnp.asarray(texc[b]), wrap=True),
               1e-6)


def test_fg_lut_matches_jax_table():
    """The port computes the 256^2 table in-process; the JAX package's
    table is the reference.  1e-5 (a 512-sample f32 mean of terms in
    [0, 1] with sin/cos/sqrt, summed in the same order) everywhere but the
    stiff corner roughness < 0.1, NdotV < 0.13 (rows < 26, columns < 34).
    There each term is divided by NdotV * NdotH ~ 1e-3, and both f32
    tables are ~2e-3 off an f64 integration (JAX 2.0e-3, port 2.4e-3),
    so they are held to 3e-3 of each other."""
    want = np.asarray(jtex.fg_lut())
    got = ttex.fg_lut().numpy()
    assert got.shape == want.shape == (1, 256, 256, 2)
    corner = np.zeros(got.shape, bool)
    corner[0, :26, :34] = True
    _close(got[~corner], want[~corner], 1e-5, "outside the corner")
    _close(got[corner], want[corner], 3e-3, "grazing, low roughness")
    assert ttex.fg_lut() is not ttex.fg_lut()        # a fresh copy each


def test_integrate_fg_matches_jax_on_a_small_grid():
    """1e-5 over a 9 x 7 grid with 64 samples (f32 means of terms with
    sin/cos/sqrt, away from the stiff corner)."""
    nv, rough = np.meshgrid(np.linspace(0.05, 1.0, 9, dtype=np.float32),
                            np.linspace(0.0, 1.0, 7, dtype=np.float32))
    want = jtex._integrate_fg(jnp.asarray(nv), jnp.asarray(rough), 64)
    got = ttex._integrate_fg(_t(nv), _t(rough), 64)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


# ---------------------------------------------------------------------------
# cubemaps
# ---------------------------------------------------------------------------


def test_face_maps_and_hammersley_match_jax():
    """Directions and solid angles 1e-6; the Hammersley set exactly."""
    _close(tcm.all_face_dirs(8), jcm.all_face_dirs(8), 1e-6)
    _close(tcm.texel_solid_angles(8), jcm.texel_solid_angles(8), 1e-6)
    np.testing.assert_array_equal(tcm._hammersley(100).numpy(),
                                  np.asarray(jcm._hammersley(100)))
    rng = np.random.default_rng(5)
    d = _unit(rng, (40, 3))
    jf, jx, jy = jcm.dir_to_cube_uv(jnp.asarray(d))
    tf, tx, ty = tcm.dir_to_cube_uv(_t(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _close(tx, jx, 1e-6)
    _close(ty, jy, 1e-6)
    x = rng.uniform(-1.2, 1.2, 40).astype(np.float32)
    _close(tcm.cube_to_dir_vec(tf, _t(x), ty),
           jcm.cube_to_dir_vec(jf, jnp.asarray(x), jy), 1e-6)


@pytest.mark.parametrize("seamless", [True, False])
def test_sample_cubemap_matches_jax(seamless):
    """1e-5 on >= 99.5 % of values: bilinear taps, seamless across faces;
    a direction within 1 ulp of a texel or face boundary may tap the
    neighbour in one package and not the other.  The batched form equals
    the per-cube lookups exactly."""
    rng = np.random.default_rng(6)
    cube = rng.random((2, 6, 8, 8, 3), dtype=np.float32)
    d = _unit(rng, (2, 30, 20, 3))
    got = tcm.sample_cubemap(_t(cube), _t(d), seamless=seamless)
    for b in range(2):
        want = jcm.sample_cubemap(jnp.asarray(cube[b]), jnp.asarray(d[b]),
                                  seamless=seamless)
        _mostly_close(got[b], want, 1e-5, 0.995, f"batch {b}")
        assert torch.equal(got[b], tcm.sample_cubemap(
            _t(cube[b]), _t(d[b]), seamless=seamless))


def test_sample_cubemap_mip_matches_jax():
    """1e-5 on >= 99.5 % of values: the port weights every level by
    clip(1 - |level - l|, 0, 1), the JAX package gathers the two
    bracketing levels (the same blend, summed in another order)."""
    rng = np.random.default_rng(7)
    mips = [rng.random((6, r, r, 3), dtype=np.float32) for r in (16, 8, 4)]
    d = _unit(rng, (9, 13, 3))
    lvl = rng.uniform(-0.5, 3.0, (9, 13)).astype(np.float32)
    _mostly_close(
        tcm.sample_cubemap_mip([_t(m) for m in mips], _t(d), _t(lvl)),
        jcm.sample_cubemap_mip([jnp.asarray(m) for m in mips],
                               jnp.asarray(d), jnp.asarray(lvl)),
        1e-5, 0.995)


def test_latlong_conversions_match_jax():
    """latlong -> cube 1e-5 on >= 99.5 % (bilinear after atan2/acos);
    cube -> latlong likewise, also batched."""
    rng = np.random.default_rng(8)
    ll = rng.random((8, 16, 3), dtype=np.float32) * 3
    _mostly_close(tcm.latlong_to_cubemap(_t(ll), 8),
                  jcm.latlong_to_cubemap(jnp.asarray(ll), 8), 1e-5, 0.995)
    cube = rng.random((2, 6, 8, 8, 3), dtype=np.float32)
    got = tcm.cubemap_to_latlong(_t(cube), (12, 20))
    for b in range(2):
        _mostly_close(got[b], jcm.cubemap_to_latlong(jnp.asarray(cube[b]),
                                                     (12, 20)),
                      1e-5, 0.995, f"batch {b}")
    _mostly_close(tcm.cubemap_to_latlong(_t(cube[0]), 6),
                  jcm.cubemap_to_latlong(jnp.asarray(cube[0]), 6), 1e-5,
                  0.995)


def test_prefilters_match_jax():
    """Downsample 1e-6; diffuse 1e-5 (a 384-term f32 product, another
    summation order); specular 1e-4 (64 GGX samples of seamless lookups,
    f32 sums over 32-sample chunks; a lookup that taps a neighbouring
    texel moves one sample's weight)."""
    rng = np.random.default_rng(9)
    cube = rng.random((6, 8, 8, 3), dtype=np.float32)
    _close(tcm.downsample_cubemap(_t(cube)),
           jcm.downsample_cubemap(jnp.asarray(cube)), 1e-6)
    _close(tcm.diffuse_cubemap(_t(cube)),
           jcm.diffuse_cubemap(jnp.asarray(cube)), 1e-5)
    for rough in (0.08, 0.5):
        _close(tcm.specular_cubemap(_t(cube), rough, num_samples=64),
               jcm.specular_cubemap(jnp.asarray(cube), rough,
                                    num_samples=64), 1e-4, f"r={rough}")


def test_build_env_mips_matches_jax():
    """The chain the data generator writes, at env 16 -> min 4: the same
    levels and shapes, each level within 1e-4 (as specular_cubemap)."""
    rng = np.random.default_rng(10)
    ll = rng.random((8, 16, 3), dtype=np.float32) * 2
    jbase = jcm.latlong_to_cubemap(jnp.asarray(ll), 16)
    jspec, jdiff = jcm.build_env_mips(jbase, min_res=4, num_samples=32)
    tspec, tdiff = tcm.build_env_mips(_t(np.asarray(jbase)), min_res=4,
                                      num_samples=32)
    assert [tuple(m.shape) for m in tspec] == [m.shape for m in jspec]
    for l, (a, b) in enumerate(zip(tspec, jspec)):
        _close(a, b, 1e-4, f"specular_{l}")
    _close(tdiff, jdiff, 1e-5, "diffuse")
