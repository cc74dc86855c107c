"""The port's data and segmentation modules against the JAX package's, on
the CPU (numpy copies: bit-equal unless a tolerance is stated):

  * `read_hdr` / `write_hdr`: a round trip within RGBE's 8-bit mantissa,
    the written bytes equal to JAX's, and JAX's reader and the port's
    giving the same bits on flat and run-length-encoded files;
  * `load_obj` on an OBJ + MTL with corners that miss normals, texcoords
    or both, a quad and negative indices: the native scanner, the numpy
    parser and the JAX package's numpy parser give the same arrays;
    `use_native=True` builds the scanner with g++ and raises when it
    cannot (no quiet fallback);
  * `parse_mtl` and `Material` (constant and textured `sample_kd`, wrap)
    against JAX within 1e-6;
  * `PreRenderedDataset` items and `collate_prerendered` equal to JAX's;
  * the segmentation heuristics (`auto_mask`, `box_prompt_mask`,
    `point_prompt_mask` with a background click) and `load_mask` (.png
    and .npy, resized) bit-equal to JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unirenderer_tpu.data import hdr as jhdr
from unirenderer_tpu.data import obj_io as jobj
from unirenderer_tpu.data import prerendered as jpre
from unirenderer_tpu.eval import segmentation as jseg
from unirenderer_tpu.render.material import Material as JaxMaterial
from unirenderer_tpu_torch.data import hdr as thdr
from unirenderer_tpu_torch.data import obj_io as tobj
from unirenderer_tpu_torch.data import prerendered as tpre
from unirenderer_tpu_torch.eval import segmentation as tseg
from unirenderer_tpu_torch.render.material import Material

OBJ_TEXT = """# corners with and without texcoords and normals
mtllib m.mtl
v -1 -1 0.5
v 1 -1 0
v 1 1 0.25
v -1 1 0
v 0 0 1.5
v 0.5 -0.5 0.75
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
usemtl red
f 1/1/1 2/2/1 3/3/1
f 1//2 3//2 4//2
f 4 5 6
f 2/2 5/3 6/4 3/1
f -1/-1 -2/-2 -4/-3
"""
MTL_TEXT = """newmtl red
Kd 0.9 0.2 0.1
map_Kd kd.png
newmtl blue
Kd 0.1 0.2 0.9
"""

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture()
def obj_file(tmp_path):
    (tmp_path / "m.obj").write_text(OBJ_TEXT)
    (tmp_path / "m.mtl").write_text(MTL_TEXT)
    tex = np.random.default_rng(0).integers(0, 255, (8, 12, 3), np.uint8)
    Image.fromarray(tex).save(tmp_path / "kd.png")
    return str(tmp_path / "m.obj")


# ---------------------------------------------------------------------------
# HDR
# ---------------------------------------------------------------------------

def _rle_hdr(path, rgbe):
    """A run-length-encoded Radiance file of the (H, W, 4) uint8 RGBE
    array: per scanline and channel, runs of equal bytes (> 2) as runs,
    the rest as literals."""
    h, w, _ = rgbe.shape
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run > 2:
                    out += bytes([128 + run, row[x]])
                    x += run
                    continue
                lit = 1
                while x + lit < w and lit < 128 and not (
                        x + lit + 2 < w and row[x + lit] == row[x + lit + 1]
                        == row[x + lit + 2]):
                    lit += 1
                out += bytes([lit]) + bytes(row[x:x + lit])
                x += lit
    with open(path, "wb") as f:
        f.write(bytes(out))


def test_hdr_round_trip_and_bits_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = np.exp(rng.standard_normal((9, 20, 3)) * 2).astype(np.float32)
    img[0, :4] = 0.0                                # exponent 0
    p_port, p_jax = str(tmp_path / "p.hdr"), str(tmp_path / "j.hdr")
    thdr.write_hdr(p_port, img)
    jhdr.write_hdr(p_jax, img)
    with open(p_port, "rb") as a, open(p_jax, "rb") as b:
        assert a.read() == b.read()
    back = thdr.read_hdr(p_port)
    np.testing.assert_array_equal(back, jhdr.read_hdr(p_port))
    assert back.dtype == np.float32 and back.shape == img.shape
    # RGBE keeps 8 bits of mantissa: within 1/128 of the largest channel
    assert (np.abs(back - img) <= img.max(-1, keepdims=True) / 128
            + 1e-30).all()

    rgbe = rng.integers(0, 256, (5, 40, 4), np.uint8)
    rgbe[:, 10:30] = rgbe[:, 10:11]                 # runs
    p_rle = str(tmp_path / "rle.hdr")
    _rle_hdr(p_rle, rgbe)
    got = thdr.read_hdr(p_rle)
    np.testing.assert_array_equal(got, jhdr.read_hdr(p_rle))
    exp = rgbe[..., 3].astype(np.int32)
    want = np.where(exp[..., None] == 0, 0.0, (rgbe[..., :3] + 0.5)
                    * np.ldexp(1.0, exp - 136)[..., None])
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_read_hdr_refuses_other_files(tmp_path):
    p = tmp_path / "x.hdr"
    p.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        thdr.read_hdr(str(p))


# ---------------------------------------------------------------------------
# OBJ / MTL / Material
# ---------------------------------------------------------------------------

OBJ_KEYS = ("v_pos", "t_idx", "v_nrm", "v_tex", "v_tng", "kd")


def test_load_obj_native_numpy_and_jax_agree(obj_file):
    native = tobj.load_obj(obj_file, use_native=True)
    plain = tobj.load_obj(obj_file, use_native=False)
    want = jobj.load_obj(obj_file, use_native=False)
    for k in OBJ_KEYS:
        assert native[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(native[k], plain[k], err_msg=k)
        np.testing.assert_array_equal(native[k], want[k], err_msg=k)
    assert native["kd_map"] == plain["kd_map"] == want["kd_map"]
    assert native["kd_map"].endswith("kd.png")
    assert native["t_idx"].shape == (6, 3)          # the quad fanned
    # the parsers' raw arrays, missing indices as -1
    for a, b in zip(tobj._parse_obj_native(obj_file),
                    tobj._parse_obj_python(obj_file)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (tobj._parse_obj_python(obj_file)[5] == -1).any()


def test_native_build_failure_raises(obj_file, monkeypatch, tmp_path):
    monkeypatch.setattr(tobj, "_LIB", None)
    monkeypatch.setattr(tobj, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises((RuntimeError, OSError)):
        tobj.load_obj(obj_file, use_native=True)
    # the numpy parser runs only when asked for
    assert tobj.load_obj(obj_file, use_native=False)["t_idx"].shape == (6, 3)


def test_parse_mtl_and_material_match_jax(obj_file):
    mtl = os.path.splitext(obj_file)[0] + ".mtl"
    got, want = tobj.parse_mtl(mtl), jobj.parse_mtl(mtl)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].keys() == want[name].keys()
        np.testing.assert_array_equal(got[name]["kd"], want[name]["kd"])
    assert tobj.parse_mtl(mtl + ".missing") == {}

    uv = np.random.default_rng(2).uniform(-0.5, 1.5, (5, 7, 2)).astype(
        np.float32)
    for name in ("red", "blue"):
        tm = Material.from_mtl(mtl, name, device="cpu")
        jm = JaxMaterial.from_mtl(mtl, name)
        assert tm.has_texture == jm.has_texture == (name == "red")
        np.testing.assert_allclose(tm.kd.numpy(), np.asarray(jm.kd),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            tm.sample_kd(torch.from_numpy(uv)).numpy(),
            np.asarray(jm.sample_kd(jnp.asarray(uv))), rtol=0, atol=1e-6)
    empty = Material.from_mtl(mtl + ".missing", device="cpu")
    np.testing.assert_array_equal(empty.kd.numpy(),
                                  np.full(3, 0.8, np.float32))
    assert float(empty.metallic) == 0.0 and float(empty.roughness) == 0.5


# ---------------------------------------------------------------------------
# Pre-rendered data
# ---------------------------------------------------------------------------

def test_prerendered_items_and_collate_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    frames = ("000", "001", "002")
    layout = {"rgba": 4, "metallic": 1, "roughness": 1, "normal": 3}
    for mod, ch in layout.items():
        os.makedirs(tmp_path / mod)
        for f in frames:
            arr = rng.integers(0, 256, (20, 20, ch), np.uint8)
            Image.fromarray(arr[..., 0] if ch == 1 else arr).save(
                tmp_path / mod / f"{f}.png")
    env = tmp_path / "env.png"
    Image.fromarray(rng.integers(0, 256, (10, 20, 3), np.uint8)).save(env)
    kw = dict(modalities=tuple(layout), resolution=16, fixed_env=str(env))
    tds = tpre.PreRenderedDataset(str(tmp_path), **kw)
    jds = jpre.PreRenderedDataset(str(tmp_path), **kw)
    assert len(tds) == len(jds) == 3 and tds.frames == jds.frames
    items_t, items_j = [tds[i] for i in range(3)], [jds[i] for i in range(3)]
    for a, b in zip(items_t, items_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = tpre.collate_prerendered(items_t)
    want = jpre.collate_prerendered(items_j)
    for k in want:
        assert got[k].shape == want[k].shape == (3, 16, 16, 3)
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------

def _scene_image(seed, h=48, w=56):
    """A two-colour object on a cluttered two-tone background, [0, 1]."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.float32)
    img[:, : w // 2] = (0.95, 0.9, 0.85)
    img[:, w // 2:] = (0.3, 0.5, 0.7)
    yy, xx = np.mgrid[0:h, 0:w]
    obj = (yy - h / 2) ** 2 / 150 + (xx - w / 2) ** 2 / 200 < 1
    img[obj] = (0.8, 0.2, 0.1)
    img[obj & (xx > w / 2)] = (0.2, 0.7, 0.2)
    img += rng.normal(0, 0.03, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


@pytest.mark.parametrize("case", ["auto", "box", "box_degenerate", "point",
                                  "point_background"])
def test_segmentation_heuristics_bit_equal_jax(case):
    img = _scene_image(4)
    if case == "auto":
        got, want = tseg.auto_mask(img), jseg.auto_mask(img)
    elif case.startswith("box"):
        box = (10, 8, 46, 40) if case == "box" else (10, 8, 11, 40)
        got, want = tseg.box_prompt_mask(img, box), jseg.box_prompt_mask(
            img, box)
    else:
        pts = ([28, 24] if case == "point"
               else [28, 24, 18, 30, -3, -3, -50, -40])
        got = tseg.point_prompt_mask(img, pts)
        want = jseg.point_prompt_mask(img, pts)
    assert got.dtype == want.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    if case in ("box", "point"):
        assert 0 < got[..., 0].mean() < 1


def test_load_mask_bit_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    m = rng.uniform(0, 1, (30, 34))
    png, npy = str(tmp_path / "m.png"), str(tmp_path / "m.npy")
    Image.fromarray((m * 255).astype(np.uint8)).save(png)
    np.save(npy, np.repeat(m[..., None], 3, -1))
    for path in (png, npy):
        for size in (None, 16):
            got, want = tseg.load_mask(path, size), jseg.load_mask(path, size)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
