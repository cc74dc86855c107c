"""The port's data-preparation and export CLIs against the JAX tools, on
the CPU, on the same inputs (made from seeds by `data/synthetic.py`):

  * `data.obj2mesh` against tools/obj2mesh.py over a tree of OBJ + MTL +
    PNG meshes and one OBJ with no faces: the same files, every array
    equal key by key (`kd_map` too), each equal to a single-threaded
    `load_obj`; the bad OBJ skipped by both, exit 0;
  * `data.light2map` against tools/light2map.py (`main` in-process, at
    --res 32 --min-res 8 --samples 16) on an .hdr, an .npy and a file
    that is no HDR (skipped by both): every level of every env within
    1e-5 * max|JAX| at every texel but at most one a level, which stays
    within 1e-2 * max|JAX|.  Measured at this size over 4 seeds: at most
    one texel a level over 1e-5, at the coarsest specular level, up to
    3.1e-3, where a GGX sample's reflected direction lies on a cube-face
    seam and the two packages' rounding picks different faces; every
    other texel within 1.0e-6;
  * `data.remove_bg` against tools/remove_bg.py, batch (one image without
    a mask skipped) and single: the same bits;
  * `core.export_params` on a checkpoint directory of the port against
    the JAX `save_params_npz` of the same flat dict, in float16 and
    float32: the same keys, types and bits; the file read by both
    packages' `load_params_npz`; a directory with no checkpoint exits;
  * one subprocess: importing the four modules and `eval.quality` loads
    neither `jax` nor `unirenderer_tpu`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tests.torch_port_helpers import ONE_THREAD_ENV, use_one_thread
from unirenderer_tpu.core import checkpoint as jckpt
from unirenderer_tpu_torch.core import checkpoint as tckpt
from unirenderer_tpu_torch.core import export_params
from unirenderer_tpu_torch.data import light2map, obj2mesh, remove_bg
from unirenderer_tpu_torch.data.hdr import write_hdr
from unirenderer_tpu_torch.data.synthetic import (
    make_env_latlong, make_shape, make_texture,
)
from unirenderer_tpu_torch.render.mesh import (
    auto_normals, make_sphere, unit_normalize_mesh,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT2MAP_REL = 1e-5        # every texel but the seam ones
LIGHT2MAP_SEAM_REL = 1e-2   # at most one texel a level
LIGHT2MAP_ARGS = ["--res", "32", "--min-res", "8", "--samples", "16"]

use_one_thread()


def run_tool(monkeypatch, module, args):
    """A JAX tool's `main` in this process, with `sys.argv` set."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + args)
    return module.main()


def write_obj(path, rng, sphere_res=6, tex_res=8):
    """A deformed sphere (data/synthetic.py's) as OBJ + MTL + map_Kd PNG."""
    base = make_sphere(sphere_res)
    t_idx = np.asarray(base.t_pos_idx)
    v = unit_normalize_mesh(make_shape(np.asarray(base.v_pos), rng))
    n = auto_normals(v, t_idx)
    tex = make_texture(tex_res, rng)
    stem = os.path.splitext(os.path.basename(path))[0]
    with open(path, "w") as f:
        f.write(f"mtllib {stem}.mtl\n")
        for tag, arr in (("v", v), ("vt", np.asarray(base.v_tex)),
                         ("vn", n)):
            f.writelines(f"{tag} " + " ".join(f"{x:.9g}" for x in row)
                         + "\n" for row in arr.tolist())
        f.write(f"usemtl {stem}\n")
        f.writelines("f " + " ".join(f"{i}/{i}/{i}" for i in row) + "\n"
                     for row in (t_idx + 1).tolist())
    Image.fromarray((np.clip(tex, 0, 1) * 255).round().astype(np.uint8)) \
        .save(os.path.join(os.path.dirname(path), f"{stem}.png"))
    with open(os.path.join(os.path.dirname(path), f"{stem}.mtl"), "w") as f:
        f.write(f"newmtl {stem}\nKd 0.7 0.6 0.5\nmap_Kd {stem}.png\n")


def test_obj2mesh_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    import tools.obj2mesh as tool
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(5)
    for rel in ("a.obj", "b.obj", os.path.join("sub", "c.obj")):
        write_obj(str(src / rel), rng)
    (src / "empty.obj").write_text("v 0 0 0\nv 1 0 0\n")    # no faces
    run_tool(monkeypatch, tool, ["--src", str(src), "--dst",
                                 str(tmp_path / "jax"), "--workers", "2"])
    assert obj2mesh.main(["--src", str(src), "--dst", str(tmp_path / "port"),
                          "--workers", "8"]) == 0
    log = capsys.readouterr()
    assert "ok=3 failed=1" in log.out
    assert "failed:" in log.err and "empty.obj" in log.err
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["a.npz", "b.npz", "sub_c.npz"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        obj = str(src / name[:-4].replace("_", os.sep)) + ".obj"
        alone = obj2mesh.mesh_arrays(obj)         # one thread, in process
        with np.load(tmp_path / "jax" / name) as want, \
                np.load(tmp_path / "port" / name) as got:
            assert sorted(got.files) == sorted(want.files) == sorted(alone)
            assert str(got["kd_map"]) == obj[:-4] + ".png"
            for k in want.files:
                assert got[k].dtype == want[k].dtype == alone[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                np.testing.assert_array_equal(got[k], alone[k], err_msg=k)


def test_obj2mesh_stops_when_the_scanner_cannot_build(tmp_path,
                                                      monkeypatch):
    from unirenderer_tpu_torch.data import obj_io
    monkeypatch.setattr(obj_io, "_LIB", None)
    monkeypatch.setattr(obj_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    (tmp_path / "src").mkdir()
    with pytest.raises(RuntimeError, match="failed"):
        obj2mesh.main(["--src", str(tmp_path / "src"), "--dst",
                       str(tmp_path / "dst")])


def test_light2map_matches_the_jax_tool(tmp_path, monkeypatch):
    import tools.light2map as tool
    monkeypatch.delenv("UNIRENDER_PLATFORM", raising=False)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(2)
    write_hdr(str(src / "e0.hdr"), make_env_latlong(rng, 16, 32))
    np.save(src / "e1.npy", make_env_latlong(rng, 16, 32).astype(np.float64))
    (src / "e2.hdr").write_bytes(b"not an hdr")
    run_tool(monkeypatch, tool, ["--src", str(src), "--dst",
                                 str(tmp_path / "jax")] + LIGHT2MAP_ARGS)
    assert light2map.main(["--src", str(src), "--dst", str(tmp_path / "port"),
                           "--device", "cpu"] + LIGHT2MAP_ARGS) == 0
    assert sorted(os.listdir(tmp_path / "jax")) == ["e0", "e1"]
    assert sorted(os.listdir(tmp_path / "port")) == ["e0", "e1"]
    for env in ("e0", "e1"):
        files = sorted(os.listdir(tmp_path / "jax" / env))
        assert files == ["diffuse.npy"] + [f"specular_{i}.npy"
                                           for i in range(3)]
        assert sorted(os.listdir(tmp_path / "port" / env)) == files
        for f in files:
            want = np.load(tmp_path / "jax" / env / f)
            got = np.load(tmp_path / "port" / env / f)
            assert got.dtype == want.dtype == np.float32, f
            assert got.shape == want.shape, f
            err = (np.abs(got - want).max(-1)
                   / np.abs(want).max())                   # per texel
            assert (err > LIGHT2MAP_REL).sum() <= 1, (env, f, err.max())
            assert err.max() <= LIGHT2MAP_SEAM_REL, (env, f, err.max())


def _rgb_png(path, rng, mode="RGB", size=(12, 10)):
    shape = size[::-1] + ((3,) if mode == "RGB" else ())
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(path)


def test_remove_bg_matches_the_jax_tool(tmp_path, monkeypatch):
    import tools.remove_bg as tool
    rng = np.random.default_rng(0)
    images, masks = tmp_path / "images", tmp_path / "masks"
    images.mkdir()
    masks.mkdir()
    for name in ("a.png", "b.png", "c.png"):
        _rgb_png(images / name, rng)
    for name in ("a.png", "b.png"):                      # c.png: no mask
        _rgb_png(masks / name, rng, mode="L")
    for side, fn in (("jax", tool.main), ("port", remove_bg.main)):
        fn(["--images", str(images), "--masks", str(masks), "--out",
            str(tmp_path / side)])
        fn(["--image", str(images / "a.png"), "--mask",
            str(masks / "a.png"), "--out", str(tmp_path / f"{side}.png")])
    assert sorted(os.listdir(tmp_path / "port")) == ["a.png", "b.png"]
    for name in ("a.png", "b.png"):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / name)),
            np.asarray(Image.open(tmp_path / "jax" / name)))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_export_params_matches_the_jax_writer(tmp_path, dtype):
    rng = np.random.default_rng(1)
    flat = {"params/conv_in/kernel": rng.standard_normal((3, 3, 4, 8)),
            "params/conv_in/bias": rng.standard_normal(8),
            "params/norm/scale": 1 + rng.standard_normal(8) * 0.1,
            "params/table": np.arange(6, dtype=np.int32).reshape(2, 3)}
    flat = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in flat.items()}
    tckpt.CheckpointManager(str(tmp_path / "ckpt")).save(7, flat, {})
    out = str(tmp_path / "port.npz")
    assert export_params.main(["--ckpt", str(tmp_path / "ckpt"), "--out",
                               out, "--dtype", dtype]) == 0
    want_path = str(tmp_path / "jax.npz")
    jckpt.save_params_npz(want_path, flat, step=7, dtype=dtype)
    with np.load(out) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port_flat, port_step = tckpt.load_params_npz(out)
    jax_tree, jax_step = jckpt.load_params_npz(out)
    assert port_step == jax_step == 7
    for k, v in flat.items():
        node = jax_tree
        for part in k.split("/"):
            node = node[part]
        np.testing.assert_array_equal(port_flat[k], node, err_msg=k)
        if dtype == "float32" or v.dtype.kind != "f":
            np.testing.assert_array_equal(port_flat[k], v, err_msg=k)
        else:
            np.testing.assert_array_equal(port_flat[k],
                                          v.astype(np.float16), err_msg=k)


def test_export_params_refuses_a_directory_without_checkpoint(tmp_path):
    (tmp_path / "empty").mkdir()
    for ckpt in ("empty", "missing"):
        with pytest.raises(SystemExit) as e:
            export_params.main(["--ckpt", str(tmp_path / ckpt), "--out",
                                str(tmp_path / "x.npz")])
        assert "no" in str(e.value.code)
    assert not (tmp_path / "missing").exists()
    assert not (tmp_path / "x.npz").exists()


def test_the_cli_modules_import_no_jax():
    code = ("import sys\n"
            "import unirenderer_tpu_torch.data.obj2mesh\n"
            "import unirenderer_tpu_torch.data.light2map\n"
            "import unirenderer_tpu_torch.data.remove_bg\n"
            "import unirenderer_tpu_torch.core.export_params\n"
            "import unirenderer_tpu_torch.eval.quality\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'unirenderer_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, **ONE_THREAD_ENV})
    assert r.returncode == 0, r.stderr
