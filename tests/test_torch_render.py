"""The renderer, the render collate, the data generator and the forward
PSNR leg of the port against the JAX package.

The same meshes, environments, cameras and materials (seeded numpy) go to
both packages, f32 on the CPU.  Tolerances, each with its test:
`render_mesh` buffers within 2e-4 (cubemap, texture and FG lookups of f32
values of order 1, a few rounding steps apart) on pixels whose winning
triangle agrees in a 3x3 neighbourhood (the texture level reads the
neighbours), which must be >= 98 % of the image; the collate's maps,
SSAA-pooled, within 1e-4 (the same lookups, averaged over 4
subsamples); the generator's meshes and textures
exactly equal (the same numpy calls), its env mips within 1e-4 (the
prefilter's f32 sums, see test_torch_render_ops.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import torch
from scipy.ndimage import minimum_filter

from unirenderer_tpu.data import objaverse as jdata
from unirenderer_tpu.eval import metrics as jmetrics
from unirenderer_tpu.ops.rasterize import rasterize as jax_rasterize
from unirenderer_tpu.ops.transform import xfm_points as jax_xfm_points
from unirenderer_tpu.render import camera as jcam
from unirenderer_tpu.render import render as jrender
from unirenderer_tpu.render.light import EnvLight as JaxEnv
from unirenderer_tpu.render.mesh import make_sphere as jax_make_sphere
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.data import objaverse as tdata
from unirenderer_tpu_torch.data import synthetic
from unirenderer_tpu_torch.eval import metrics as tmetrics
from unirenderer_tpu_torch.eval.quality import (
    _held_out_batches, held_out_paths, tool_scores,
)
from unirenderer_tpu_torch.ops.rasterize import rasterize
from unirenderer_tpu_torch.pipelines import UniRendererPipeline
from unirenderer_tpu_torch.render import camera as tcam
from unirenderer_tpu_torch.render import render as trender
from unirenderer_tpu_torch.render.light import EnvLight
from unirenderer_tpu_torch.render.mesh import Mesh, make_sphere

MAPS = ("image", "mask", "material", "normal", "albedo", "spec_light",
        "diff_light", "env")

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def _t(x):
    return torch.from_numpy(np.array(x))


def _env(rng, sizes=(16, 8, 4)):
    spec = [rng.random((6, r, r, 3), dtype=np.float32) * 2 for r in sizes]
    diff = rng.random((6, sizes[-1], sizes[-1], 3), dtype=np.float32)
    return spec, diff


def test_camera_matches_jax():
    """1e-6: f32 trigonometry and 4x4 products of values of order 1."""
    for az, el, d in ((0.0, 90.0, 4.0), (137.0, 64.0, 3.0),
                      (291.5, 118.0, 2.5)):
        mvp, cp = tcam.spherical_camera(az, el, d)
        jmvp, jcp = jcam.spherical_camera(az, el, d)
        np.testing.assert_allclose(mvp.numpy(), np.asarray(jmvp), atol=1e-6)
        np.testing.assert_allclose(cp.numpy(), np.asarray(jcp), atol=1e-6)
        np.testing.assert_allclose(
            tcam.canonical_normal_rotation(az, el).numpy(),
            np.asarray(jcam.canonical_normal_rotation(az, el)), atol=1e-6)
    np.testing.assert_allclose(tcam.fov_to_intrinsics(30.0).numpy(),
                               np.asarray(jcam.fov_to_intrinsics(30.0)))


def test_make_sphere_matches_jax():
    for res in (4, 9):
        a, b = make_sphere(res), jax_make_sphere(res)
        for f in ("v_pos", "t_pos_idx", "v_nrm", "v_tex", "v_tng"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)))


def test_render_mesh_sphere_all_buffers_match_jax():
    """Two views of a textured sphere in one batched call against the JAX
    renderer view by view, all 8 buffers (tolerance in the module doc)."""
    rng = np.random.default_rng(0)
    m = make_sphere(10)
    spec, diff = _env(rng)
    kd = rng.random((16, 16, 3), dtype=np.float32)
    res = 48
    views = [(30.0, 70.0, 3.2, 0.3, 0.5), (200.0, 110.0, 3.0, 0.7, 0.2)]
    cams = [jcam.spherical_camera(az, el, d) for az, el, d, _, _ in views]
    mvps = np.stack([np.asarray(c[0]) for c in cams])
    cps = np.stack([np.asarray(c[1]) for c in cams])

    def two(x):
        return _t(np.stack([x, x]))

    mesh = Mesh(v_pos=two(m.v_pos), t_pos_idx=two(m.t_pos_idx),
                v_nrm=two(m.v_nrm), v_tex=two(m.v_tex), v_tng=two(m.v_tng))
    env = EnvLight(specular=tuple(two(s) for s in spec), diffuse=two(diff))
    got = trender.render_mesh(
        mesh, _t(mvps), _t(cps), env,
        _t(np.float32([v[3] for v in views])),
        _t(np.float32([v[4] for v in views])), res, kd_texture=two(kd))
    assert set(got) == {"shaded", "spec_light", "diff_light", "gb_normal",
                        "normal", "albedo", "depth", "mask"}
    jm = jax_make_sphere(10)
    jenv = JaxEnv(tuple(jnp.asarray(s) for s in spec), jnp.asarray(diff))
    for i, (_, _, _, met, rgh) in enumerate(views):
        want = jrender.render_mesh(jm, jnp.asarray(mvps[i]),
                                   jnp.asarray(cps[i]), jenv, met, rgh, res,
                                   kd_texture=jnp.asarray(kd))
        pos = jax_xfm_points(jnp.asarray(m.v_pos)[None],
                             jnp.asarray(mvps[i])[None])[0]
        id_jax = np.asarray(jax_rasterize(pos, jnp.asarray(m.t_pos_idx),
                                          res, res).tri_id)
        id_port = rasterize(_t(pos), _t(m.t_pos_idx), res, res).tri_id
        agree = minimum_filter((id_jax == id_port.numpy()).astype(np.uint8),
                               size=3, mode="nearest") > 0
        assert agree.mean() >= 0.98 and (id_jax > 0).mean() > 0.3
        for k, w in want.items():
            g = got[k][i].numpy()
            assert g.shape == w.shape, k
            assert np.isfinite(g).all(), k
            np.testing.assert_allclose(g[agree], np.asarray(w)[agree],
                                       atol=2e-4, rtol=0, err_msg=k)


def _scene_item(rng, az, el, metallic, roughness):
    m = make_sphere(8)
    v = m.v_pos * rng.uniform(0.6, 1.0, 3).astype(np.float32)
    tex = rng.random((8, 8, 3), dtype=np.float32)
    mesh = {"v_pos": v, "t_idx": m.t_pos_idx, "v_nrm": m.v_nrm,
            "v_tex": m.v_tex, "v_tng": m.v_tng, "kd": tex.mean((0, 1)),
            "kd_tex": tex}
    mesh = tdata.pad_mesh(mesh, 160, 320)
    spec, diff = _env(rng, (8, 4))
    env = {"specular_0": spec[0], "specular_1": spec[1], "diffuse": diff}
    return dict(mesh=mesh, env=env, metallic=metallic, roughness=roughness,
                azimuth=az, elevation=el, distance=2.8)


def test_collate_render_matches_jax():
    """The same two items through both collates (one JAX compile): all 8
    maps and the material scalars (tolerance in the module doc)."""
    rng = np.random.default_rng(1)
    items = [_scene_item(rng, 20.0, 75.0, 0.2, 0.6),
             _scene_item(rng, 250.0, 120.0, 0.9, 0.1)]
    want = jdata.collate_render(items, resolution=16, ssaa=2)
    got = tdata.collate_render(items, resolution=16, ssaa=2, device="cpu")
    for k in MAPS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (2, 16, 16, 3), k
        assert np.isfinite(g).all() and g.min() >= -1.001 \
            and g.max() <= 1.001, k
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)
    for k in ("metallic", "roughness"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (got["mask"] > 0).float().mean() > 0.2


def test_dataset_items_match_jax(tmp_path):
    """The test split samples the same items (random.Random(seed) in the
    same call order) and pads them alike."""
    synthetic.write_dataset(str(tmp_path), n_mesh=3, n_env=2, env_res=8,
                            env_min_res=4, env_samples=8, sphere_res=6,
                            tex_res=8, seed=5, device="cpu")
    meshes, envs = held_out_paths(str(tmp_path))
    cfg = tcfg.small().data
    from unirenderer_tpu.core import config as jcfg
    ours = tdata.ObjaverseDataTest(cfg, meshes, envs, seed=1234)
    theirs = jdata.ObjaverseDataTest(jcfg.small().data, meshes, envs,
                                     seed=1234)
    for i in range(5):
        a, b = ours[i % 3], theirs[i % 3]
        for k in ("metallic", "roughness", "azimuth", "elevation",
                  "distance"):
            assert a[k] == b[k], k
        for k in b["mesh"]:
            np.testing.assert_array_equal(a["mesh"][k], b["mesh"][k])
        for k in b["env"]:
            np.testing.assert_array_equal(a["env"][k], b["env"][k])
    assert tdata.material_grid(11) == jdata.material_grid(11)
    img = np.random.default_rng(2).random((7, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdata._resize_bilinear(img, 8),
                                  jdata._resize_bilinear(img, 8))


def test_generator_matches_the_jax_tool(tmp_path):
    """tools/make_synthetic_data.py against data/synthetic.py at
    --n-mesh 2 --n-env 1 (small env and sphere): meshes and textures equal,
    env mips within 1e-4."""
    import tools.make_synthetic_data as tool
    args = ["--n-mesh", "2", "--n-env", "1", "--env-res", "16",
            "--env-min-res", "4", "--env-samples", "32", "--sphere-res", "8",
            "--tex-res", "16", "--seed", "7"]
    tool.main(["--out", str(tmp_path / "jax")] + args)
    synthetic.main(["--out", str(tmp_path / "port"), "--device", "cpu"]
                   + args)
    for name in ("m000.npz", "m001.npz"):
        a = np.load(tmp_path / "port" / "meshes" / name)
        b = np.load(tmp_path / "jax" / "meshes" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ja, jb = tmp_path / "port" / "envs" / "e00", tmp_path / "jax" / "envs" / "e00"
    assert sorted(os.listdir(ja)) == sorted(os.listdir(jb))
    for f in os.listdir(jb):
        np.testing.assert_allclose(np.load(ja / f), np.load(jb / f),
                                   atol=1e-4, rtol=0, err_msg=f)


def test_psnr_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.random((2, 8, 8, 3))
    b = a + rng.normal(0, 0.05, a.shape)
    assert tmetrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert tmetrics.psnr(a, a) == float("inf")


def test_forward_psnr_runs_the_held_out_leg(tmp_path):
    """The forward leg end to end at tiny(): held-out set, collate,
    forward render with material_image_encode, PSNR per batch; the same
    noise seed gives the same score."""
    synthetic.write_dataset(str(tmp_path), n_mesh=3, n_env=2, env_res=8,
                            env_min_res=4, env_samples=8, sphere_res=6,
                            tex_res=8, seed=3, device="cpu")
    meshes, envs = held_out_paths(str(tmp_path))
    pipe = UniRendererPipeline.create(
        tcfg.tiny(), torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    runs = [tool_scores(pipe, _held_out_batches(pipe, meshes, envs, 5), 2,
                        inverse=False, seed_base=s) for s in (10, 10, 11)]
    assert len(runs[0]["per_batch"]) == 2
    assert np.isfinite(runs[0]["psnr_forward_render"])
    assert runs[0]["psnr_forward_render"] == runs[1]["psnr_forward_render"]
    assert runs[0]["psnr_forward_render"] != runs[2]["psnr_forward_render"]


def test_inverse_scores_run_the_held_out_leg(tmp_path):
    """The inverse leg end to end at tiny(): held-out set, collate,
    `real_image2mask_3mod_albedo` at ensemble 2, per-map PSNR, normal
    angle, masked MR error; the same noise seed gives the same scores."""
    synthetic.write_dataset(str(tmp_path), n_mesh=3, n_env=2, env_res=8,
                            env_min_res=4, env_samples=8, sphere_res=6,
                            tex_res=8, seed=3, device="cpu")
    meshes, envs = held_out_paths(str(tmp_path))
    pipe = UniRendererPipeline.create(
        tcfg.tiny(), torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    runs = [tool_scores(pipe, _held_out_batches(pipe, meshes, envs, 5), 1,
                        2, seed_base=s) for s in (10, 10, 11)]
    for run in runs:
        run.pop("seconds")
    r = runs[0]
    assert set(r["psnr_maps"]) == {"normal", "albedo", "spec_light",
                                   "diff_light"}
    assert all(np.isfinite(v) for v in r["psnr_maps"].values())
    assert 0 <= r["normal_angle"]["mean"] <= 180
    assert 0 <= r["metal_rough_mae"] <= 1
    assert r == runs[1]
    assert r["psnr_maps"] != runs[2]["psnr_maps"]
