"""`python -m unirenderer_tpu_torch.eval.quality` with tools/eval_quality.py's
flags, against that tool, at tiny() on the CPU:

  * the report's keys (and those of its `psnr_maps` and `normal_angle`)
    equal the JAX tool's: its `main` run in-process with its pipeline
    replaced by one that returns its inputs (the keys come from `main`,
    not from the model), the port with JAX's text-encoder draw handed in
    through the Python entry point;
  * `--synthetic` batches equal the JAX tool's `_synthetic_batches`, and
    `--mesh-dir` / `--env-dir` batches (ObjaverseDataTest, seed 1234,
    batches of 4) the JAX tool's collates of the same directories: maps
    within the collate's 1e-4 (tests/test_torch_render.py), material
    scalars equal;
  * `--ckpt` / `--vae-ckpt` as checkpoint directories written by the
    train and VAE CLIs (2 steps each) and as their f32 exports
    (`core.export_params`) give the same report but for its "checkpoint"
    path; the dump grid's geometry is the JAX tool's, and
    `--dump-max-batches` caps the grids as it does there (0: none);
  * a `--ckpt` or `--vae-ckpt` with no checkpoint aborts before scoring;
  * with none of those flags the CLI takes the r05 small() path as
    before.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_helpers import flatten, use_one_thread
from unirenderer_tpu import pipelines as jpipelines
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.data import objaverse as jdata
from unirenderer_tpu.models.clip_text import init_text_encoder
from unirenderer_tpu.utils import runtime as jruntime
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core import export_params
from unirenderer_tpu_torch.data import synthetic
from unirenderer_tpu_torch.eval import quality
from unirenderer_tpu_torch.train.__main__ import main as train_main
from unirenderer_tpu_torch.train.vae import main as vae_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLATE_ABS = 1e-4
MAPS = ("image", "normal", "albedo", "spec_light", "diff_light", "env",
        "mask", "material")

use_one_thread()


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "eval_quality_tool", os.path.join(REPO, "tools", "eval_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class EchoPipeline:
    """Stands in for the JAX pipeline: forward returns the normal map,
    inverse returns the image as every map."""

    @classmethod
    def create(cls, cfg, key, dtype):
        return cls()

    def mask2image_3mod_albedo(self, **kw):
        return kw["normal"]

    def real_image2mask_3mod_albedo(self, image, mask, rng, num_steps,
                                    ensemble):
        zeros = jnp.zeros(image.shape[:3])
        return dict(normal=image, albedo=image, spec_light=image,
                    diff_light=image, metallic=zeros, roughness=zeros)


def jax_text_draw(cfg):
    """The text encoder JAX's `UniRendererPipeline.create(cfg, key(0))`
    draws."""
    _, _, k_text = jax.random.split(jax.random.key(0), 3)
    _, params = init_text_encoder(cfg.text, k_text, jnp.float32)
    return flatten(params)


def port_args(*extra):
    return ["--synthetic", "--tiny", "--n", "2", "--steps", "2", "--device",
            "cpu", *extra]


def test_report_keys_are_the_jax_tools(tmp_path, monkeypatch):
    monkeypatch.setattr(jpipelines, "UniRendererPipeline", EchoPipeline)
    # no persistent compile cache for the rest of this process
    monkeypatch.setattr(jruntime, "setup_runtime", lambda: None)
    jax_tool().main(["--synthetic", "--tiny", "--n", "2", "--steps", "1",
                     "--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = quality.main(port_args("--out",
                                 str(tmp_path / "port.json")),
                       text=jax_text_draw(jcfg.tiny()))
    assert got == json.loads((tmp_path / "port.json").read_text())
    assert list(got) == list(want)
    for k in ("psnr_maps", "normal_angle"):
        assert list(got[k]) == list(want[k]), k
    assert got["checkpoint_loaded"] is False and got["checkpoint_step"] is None
    assert got["checkpoint"] == want["checkpoint"]
    assert got["n_objects"] == 2 and got["steps"] == 2
    assert all(np.isfinite(got["psnr_maps"][k]) for k in got["psnr_maps"])


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in MAPS:
            a, b = g[k].numpy(), np.asarray(w[k])
            assert a.shape == b.shape, k
            np.testing.assert_allclose(a, b, atol=COLLATE_ABS, rtol=0,
                                       err_msg=k)
        for k in ("metallic", "roughness"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_synthetic_batches_are_the_jax_tools():
    res = tcfg.tiny().vae.sample_size
    want = jax_tool()._synthetic_batches(jcfg.tiny(), 5, res)
    got = quality.synthetic_batches(tcfg.tiny(), 5, "cpu")
    assert [len(b["metallic"]) for b in got] == [2, 2, 1]
    _same_batches(got, want)


def test_mesh_dir_batches_are_the_jax_tools(tmp_path):
    synthetic.write_dataset(str(tmp_path), n_mesh=3, n_env=2, env_res=8,
                            env_min_res=4, env_samples=8, sphere_res=6,
                            tex_res=8, seed=3, device="cpu")
    meshes, envs = quality.held_out_paths(str(tmp_path))
    cfg = tcfg.tiny()
    res = cfg.vae.sample_size
    ds = jdata.ObjaverseDataTest(jcfg.tiny().data, meshes, envs, seed=1234)
    items = [ds[i % len(ds)] for i in range(5)]
    want = [jdata.collate_render(items[i:i + 4], resolution=res)
            for i in range(0, 5, 4)]

    pipe = SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    got = quality._held_out_batches(pipe, meshes, envs, 5)
    _same_batches(got, want)


def test_checkpoint_directory_and_export_give_the_same_report(tmp_path):
    work = tmp_path / "run"
    assert train_main(["--workdir", str(work), "--tiny", "--synthetic",
                       "--steps", "2", "--device", "cpu"]) == 0
    assert vae_main(["--workdir", str(work), "--tiny", "--synthetic",
                     "--steps", "2", "--batch", "2", "--device", "cpu"]) == 0
    dirs = (str(work / "checkpoints"), str(work / "vae_checkpoints"))
    npzs = (str(tmp_path / "dual.npz"), str(tmp_path / "vae.npz"))
    for d, out in zip(dirs, npzs):
        assert export_params.main(["--ckpt", d, "--out", out, "--dtype",
                                   "float32"]) == 0
    reports = []
    for dual, vae in (dirs, npzs):
        grids = tmp_path / f"grids_{len(reports)}"
        reports.append(quality.main(port_args(
            "--ckpt", dual, "--vae-ckpt", vae, "--dump-images",
            str(grids), "--out", str(tmp_path / f"r{len(reports)}.json"))))
        b, h = 2, tcfg.tiny().vae.sample_size
        assert Image.open(grids / "eval_grid_b0.png").size == (
            5 * (h + 2) + 2, b * 2 * (h + 2) + 2)
    a, b = reports
    assert a["checkpoint"] == dirs[0] and b["checkpoint"] == npzs[0]
    assert a["checkpoint_loaded"] and a["checkpoint_step"] == 2
    a.pop("checkpoint"), b.pop("checkpoint")
    assert a == b


@pytest.mark.parametrize("cap, grids", [(None, 2), (0, 0), (1, 1)])
def test_dump_max_batches_caps_the_grids(tmp_path, cap, grids):
    """3 batches: the JAX tool's default of 2 grids, and an explicit 0
    writes none."""
    flags = [] if cap is None else ["--dump-max-batches", str(cap)]
    quality.main(port_args("--n", "6", "--steps", "1", "--dump-images",
                           str(tmp_path / "grids"), "--out",
                           str(tmp_path / "r.json"), *flags))
    written = (sorted(os.listdir(tmp_path / "grids"))
               if (tmp_path / "grids").exists() else [])
    assert written == [f"eval_grid_b{i}.png" for i in range(grids)]


@pytest.mark.parametrize("flag", ["--ckpt", "--vae-ckpt"])
def test_an_empty_checkpoint_directory_aborts(tmp_path, flag):
    (tmp_path / "empty").mkdir()
    out = tmp_path / "report.json"
    with pytest.raises(SystemExit) as e:
        quality.main(port_args(flag, str(tmp_path / "empty"),
                               "--out", str(out)))
    assert e.value.code not in (0, None)
    assert "refusing to eval random weights" in str(e.value.code)
    assert not out.exists()


def test_the_default_invocation_is_the_r05_small_run(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake_pipeline(device, dtype):
        seen["pipeline"] = (device, dtype)
        return type("P", (), {"cfg": tcfg.small()})()

    def fake_scores(pipe, n, num_steps, noise_seeds, **kw):
        seen["scores"] = (n, num_steps, noise_seeds, kw["inverse"],
                          kw["ensemble"])
        raise Stop

    def no_tool(*a, **kw):
        raise AssertionError("the JAX tool's run")

    monkeypatch.setattr(quality, "small_trained_pipeline", fake_pipeline)
    monkeypatch.setattr(quality, "held_out_scores", fake_scores)
    monkeypatch.setattr(quality, "tool_main", no_tool)
    with pytest.raises(Stop):
        quality.main(["--device", "cpu"])
    assert seen == {"pipeline": ("cpu", torch.float32),
                    "scores": (32, 20, [1000], False, 1)}
    with pytest.raises(Stop):
        quality.main(["--device", "cpu", "--inverse", "--noise-seeds",
                      "1000,2000", "--dtype", "bfloat16"])
    assert seen == {"pipeline": ("cpu", torch.bfloat16),
                    "scores": (32, 20, [1000, 2000], True, 1)}
    with pytest.raises(SystemExit):                 # no noise seeds there
        quality.main(["--synthetic", "--noise-seeds", "7"])
