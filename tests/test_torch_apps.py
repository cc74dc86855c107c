"""The serving apps of the port against the JAX package, on the CPU:

  * the stdlib HTTP server at tiny() (steps 2, ensemble 1): the page, a
    decompose answered with 6 PNG maps, a repeat of it with the same
    bits, a relight, and the JSON 500 of a request with no image
    (tests/test_http_app.py's checks);
  * `AppBackend._resize` and `make_mask` (uploaded mask, box, point with
    a background click, none; prompts scaled from the upload's size)
    bit-equal to the JAX `AppBackend`'s, built over a stub pipe that
    carries only `cfg.vae.sample_size`, so nothing compiles;
  * `decompose` and `relight` bit-equal to the port's pipeline called
    directly on the same inputs with a generator seeded 0 (the pipeline's
    own parity with JAX is tests/test_torch_inverse.py and
    tests/test_torch_relight.py, through the `_with_noise` entry points);
  * `run_inverse --tiny --device cpu` as a subprocess: 7 map folders and,
    with `--relight-env` (a .hdr the port wrote), relit/0.png;
  * `build_app` raises without gradio;
  * `medium()`'s parameter counts (dual stream, VAE, text encoder) equal
    to the JAX preset's, from `jax.eval_shape` of the inits against the
    port's modules on the meta device, and every field the port's preset
    carries equal to the JAX one's.
"""

import base64
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import types
from http.server import HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unirenderer_tpu.eval.app import AppBackend as JaxAppBackend
from unirenderer_tpu_torch.core import config
from unirenderer_tpu_torch.eval import app as tapp
from unirenderer_tpu_torch.eval.http_app import make_handler
from unirenderer_tpu_torch.pipelines import UniRendererPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2

from torch_port_helpers import ONE_THREAD_ENV, use_one_thread  # noqa: E402,E501

use_one_thread()


@pytest.fixture(scope="module")
def backend():
    pipe = UniRendererPipeline.create(
        config.tiny(), torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    return tapp.AppBackend(pipe, steps=STEPS, ensemble=1)


@pytest.fixture(scope="module")
def server(backend):
    srv = HTTPServer(("127.0.0.1", 0), make_handler(backend))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def _photo(seed, h=24, w=30):
    """A uint8 photo: a random object on a white background."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    img[4:h - 4, 5:w - 5] = rng.integers(0, 200, (h - 8, w - 10, 3))
    return img


def _png_b64(arr_u8):
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(server, path, payload):
    conn = http.client.HTTPConnection(server, timeout=600)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _png(b64s):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64s))))


def test_page_decompose_relight_and_json_error(server, backend):
    conn = http.client.HTTPConnection(server, timeout=60)
    conn.request("GET", "/")
    page = conn.getresponse().read().decode()
    assert "Decompose" in page and "Relight" in page

    body = {"image": _png_b64(_photo(0)), "mask": None, "box": "4,4,26,20",
            "env": None}
    status, out = _post(server, "/api/decompose", body)
    assert status == 200, out
    assert set(out["maps"]) == set(tapp.MAP_NAMES)
    size = backend.size
    for png in out["maps"].values():
        assert _png(png).shape == (size, size, 3)
    status, again = _post(server, "/api/decompose", body)
    assert status == 200 and again == out          # the same bits

    env = np.random.default_rng(1).integers(0, 255, (8, 16, 3), np.uint8)
    status, relit = _post(server, "/api/relight",
                          dict(body, env=_png_b64(env)))
    assert status == 200, relit
    assert _png(relit["maps"]["relit"]).shape == (size, size, 3)

    status, err = _post(server, "/api/decompose", {"image": None})
    assert status == 500 and "no input image" in err["error"]
    status, err = _post(server, "/api/relight",
                        {"image": _png_b64(_photo(0))})
    assert status == 500 and "environment" in err["error"]


def _stub_pipe(size):
    return types.SimpleNamespace(cfg=types.SimpleNamespace(
        vae=types.SimpleNamespace(sample_size=size)))


@pytest.mark.parametrize("prompt", ["mask", "box", "point", "auto"])
def test_resize_and_make_mask_bit_equal_to_jax(prompt):
    size = 32
    jb = JaxAppBackend(_stub_pipe(size))
    tb = tapp.AppBackend(_stub_pipe(size))
    photo = _photo(2, 45, 61)
    img_j, img_t = jb._resize(photo), tb._resize(photo)
    np.testing.assert_array_equal(img_t, img_j)
    upload = None
    if prompt == "mask":
        upload = (_photo(3, 45, 61)[..., 0] < 128).astype(np.uint8) * 255
        upload = np.repeat(upload[..., None], 3, -1)
    box = "6,5,52,38" if prompt == "box" else None
    point = "30,20,-2,-2" if prompt == "point" else None
    want = jb.make_mask(img_j, upload, box, point, orig_hw=photo.shape[:2])
    got = tb.make_mask(img_t, upload, box, point, orig_hw=photo.shape[:2])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_decompose_and_relight_are_the_pipeline(backend):
    photo = _photo(4)
    maps = backend.decompose(photo, None, None, "15,12")
    again = backend.decompose(photo, None, None, "15,12")
    img01 = backend._resize(photo)
    mask01 = backend.make_mask(img01, None, None, "15,12",
                               orig_hw=photo.shape[:2])
    image = torch.from_numpy(img01 * 2 - 1)[None]
    mask = torch.from_numpy(mask01 * 2 - 1)[None]
    out = backend.pipe.real_image2mask_3mod_albedo(
        image=image, mask=mask, generator=torch.Generator().manual_seed(0),
        num_steps=STEPS, ensemble=1)
    for k in tapp.MAP_NAMES:
        x = out[k][0].numpy()
        if x.ndim == 2:
            want = np.asarray(np.clip(np.repeat(x[..., None], 3, -1), 0, 1)
                              * 255, np.uint8)
        else:
            want = np.asarray(np.clip((x + 1) / 2, 0, 1) * 255, np.uint8)
        np.testing.assert_array_equal(maps[k], want)
        np.testing.assert_array_equal(again[k], want)

    env_u8 = np.random.default_rng(5).integers(0, 255, (8, 16, 4), np.uint8)
    relit = backend.relight(photo, None, None, env_u8, point_text="15,12")
    env01 = (env_u8.astype(np.float32) / 255.0) ** 2.2
    want = backend.pipe.relight(
        image=image, mask=mask, new_env=torch.from_numpy(env01[..., :3]),
        generator=torch.Generator().manual_seed(0), num_steps=STEPS,
        ensemble=1)
    np.testing.assert_array_equal(relit, np.asarray(
        np.clip((want[0].numpy() + 1) / 2, 0, 1) * 255, np.uint8))


def test_run_inverse_cli_writes_every_folder(tmp_path):
    from unirenderer_tpu_torch.data.hdr import write_hdr
    from unirenderer_tpu_torch.eval.run_inverse import MAP_FOLDERS
    photo = tmp_path / "in.png"
    Image.fromarray(_photo(6, 40, 40)).save(photo)
    env = tmp_path / "env.hdr"
    write_hdr(str(env), np.exp(np.random.default_rng(7).standard_normal(
        (8, 16, 3))).astype(np.float32))
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "unirenderer_tpu_torch.eval.run_inverse",
           "--image", str(photo), "--out", str(out), "--tiny",
           "--device", "cpu", "--steps", "2", "--ensemble", "2",
           "--box", "4,4,36,36", "--relight-env", str(env)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, **ONE_THREAD_ENV), timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = config.tiny().vae.sample_size
    for name in MAP_FOLDERS + ("relit",):
        img = np.asarray(Image.open(out / name / "0.png"))
        assert img.shape == (res, res, 3), name
    assert len(MAP_FOLDERS) == 7


def test_build_app_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        tapp.build_app(pipe=_stub_pipe(16))


def test_medium_parameter_counts_equal_jax():
    from unirenderer_tpu.core import config as jcfg
    from unirenderer_tpu.models.clip_text import CLIPTextEncoder, blank_ids
    from unirenderer_tpu.models.dual_stream import DualStreamModel
    from unirenderer_tpu.models.vae import AutoencoderKL
    from unirenderer_tpu_torch.models.clip_text import (
        CLIPTextEncoder as TText,
    )
    from unirenderer_tpu_torch.models.dual_stream import (
        DualStreamModel as TDual,
    )
    from unirenderer_tpu_torch.models.vae import AutoencoderKL as TVAE

    jc, tc = jcfg.medium(), config.medium()
    u, s, vs = jc.unet, jc.unet.sample_size, jc.vae.sample_size

    def count_jax(module, *args):
        shapes = jax.eval_shape(lambda k: module.init(k, *args),
                                jax.random.key(0))
        return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))

    want = [
        count_jax(DualStreamModel(u, jnp.float32), jnp.zeros((1, s, s, 4)),
                  jnp.zeros((1, s, s, u.attr_channels)),
                  jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
                  jnp.zeros((1, jc.text.max_length,
                             u.cross_attention_dim))),
        count_jax(AutoencoderKL(jc.vae, jnp.float32),
                  jnp.zeros((1, vs, vs, 3)), jax.random.key(0)),
        count_jax(CLIPTextEncoder(jc.text, jnp.float32),
                  blank_ids(jc.text))]
    with torch.device("meta"):
        mods = [TDual(tc.unet), TVAE(tc.vae), TText(tc.text)]
    got = [sum(p.numel() for p in m.parameters()) for m in mods]
    assert got == want
    assert 300e6 < got[0] < 350e6          # the 328M dual stream
    # every field the port carries has the JAX preset's value, except the
    # compute type the port leaves to the device (None: bf16 on the card)
    import dataclasses
    for part in dataclasses.fields(tc):
        mine, theirs = getattr(tc, part.name), getattr(jc, part.name)
        for f in dataclasses.fields(mine):
            if f.name == "compute_dtype":
                continue
            assert getattr(mine, f.name) == getattr(theirs, f.name), (
                part.name, f.name)


def test_build_backend_loads_npz_and_checkpoint_dirs(tmp_path):
    """`build_backend` at tiny() on the CPU (f32): the dual-stream params
    from a checkpoint directory and the VAE's from a `.npz`, loaded
    strictly; a directory with no checkpoint raises."""
    from unirenderer_tpu_torch.core.checkpoint import (
        CheckpointManager, save_params_npz,
    )
    from unirenderer_tpu_torch.core.convert import flax_from_module
    from unirenderer_tpu_torch.eval.http_app import build_backend
    src = UniRendererPipeline.create(
        config.tiny(), torch.Generator().manual_seed(5), device="cpu",
        dtype=torch.float32)
    CheckpointManager(str(tmp_path / "ckpt")).save(
        3, flax_from_module(src.dual), {})
    save_params_npz(str(tmp_path / "vae.npz"), flax_from_module(src.vae))
    b = build_backend("tiny", str(tmp_path / "ckpt"),
                      str(tmp_path / "vae.npz"), 2, 1, device="cpu")
    assert b.pipe.device.type == "cpu" and b.size == 16
    for mine, want in ((b.pipe.dual, src.dual), (b.pipe.vae, src.vae)):
        for (k, p), q in zip(mine.state_dict().items(),
                             want.state_dict().values()):
            assert torch.equal(p, q), k
    assert not torch.equal(next(b.pipe.text.parameters()),
                           next(src.text.parameters()))   # not loaded
    with pytest.raises(FileNotFoundError):
        build_backend("tiny", str(tmp_path / "empty"), None, 2, 1, "cpu")
