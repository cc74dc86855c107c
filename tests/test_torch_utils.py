"""The port's utilities against the JAX package's, on the CPU:

  * `utils/fast_init.shape_init` with each fill and with `cast`, bit-equal
    to JAX's `shape_init` on the tiny() dual stream (JAX traces its init
    with `jax.eval_shape` only; no flax init runs);
  * `models/introspect.capture_activations` on a tiny `Transformer2D` and
    a `ResnetBlock`: the keys of JAX's `capture_intermediates` on the flax
    modules with the same parameters, values within 1e-5 relative;
    `diff_activations` and `assert_activations_close` give JAX's rows and
    messages on the same captures;
  * `utils/runtime.setup_runtime`: UNIRENDER_PLATFORM and
    UNIRENDER_COMPILE_CACHE, and the training CLI run on the platform's
    device.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    assert_rel_close, flatten, flax_shapes, random_params, use_one_thread,
)

use_one_thread()

from unirenderer_tpu.core import config as jcfg  # noqa: E402
from unirenderer_tpu.models import introspect as jintro  # noqa: E402
from unirenderer_tpu.models import layers as jl  # noqa: E402
from unirenderer_tpu.models.dual_stream import DualStreamModel as JaxDual  # noqa: E402,E501
from unirenderer_tpu.utils.fast_init import shape_init as jax_shape_init  # noqa: E402,E501
from unirenderer_tpu_torch.core import config as tcfg  # noqa: E402
from unirenderer_tpu_torch.core.convert import flax_from_module, load_flax  # noqa: E402,E501
from unirenderer_tpu_torch.models import introspect  # noqa: E402
from unirenderer_tpu_torch.models import layers as tl  # noqa: E402
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel  # noqa: E402,E501
from unirenderer_tpu_torch.utils.fast_init import shape_init  # noqa: E402
from unirenderer_tpu_torch.utils.runtime import setup_runtime  # noqa: E402


# ---------------------------------------------------------------------------
# shape_init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill,cast", [("scaled_normal", None),
                                       ("normal", None), ("zeros", None),
                                       ("scaled_normal", "bfloat16")])
def test_shape_init_matches_jax(fill, cast):
    cfg = jcfg.tiny()
    u, s = cfg.unet, cfg.unet.sample_size
    dual = JaxDual(u, jnp.float32)

    def init_fn():
        return dual.init(
            jax.random.key(0), jnp.zeros((1, s, s, 4)),
            jnp.zeros((1, s, s, u.attr_channels)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, cfg.text.max_length, u.cross_attention_dim)))

    want = flatten(jax_shape_init(
        init_fn, fill=fill, seed=3,
        cast=None if cast is None else getattr(jnp, cast)))
    module = shape_init(lambda: DualStreamModel(tcfg.tiny().unet), fill=fill,
                        seed=3, device="cpu",
                        cast=None if cast is None else getattr(torch, cast))
    if cast is not None:
        assert all(p.dtype == torch.bfloat16 for p in module.parameters())
    got = flax_from_module(module)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w).astype(np.float32)
        assert np.array_equal(got[k], w), k
    if fill != "zeros":
        assert np.std(got["params/unet/conv_in/kernel"]) > 0.01


def test_shape_init_rejects_unknown_fill_and_a_missing_card():
    with pytest.raises(ValueError, match="fill"):
        shape_init(lambda: tl.ZeroConv(4), fill="ones", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            shape_init(lambda: tl.ZeroConv(4))         # default: the card


# ---------------------------------------------------------------------------
# Activation capture
# ---------------------------------------------------------------------------

def _transformer_case():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 24)).astype(np.float32)
    jmod = jl.Transformer2D(num_heads=2, num_layers=2, num_groups=8)
    tmod = tl.Transformer2D(32, 2, 24, num_layers=2, num_groups=8)
    return jmod, tmod, (x, ctx)


def _resnet_case():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    temb = rng.standard_normal((2, 64)).astype(np.float32)
    jmod = jl.ResnetBlock(out_channels=32, num_groups=8)
    tmod = tl.ResnetBlock(16, 32, num_groups=8, temb_dim=64)
    return jmod, tmod, (x, temb)


@pytest.fixture(scope="module", params=["transformer2d", "resnet"])
def captures(request):
    jmod, tmod, args = {"transformer2d": _transformer_case,
                        "resnet": _resnet_case}[request.param]()
    params = random_params(flax_shapes(jmod, *args), 5)
    flat = flatten(params["params"])
    assert load_flax(tmod, flat) == len(flat)
    want = jintro.capture_activations(jmod, params,
                                      *(jnp.asarray(a) for a in args))
    got = introspect.capture_activations(
        tmod, *(torch.from_numpy(a) for a in args))
    return want, got


def test_capture_keys_and_values_match_jax(captures):
    want, got = captures
    assert set(got) == set(want)
    assert "__call__" in got and len(got) >= 7
    for k, w in want.items():
        assert_rel_close(got[k], np.asarray(w), 1e-5, k)


def test_diff_and_assert_match_jax(captures):
    want, got = captures
    assert introspect.diff_activations(want, got, top_k=50) == \
        jintro.diff_activations(want, got, top_k=50)
    introspect.assert_activations_close(want, got, atol=1e-4)
    jintro.assert_activations_close(want, got, atol=1e-4)
    drifted = {k: (np.asarray(v) + (0.5 if i % 3 == 0 else 0.0))
               for i, (k, v) in enumerate(sorted(want.items()))}
    rows = introspect.diff_activations(want, drifted)
    assert rows == jintro.diff_activations(want, drifted)
    assert rows[0][1] == pytest.approx(0.5, rel=1e-6)
    with pytest.raises(AssertionError) as mine:
        introspect.assert_activations_close(want, drifted, atol=1e-3)
    with pytest.raises(AssertionError) as theirs:
        jintro.assert_activations_close(want, drifted, atol=1e-3)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# setup_runtime
# ---------------------------------------------------------------------------

def test_setup_runtime_platform(monkeypatch):
    monkeypatch.setenv("UNIRENDER_PLATFORM", "cpu")
    assert setup_runtime() == torch.device("cpu")
    monkeypatch.setenv("UNIRENDER_PLATFORM", "gpu")
    assert setup_runtime("cpu") == torch.device("cpu")   # --device wins
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            setup_runtime()
        monkeypatch.delenv("UNIRENDER_PLATFORM")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            setup_runtime()                          # the default: cuda
    monkeypatch.setenv("UNIRENDER_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="UNIRENDER_PLATFORM"):
        setup_runtime()


def test_setup_runtime_compile_cache(monkeypatch, tmp_path):
    from unirenderer_tpu_torch.data import obj_io
    from unirenderer_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(obj_io, "BUILD_DIR", obj_io.BUILD_DIR)
    setup_runtime("cpu")
    assert _build.BUILD_DIR == Path(__file__).resolve().parents[1] / \
        "unirenderer_tpu_torch" / "_build"
    monkeypatch.setenv("UNIRENDER_COMPILE_CACHE", str(tmp_path / "kc"))
    setup_runtime("cpu")
    assert _build.BUILD_DIR == obj_io.BUILD_DIR == (tmp_path / "kc").resolve()
    assert _build.library_path("groupnorm").parent == _build.BUILD_DIR


def test_train_cli_runs_on_the_platform_device(monkeypatch, tmp_path):
    """No --device: UNIRENDER_PLATFORM=cpu puts the CLI on the CPU."""
    from unirenderer_tpu_torch.train.__main__ import main
    monkeypatch.setenv("UNIRENDER_PLATFORM", "cpu")
    work = tmp_path / "run"
    assert main(["--workdir", str(work), "--tiny", "--synthetic",
                 "--steps", "1"]) == 0
    rec = json.loads((work / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["step"] == 1 and np.isfinite(rec["loss"])
    assert os.path.isdir(work / "checkpoints" / "checkpoint-1")
