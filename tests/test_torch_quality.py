"""The held-out quality harness of the PyTorch port
(`unirenderer_tpu_torch/eval/`) against the JAX harness.

  * the committed text encoder (`artifacts/r05/text_small.npz`, written by
    tools/export_text_params_r05.py) is exactly the one the JAX harness
    draws (`UniRendererPipeline.create(small(), key(0), f32)`: its text
    encoder from the third key of `split(key(0), 3)`), and loaded into the
    port it gives JAX's blank-prompt context to 1e-5 (f32; summation order
    only, |ctx| up to ~3);
  * the normal-angle metric and the masked mean against the JAX package's
    `NormalMetric` and tools/eval_quality.py's `_masked_mean`: 1e-12 (the
    same float64 numpy arithmetic).

The inverse leg end to end is tests/test_torch_render.py's
`test_inverse_scores_run_the_held_out_leg`, beside the forward leg's (the
render collate computes its FG table once per test process).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_port_helpers import flatten
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.eval import metrics as jmetrics
from unirenderer_tpu.models.clip_text import (
    CLIPTextEncoder, blank_ids, init_text_encoder,
)
from unirenderer_tpu_torch.core.checkpoint import load_params_npz
from unirenderer_tpu_torch.eval import metrics as tmetrics
from unirenderer_tpu_torch.eval.quality import (
    TEXT_NPZ, small_trained_pipeline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def test_text_params_are_the_jax_harness_draw():
    cfg = jcfg.small()
    _, _, k_text = jax.random.split(jax.random.key(0), 3)
    _, params = init_text_encoder(cfg.text, k_text, jnp.float32)
    want = flatten(params)
    saved, _ = load_params_npz(os.path.join(REPO, TEXT_NPZ))
    assert set(saved) == set(want) and len(want) == 36
    for k, v in want.items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)

    # the harness's pipeline carries it: its blank context is JAX's
    ctx = CLIPTextEncoder(cfg.text, jnp.float32).apply(
        params, blank_ids(cfg.text))
    pipe = small_trained_pipeline("cpu", torch.float32, root=REPO)
    got = pipe.blank_context(1)
    assert got.shape == ctx.shape
    assert np.abs(np.asarray(ctx)).max() > 1.0
    assert np.abs(got.numpy() - np.asarray(ctx)).max() <= 1e-5


def test_normal_metric_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(-1, 1, (3, 16, 16, 3))
    gt = pred + rng.normal(0, 0.3, pred.shape)
    mask = rng.uniform(size=(3, 16, 16)) > 0.4
    ours, theirs = tmetrics.NormalMetric(), jmetrics.NormalMetric()
    for m in (ours, theirs):
        m.update(pred, gt, mask)
        m.update(pred[:1], gt[:1])
    a, b = ours.summary(), theirs.summary()
    assert set(a) == set(b) == {"mean", "median", "rmse", "a1", "a2", "a3"}
    for k in b:
        assert abs(a[k] - b[k]) <= 1e-12, k


def test_masked_mean_matches_the_jax_harness():
    spec = importlib.util.spec_from_file_location(
        "eq", os.path.join(REPO, "tools", "eval_quality.py"))
    eq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eq)
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=(2, 16, 16)) > 0.5
    for side in (16, 8, 5):           # the image's size, a latent's, odd
        maps = rng.uniform(size=(2, side, side)).astype(np.float32)
        np.testing.assert_allclose(tmetrics.masked_mean(maps, mask),
                                   eq._masked_mean(maps, mask), rtol=1e-12)
