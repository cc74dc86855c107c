"""The port's DDIM step and sampler loop against the JAX package, and the
package's imports.

  * `ddim_step` on random latents over every kind of step (the clean end
    at t_next = -1 included) and `sample_loop` ("ddim" and "unipc") with a
    fixed linear model_fn, against the JAX functions in float32:
    max|port - jax| <= 1e-4 * max|jax| (elementwise f32 math in the same
    order; the loop adds no model error);
  * `unirenderer_tpu_torch` imports no JAX and nothing of the JAX package:
    every module of it, imported in a fresh interpreter.
"""

import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unirenderer_tpu_torch
from tests.torch_port_helpers import (
    ONE_THREAD_ENV, assert_rel_close, use_one_thread,
)
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.diffusion import samplers as js
from unirenderer_tpu.diffusion.schedule import (
    DiffusionSchedule as JaxSchedule,
)
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.diffusion import samplers as ts
from unirenderer_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, inference_timesteps,
)

REL = 1e-4

use_one_thread()


@pytest.fixture(scope="module")
def schedules():
    return (JaxSchedule.create(jcfg.DiffusionConfig()),
            DiffusionSchedule.create(tcfg.DiffusionConfig()))


@pytest.mark.parametrize("t,t_next", [(999, 949), (500, 450), (51, 0),
                                      (1, -1), (0, -1)])
def test_ddim_step_matches_jax(schedules, t, t_next):
    jsch, tsch = schedules
    rng = np.random.default_rng(t)
    x, x0 = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
             for _ in range(2))
    want = js.ddim_step(jsch, jnp.asarray(x), jnp.asarray(x0),
                        jnp.asarray(t), jnp.asarray(t_next))
    got = ts.ddim_step(tsch, torch.from_numpy(x), torch.from_numpy(x0),
                       torch.tensor(t), torch.tensor(t_next))
    assert_rel_close(got, np.asarray(want), REL, f"ddim {t} -> {t_next}")
    if t_next < 0:                       # the clean end is the prediction
        np.testing.assert_array_equal(got.numpy(), x0)


@pytest.mark.parametrize("method", ["ddim", "unipc"])
@pytest.mark.parametrize("steps", [3, 20])
def test_sample_loop_matches_jax(schedules, method, steps):
    """model_fn(x, t) = 0.5 x + 1e-4 t: linear in x, and moving with t."""
    jsch, tsch = schedules
    x = np.random.default_rng(steps).standard_normal(
        (2, 4, 4, 4)).astype(np.float32)
    grid = inference_timesteps(1000, steps)
    want = js.sample_loop(jsch, lambda v, t: 0.5 * v + 1e-4 * t,
                          jnp.asarray(x), jnp.asarray(grid, jnp.int32),
                          method)
    got = ts.sample_loop(tsch, lambda v, t: 0.5 * v + 1e-4 * t,
                         torch.from_numpy(x), torch.from_numpy(grid), method)
    assert_rel_close(got, np.asarray(want), REL, f"{method} x {steps}")


def test_sample_loop_refuses_an_unknown_method(schedules):
    with pytest.raises(ValueError, match="ddim"):
        ts.sample_loop(schedules[1], lambda v, t: v, torch.zeros(1),
                       torch.tensor([999, 500]), "euler")


def test_the_port_imports_no_jax():
    """Every module of the package, imported in a fresh interpreter that
    refuses `jax` and `unirenderer_tpu`: none reaches them."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        unirenderer_tpu_torch.__path__, "unirenderer_tpu_torch."))
    assert {"unirenderer_tpu_torch.pipelines",
            "unirenderer_tpu_torch.render.light",
            "unirenderer_tpu_torch.diffusion.samplers",
            "unirenderer_tpu_torch.core.tracing",
            "unirenderer_tpu_torch.core.debug",
            "unirenderer_tpu_torch.data.scene_bank",
            "unirenderer_tpu_torch.data.input_pipeline",
            "unirenderer_tpu_torch.eval.validation",
            "unirenderer_tpu_torch.train.adafactor",
            "unirenderer_tpu_torch.train.vae_train",
            "unirenderer_tpu_torch.train.vae"} <= set(names)
    code = (
        "import importlib, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                  'unirenderer_tpu'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'unirenderer_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, **ONE_THREAD_ENV),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
