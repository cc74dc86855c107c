"""One full train step of the port (gradients, global-norm clipping, AdamW)
against the JAX package's `make_train_step`, its checkpoints against the
JAX reader, and the training loop, at `tiny()` on the CPU.

  * one step at lr 1e-3 from the same seeded weights, on an inverse and
    on a forward draw, fed the JAX step's own draws (`fold_in(rng, step)`, then its `split(rng, 7)`): the
    loss terms and the pre-clip `grad_norm` to 1e-4 relative, and every
    parameter after the update to 1e-3 * lr + 1e-5 * max|param| wherever
    the port's gradient is above 1e-5 in magnitude.  AdamW's first update
    is lr * g / (|g| + 1e-8): for |g| within a few hundred eps of 0 the
    f32 gradient differences (held to 1e-3 * max|leaf| in
    tests/test_torch_train.py) move it by up to 2 * lr, which is the
    bound there.  With remat off and on; one jitted JAX train step serves
    all four (clipping and AdamW alone are held to optax in
    tests/test_torch_train.py);
  * the same step in bf16 with remat on runs on the CPU (the card's
    precision, with the plain kernel versions), with f32 gradients of the
    masters and with `grad_dtype="bfloat16"` (the copies' gradients), and
    each keeps a cosine > 0.99 with the f32 gradient;
  * `flax_from_module` inverts `load_flax` on every key, and a params npz
    the port saves loads in the JAX package's `load_params_npz` and runs
    the flax model (f16 storage, as the JAX writer: 1e-3 relative);
  * the loss falls on a fixed batch and fixed draws (the analogue of
    tests/test_training_learns.py: mean of the last 5 of 25 steps below
    0.9 x the first 5);
  * `python -m unirenderer_tpu_torch.train --tiny --synthetic --steps 3
    --device cpu` writes metrics.jsonl and a checkpoint's params npz.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_rel_close, batch_and_ctx, flatten, jax_draws, jax_models,
    port_models, torch_tree,
)
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.core.checkpoint import load_params_npz as jax_load_npz
from unirenderer_tpu.diffusion import schedule as jsched
from unirenderer_tpu.train import train_step as jstep
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.checkpoint import (
    load_params_npz, save_params_npz,
)
from unirenderer_tpu_torch.core.convert import flax_from_module, load_flax
from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.train.train_step import (
    create_train_state, draw, make_grad_fn, make_train_step,
)

JT = jcfg.tiny()
LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Few threads: the tiny model's ops are too small to share out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_lr(cfg, lr=LR):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, learning_rate=lr))


@pytest.fixture(scope="module")
def jax_step():
    """The seeded JAX models and one jitted JAX train step (lr 1e-3) taken
    from them on an inverse and on a forward draw: (dual params, vae
    params, batch, ctx, {branch: (rng, new params, metrics)})."""
    jdual, dual_p, jvae, vae_p = jax_models(JT)
    cfg = with_lr(JT)
    step = jax.jit(jstep.make_train_step(
        cfg, jdual, jvae, jsched.DiffusionSchedule.create(cfg.diffusion)))
    batch, ctx = batch_and_ctx(cfg, 9)
    steps = {}
    for branch in ("inverse", "forward"):
        # fold_in(rng, 0) is what the step draws from
        rng = next(k for s in range(64) for k in [jax.random.key(s)]
                   if bool(jsched.compute_dual_t(jax.random.split(
                       jax.random.fold_in(k, 0), 7)[2], 1000, 2)[2])
                   == (branch == "inverse"))
        state, metrics = step(jstep.create_train_state(cfg, dual_p), vae_p,
                              jnp.asarray(ctx),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              rng)
        assert bool(metrics["is_inverse"]) == (branch == "inverse")
        steps[branch] = (rng, flatten(jax.device_get(state.params)["params"]),
                         jax.device_get(metrics))
    return dual_p, vae_p, batch, ctx, steps


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("branch", ["inverse", "forward"])
def test_train_step_matches_jax(jax_step, branch, remat):
    dual_p, vae_p, batch, ctx, steps = jax_step
    rng, want, want_m = steps[branch]
    cfg, dual, vae = port_models(with_lr(tcfg.tiny()), dual_p, vae_p, remat)
    state = create_train_state(cfg, dual)
    step = make_train_step(cfg, dual, vae,
                           DiffusionSchedule.create(cfg.diffusion),
                           torch.float32)
    draws = jax_draws(jax.random.fold_in(rng, 0), cfg, 2)
    assert draws.is_inverse == (branch == "inverse")
    tb, tctx = torch_tree(batch), torch.from_numpy(ctx)
    grads, _ = make_grad_fn(cfg, dual, vae,
                            DiffusionSchedule.create(cfg.diffusion),
                            torch.float32)(state.params, tb, tctx, draws)
    small = grads_as_flax(dual, [g.abs() <= 1e-5 for g in grads])
    metrics = step(state, tctx, tb, draws)
    assert state.step == 1
    for k in ("loss", "grad_norm", "loss_img", "loss_attr", "loss_cycle",
              "loss_contrastive"):
        assert_rel_close(metrics[k], np.asarray(want_m[k]), 1e-4, k)
    got = {k[len("params/"):]: v for k, v in flax_from_module(dual).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * LR, k
        err = np.where(small[k], 0.0, diff).max()
        tol = 1e-3 * LR + 1e-5 * np.abs(w).max()
        assert err <= tol, f"{k}: max|diff| {err:.3g} > {tol:.3g}"


def grads_as_flax(dual, tensors):
    """{flax path: array} of per-parameter tensors given in
    `dual.named_parameters()` order, in the flax layout."""
    holder = DualStreamModel(dual.cfg)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), tensors):
            p.copy_(g)
    return {k[len("params/"):]: v != 0
            for k, v in flax_from_module(holder).items()}


def test_bf16_remat_step_runs_and_tracks_f32(jax_step):
    """The card's recipe (bf16 compute, remat) on the CPU's plain kernels:
    activation checkpointing recomputes with the same bf16 copies."""
    dual_p, vae_p, batch, ctx, steps = jax_step
    draws = jax_draws(jax.random.fold_in(steps["inverse"][0], 0), JT, 2)
    grads = {}
    for dtype, remat, grad_dtype in ((torch.float32, False, "float32"),
                                     (torch.bfloat16, True, "float32"),
                                     (torch.bfloat16, True, "bfloat16")):
        cfg, dual, vae = port_models(tcfg.tiny(), dual_p, vae_p, remat)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, grad_dtype=grad_dtype))
        vae.to(dtype)
        params = dict(dual.named_parameters())
        g, m = make_grad_fn(cfg, dual, vae,
                            DiffusionSchedule.create(cfg.diffusion),
                            dtype)(params, torch_tree(batch),
                                   torch.from_numpy(ctx).to(dtype), draws)
        assert all(x.dtype == torch.float32 for x in g)
        assert np.isfinite(float(m["loss"]))
        grads[dtype, grad_dtype] = torch.cat([x.flatten() for x in g])
    a = grads[torch.float32, "float32"]
    for key in ((torch.bfloat16, "float32"), (torch.bfloat16, "bfloat16")):
        b = grads[key]
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > 0.99, (key, cos)


def test_checkpoint_round_trip_and_jax_reader(jax_step, tmp_path):
    dual_p, vae_p, *_ = jax_step
    _, dual, _ = port_models(tcfg.tiny(), dual_p, vae_p)
    flat = flax_from_module(dual)
    want = flatten(dual_p)
    assert set(flat) == set(want)
    for k, w in want.items():
        assert np.array_equal(flat[k], w), k
    path = str(tmp_path / "params.npz")
    save_params_npz(path, flat, step=7)
    back, step = load_params_npz(path)
    assert step == 7 and set(back) == set(flat)
    jparams, jstep_ = jax_load_npz(path)
    assert jstep_ == 7
    assert jax.tree.structure(jparams) == jax.tree.structure(
        jax.device_get(dual_p))
    for k, w in flatten(jparams).items():
        assert_rel_close(w, want[k], 1e-3, k)
    # the file loads strictly back into the port
    assert load_flax(port_models(tcfg.tiny(), dual_p, vae_p)[1], back) == \
        len(flat)


def test_loss_falls_on_a_fixed_batch(jax_step):
    dual_p, vae_p, batch, ctx, *_ = jax_step
    cfg, dual, vae = port_models(with_lr(tcfg.tiny()), dual_p, vae_p)
    state = create_train_state(cfg, dual)
    step = make_train_step(cfg, dual, vae,
                           DiffusionSchedule.create(cfg.diffusion),
                           torch.float32)
    draws = draw(torch.Generator().manual_seed(7), 2, (8, 8), 1000)
    tb, tctx = torch_tree(batch), torch.from_numpy(ctx)
    losses = [float(step(state, tctx, tb, draws)["loss"]) for _ in range(25)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9, losses


def test_cli_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "unirenderer_tpu_torch.train", "--workdir",
         str(tmp_path), "--tiny", "--synthetic", "--steps", "3",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(line)
            for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1]
    assert np.isfinite(recs[0]["loss"]) and "grad_norm" in recs[0]
    flat, step = load_params_npz(
        str(tmp_path / "checkpoints" / "checkpoint-3" / "params.npz"))
    assert step == 3 and all(k.startswith("params/") for k in flat)


def test_compute_dtype_follows_the_config():
    """TrainConfig.compute_dtype: by default bf16 on the card and f32 on
    the CPU; the card takes bf16 and f32 (its kernels' types) and refuses
    any other."""
    from unirenderer_tpu_torch.train.trainer import resolve_compute_dtype
    cpu, card = torch.device("cpu"), torch.device("cuda")
    default = tcfg.tiny().train
    assert resolve_compute_dtype(default, cpu) == torch.float32
    assert resolve_compute_dtype(default, card) == torch.bfloat16
    bf16 = dataclasses.replace(default, compute_dtype="bfloat16")
    assert resolve_compute_dtype(bf16, cpu) == torch.bfloat16
    f32 = dataclasses.replace(default, compute_dtype="float32")
    assert resolve_compute_dtype(f32, cpu) == torch.float32
    assert resolve_compute_dtype(f32, card) == torch.float32
    f16 = dataclasses.replace(default, compute_dtype="float16")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        resolve_compute_dtype(f16, card)
