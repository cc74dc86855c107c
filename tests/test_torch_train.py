"""The port's training step against the JAX package's, at `tiny()` in
float32 on the CPU, the same seeded weights on both sides.

  * `compute_dual_t` follows the JAX draw's rule in both branches;
    `add_noise`, `contrastive_loss` and `dual_stream_loss` (both branches)
    match JAX to 1e-6 * max (elementwise f32; 1e-5 for the losses, which
    reduce);
  * `DualStreamModel.forward`, with and without the decoder, matches
    `dual.apply` to 1e-4 * max|jax| (the model tests' rule: summation
    order only);
  * `loss_from_draws`, fed the JAX step's own draws (its
    `split(rng, 7)` replayed), matches the JAX `loss_fn`'s loss and
    metrics to 1e-4 relative, and every dual-stream gradient leaf matches
    `jax.value_and_grad` of it to 1e-3 * max|leaf| (a backward through
    the whole model and the VAE-encoded targets: f32 summation order
    compounds over ~3x the forward's depth), for an inverse and a forward
    step.  One jitted JAX value_and_grad serves every case;
  * the learning-rate schedules match optax's to 1e-6 relative, and three
    updates of global-norm clipping + AdamW on random arrays match
    `optax.chain(clip_by_global_norm, adamw)` to 1e-6 relative (f32
    elementwise; gradients well away from 0, where AdamW's sign-like
    first update is stable).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_port_helpers import (
    assert_rel_close, batch_and_ctx, flatten, jax_draws, jax_models,
    port_models, torch_tree,
)
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.diffusion import schedule as jsched
from unirenderer_tpu.train import losses as jlosses
from unirenderer_tpu.train import train_step as jstep
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.convert import flax_from_module
from unirenderer_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, compute_dual_t,
)
from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
from unirenderer_tpu_torch.train import losses as tlosses
from unirenderer_tpu_torch.train.train_step import (
    clip_by_global_norm_, make_grad_fn, make_loss_fn, make_lr_schedule,
    make_optimizer,
)

JT = jcfg.tiny()
T = JT.diffusion.num_train_timesteps

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Few threads: the tiny model's ops are too small to share out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def key_for_branch(inverse: bool, b=2):
    """A key whose draw takes the given branch."""
    for seed in range(64):
        key = jax.random.key(seed)
        if bool(jsched.compute_dual_t(jax.random.split(key, 7)[2], T,
                                      b)[2]) == inverse:
            return key
    raise AssertionError("no key found")


# ---------------------------------------------------------------------------
# Schedule and losses
# ---------------------------------------------------------------------------


def test_compute_dual_t_follows_the_jax_rule():
    """Both draws: one stream uniform in [0, T), the other anchored at 0 or
    T-1; inverse anchors the image, forward the attributes; the branch is
    a fair coin.  Forcing the branch keeps the rest of the stream."""
    b = 64
    for draw_fn in ("jax", "port"):
        seen = set()
        for seed in range(40):
            if draw_fn == "jax":
                ti, ta, inv = jsched.compute_dual_t(jax.random.key(seed), T,
                                                    b)
                ti, ta, inv = np.asarray(ti), np.asarray(ta), bool(inv)
            else:
                g = torch.Generator().manual_seed(seed)
                ti, ta, inv = compute_dual_t(g, T, b)
                ti, ta = ti.numpy(), ta.numpy()
            anchored, uniform = (ti, ta) if inv else (ta, ti)
            assert set(np.unique(anchored)) <= {0, T - 1}, draw_fn
            assert uniform.min() >= 0 and uniform.max() < T, draw_fn
            assert len(np.unique(uniform)) > b // 2, draw_fn
            seen.add(inv)
        assert seen == {True, False}, draw_fn
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a, b_ = compute_dual_t(g1, T, 4, True), compute_dual_t(g2, T, 4, False)
    assert a[2] and not b_[2]
    assert torch.equal(a[1], b_[0]) and torch.equal(a[0], b_[1])


def test_add_noise_matches_jax():
    rng = np.random.default_rng(5)
    x0, noise = (rng.standard_normal((3, 4, 4, 24)).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 517, T - 1])
    want = jsched.DiffusionSchedule.create(JT.diffusion).add_noise(
        jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    sched = DiffusionSchedule.create(tcfg.tiny().diffusion)
    assert sched.num_train_timesteps == T
    got = sched.add_noise(torch.from_numpy(x0), torch.from_numpy(noise),
                          torch.from_numpy(t))
    assert_rel_close(got, np.asarray(want), 1e-6, "add_noise")


@pytest.mark.parametrize("inverse", [True, False])
def test_losses_match_jax(inverse):
    rng = np.random.default_rng(6)
    img_pred, img_t, cyc = (rng.standard_normal((2, 4, 4, 4))
                            .astype(np.float32) for _ in range(3))
    attr_pred, attr_t = (rng.standard_normal((2, 4, 4, 24))
                         .astype(np.float32) for _ in range(2))
    want_c = jlosses.contrastive_loss(jnp.asarray(attr_pred), 0.1)
    got_c = tlosses.contrastive_loss(torch.from_numpy(attr_pred), 0.1)
    assert_rel_close(got_c, np.asarray(want_c), 1e-5, "contrastive")
    want, wm = jlosses.dual_stream_loss(
        *map(jnp.asarray, (img_pred, attr_pred, img_t, attr_t, cyc)),
        jnp.asarray(inverse), JT.train)
    got, gm = tlosses.dual_stream_loss(
        *map(torch.from_numpy, (img_pred, attr_pred, img_t, attr_t, cyc)),
        inverse, tcfg.tiny().train)
    assert_rel_close(got, np.asarray(want), 1e-5, "loss")
    assert set(gm) == set(wm)
    for k in wm:
        assert_rel_close(gm[k], np.asarray(wm[k]), 1e-5, k)
    # batch 1: no contrastive term
    one = tlosses.dual_stream_loss(
        *(torch.from_numpy(a[:1]) for a in (img_pred, attr_pred, img_t,
                                            attr_t, cyc)),
        inverse, tcfg.tiny().train)[1]
    assert float(one["loss_contrastive"]) == 0.0


@pytest.mark.parametrize("schedule,warmup", [("constant", 0),
                                             ("constant", 4),
                                             ("cosine", 3)])
def test_lr_schedule_matches_optax(schedule, warmup):
    over = dict(lr_schedule=schedule, lr_warmup_steps=warmup,
                learning_rate=2e-4, lr_decay_steps=11)
    jc = dataclasses.replace(JT, train=dataclasses.replace(JT.train, **over))
    tc = tcfg.tiny()
    tc = dataclasses.replace(tc, train=dataclasses.replace(tc.train, **over))
    want = jstep.make_lr_schedule(jc)
    got = make_lr_schedule(tc)
    for step in range(14):
        w = float(want(step)) if callable(want) else want
        assert abs(got(step) - w) <= 1e-6 * 2e-4, (step, got(step), w)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])     # clipped, not clipped
def test_clip_and_adamw_match_optax(max_norm):
    over = dict(learning_rate=1e-2, lr_warmup_steps=2, max_grad_norm=max_norm)
    jc = dataclasses.replace(JT, train=dataclasses.replace(JT.train, **over))
    tc = tcfg.tiny()
    tc = dataclasses.replace(tc, train=dataclasses.replace(tc.train, **over))
    rng = np.random.default_rng(10)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    opt = jstep.make_optimizer(jc)
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    topt, lr = make_optimizer(tc, tp), make_lr_schedule(tc)
    for step, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(g[k].copy()) for k in tp]
        norm = clip_by_global_norm_(tg, max_norm)
        assert_rel_close(norm, np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                           for v in g.values())), 1e-6, "norm")
        for p, t in zip(tp.values(), tg):
            p.grad = t
        for group in topt.param_groups:
            group["lr"] = lr(step)
        topt.step()
        for k in tp:
            assert_rel_close(tp[k], np.asarray(jp[k]), 1e-6, f"{k} @ {step}")


# ---------------------------------------------------------------------------
# The model and the loss
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jdual, dual_p, jvae, vae_p = jax_models(JT)
    cfg, dual, vae = port_models(tcfg.tiny(), dual_p, vae_p)
    return jdual, dual_p, jvae, vae_p, cfg, dual, vae


@pytest.mark.parametrize("run_decoder", [True, False])
def test_dual_forward_matches_flax(models, run_decoder):
    jdual, dual_p, _, _, cfg, dual, _ = models
    u, s = cfg.unet, cfg.unet.sample_size
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, s, s, 4)).astype(np.float32)
    attr = rng.standard_normal((2, s, s, 28)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg.text.max_length,
                               u.cross_attention_dim)).astype(np.float32)
    t_img, t_attr = np.array([999, 3]), np.array([0, 640])
    apply = jax.jit(lambda *a: jdual.apply(dual_p, *a,
                                           run_decoder=run_decoder))
    want = apply(*map(jnp.asarray, (img, attr, t_img, t_attr, ctx)))
    with torch.no_grad():
        got = dual(*map(torch.from_numpy, (img, attr, t_img, t_attr, ctx)),
                   run_decoder=run_decoder)
    assert_rel_close(got[0], np.asarray(want[0]), 1e-4, "img_pred")
    if run_decoder:
        assert got[1].shape == (2, s, s, 28)
        assert_rel_close(got[1], np.asarray(want[1]), 1e-4, "attr_pred")
    else:
        assert got[1] is None and want[1] is None


@pytest.fixture(scope="module")
def jax_value_and_grad(models):
    jdual, dual_p, jvae, vae_p, *_ = models
    sched = jsched.DiffusionSchedule.create(JT.diffusion)
    loss_fn = jstep.make_loss_fn(JT, jdual, jvae, sched)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("inverse", [True, False])
def test_loss_and_grads_match_jax(models, jax_value_and_grad, inverse):
    _, dual_p, _, vae_p, cfg, dual, vae = models
    batch, ctx = batch_and_ctx(cfg, 8)
    key = key_for_branch(inverse)
    (want_loss, want_m), want_g = jax_value_and_grad(
        dual_p, vae_p, jnp.asarray(ctx),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    assert bool(want_m["is_inverse"]) == inverse
    draws = jax_draws(key, cfg, 2)
    sched = DiffusionSchedule.create(cfg.diffusion)
    tb, tctx = torch_tree(batch), torch.from_numpy(ctx)
    params = dict(dual.named_parameters())
    loss, metrics = make_loss_fn(cfg, dual, vae, sched)(params, tb, tctx,
                                                        draws)
    assert_rel_close(loss, np.asarray(want_loss), 1e-4, "loss")
    for k in want_m:
        assert_rel_close(metrics[k], np.asarray(want_m[k]), 1e-4, k)

    grads, gm = make_grad_fn(cfg, dual, vae, sched, torch.float32)(
        params, tb, tctx, draws)
    assert_rel_close(gm["loss"], np.asarray(want_loss), 1e-4, "loss")
    want_flat = flatten(want_g["params"])
    got = load_grads(dual, grads)
    assert set(got) == set(want_flat)
    for k, w in want_flat.items():
        assert np.abs(w).max() > 0, k
        assert_rel_close(got[k], w, 1e-3, f"grad {k}")


def load_grads(dual, grads):
    """{flax path: array} of grads given in `dual.named_parameters()`
    order, in the flax layout."""
    holder = DualStreamModel(dual.cfg)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    return {k[len("params/"):]: v for k, v in flax_from_module(holder).items()}
