"""The port's VAE training (`train/vae_train.py`) against the JAX
package's `unirenderer_tpu/train/vae_train.py`, at the `tiny()` VAE in
float32 on the CPU:

  * two steps of `make_vae_train_step` from the same seeded weights on the
    same 8-map stack, fed the JAX step's posterior noise (`fold_in(rng,
    step)`): the loss and every metric (L1, MSE, KL, PSNR, the pre-clip
    grad norm) to 1e-4 relative, and every parameter after each update to
    1e-4 x max|leaf| (one jitted JAX step of the tiny VAE), except the
    mid-block attention's key biases: their exact gradient is 0 (softmax
    ignores a shift along the keys), so AdamW's normalised update turns
    f32 noise into a step of up to lr, and they are held to 2 lr a step;
  * `vae_lr_schedule` matches JAX's (optax's warmup cosine) to 1e-6;
  * `train_vae` over a scene bank: 4 straight steps equal 2 steps and a
    resumed run of 2 more, bit for bit (params, optimizer state, logged
    metrics), with checkpoints under vae_checkpoints and the exit reason
    named; a warm start from a params npz of another geometry raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    assert_rel_close, flatten, flax_shapes, random_params,
)
from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.models.vae import AutoencoderKL as JaxVAE
from unirenderer_tpu.train import vae_train as jvt
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.checkpoint import save_params_npz
from unirenderer_tpu_torch.core.convert import flax_from_module, load_flax
from unirenderer_tpu_torch.data.scene_bank import synthetic_bank
from unirenderer_tpu_torch.train import vae_train as tvt

REL = 1e-4
LR = 1e-3
KEY_BIAS = "mid_attn/to_k/bias"    # the mid-block attention's key bias

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vae_step_matches_jax():
    cfg = jcfg.tiny()
    vs = cfg.vae.sample_size
    jvae = JaxVAE(cfg.vae, jnp.float32)
    params = random_params(flax_shapes(jvae, jnp.zeros((1, vs, vs, 3)),
                                       jax.random.key(0)), 2)
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (8, vs, vs, 3)).astype(np.float32)
    key = jax.random.key(9)
    jstate = jvt.create_vae_train_state(params, LR)
    jstep = jax.jit(jvt.make_vae_train_step(jvae, LR))

    vae = tvt.build_vae(tcfg.tiny(), "cpu")
    flat = flatten(params["params"])
    assert load_flax(vae, flat) == len(flat)
    state = tvt.create_vae_train_state(vae, LR)
    step = tvt.make_vae_train_step(vae, LR)
    h = vs // tcfg.tiny().vae.downscale
    for i in range(2):
        noise = jax.random.normal(jax.random.fold_in(key, i), (8, h, h, 4))
        jstate, want = jstep(jstate, jnp.asarray(images), key)
        got = step(state, torch.from_numpy(images),
                   torch.from_numpy(np.array(noise)))
        assert set(got) == set(want)
        for k in want:
            assert_rel_close(got[k], np.asarray(want[k]), REL, f"{k} @ {i}")
        mine = flax_from_module(vae)
        for k, w in flatten(jstate.params).items():
            if k.endswith(KEY_BIAS):
                # its exact gradient is 0 (softmax ignores a shift along the
                # keys): AdamW turns f32 noise into steps of at most lr
                assert np.abs(mine[k] - np.asarray(w)).max() <= \
                    2 * LR * (i + 1), k
                continue
            assert_rel_close(mine[k], np.asarray(w), REL, f"{k} @ {i}")
    assert state.step == 2


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_vae_lr_schedule_matches_jax(schedule):
    want = jvt.vae_lr_schedule(2e-4, schedule, 20, 5)
    got = tvt.vae_lr_schedule(2e-4, schedule, 20, 5)
    for s in range(24):
        w = float(want(s)) if callable(want) else want
        assert abs(got(s) - w) <= 1e-6 * 2e-4, (s, got(s), w)


def test_train_vae_resumes_bit_equal(tmp_path):
    cfg = tcfg.tiny()
    bank = synthetic_bank(cfg.data)
    lines = []
    kw = dict(lr=LR, scene_bank=bank, bank_batch=1, checkpoint_every=2,
              log_every=1, device="cpu", log=lines.append)
    straight = tvt.train_vae(cfg, None, str(tmp_path / "s"), 4, **kw)
    tvt.train_vae(cfg, None, str(tmp_path / "r"), 2, **kw)
    resumed = tvt.train_vae(cfg, None, str(tmp_path / "r"), 4, **kw)
    assert straight.step == resumed.step == 4
    assert "[vae] resumed from step 2" in lines
    assert lines[-1] == ("[vae] training loop ended at step 4/4 (reached "
                         "max_steps=4)")
    for (n, p), (m, q) in zip(straight.params.items(),
                              resumed.params.items()):
        assert n == m and torch.equal(p, q), n
    sa, sb = (s.optimizer.state_dict()["state"] for s in (straight,
                                                           resumed))
    for i in sa:
        for name in sa[i]:
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)

    def metrics(name):
        with open(tmp_path / name / "vae_metrics.jsonl") as f:
            return [{k: v for k, v in r.items() if k != "time"}
                    for r in map(json.loads, f)]

    assert metrics("s") == metrics("r")
    assert [r["step"] for r in metrics("s")] == [1, 2, 3, 4]
    assert sorted(p.name for p in (tmp_path / "r" / "vae_checkpoints")
                  .iterdir()) == ["checkpoint-2", "checkpoint-4"]


def test_train_vae_refuses_a_warm_start_of_another_geometry(tmp_path):
    small = tvt.build_vae(tcfg.small(), "cpu")
    path = str(tmp_path / "small_vae.npz")
    save_params_npz(path, flax_from_module(small), 0)
    with pytest.raises(ValueError, match="geometry"):
        tvt.train_vae(tcfg.tiny(), iter(()), str(tmp_path / "w"), 1,
                      init_params=path, device="cpu")
