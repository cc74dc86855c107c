"""The port's train-step variants, checkpoints and resume, at `tiny()` in
float32 on the CPU (no JAX model runs here: each variant is held to the
composition of parts that tests/test_torch_train*.py hold against JAX):

  * the scene-bank step (`Trainer(scene_bank=...)`) is bit-equal to
    `scenes_from_draws` + `collate_from_scene` + the plain step, fed the
    same draws from a generator in the same state; `render_in_step` is
    bit-equal to the plain step on the collated scene; the two-phase step
    (`grad_step` with the collate as its batch transform, then
    `update_step`) is bit-equal to the fused step;
  * `train_step_launches` adds one K4 launch to the render and bank steps;
  * `CheckpointManager` keeps the newest `total_limit` steps, skips a
    save's hidden temporary directory, and `restore_params` / `restore`
    fall back past a directory that cannot be read; `AsyncSaver` writes
    from its thread and raises a writer's error at `join`; a checkpoint's
    params npz is read by the JAX package's `load_params_npz`, exactly;
  * 4 straight bank steps equal 2 steps, a fresh Trainer resuming, and 2
    more, bit for bit: parameters, optimizer state, logged losses, the
    generator's state (AdamW; Adafactor with accumulation k = 3, saved
    mid-accumulation).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from unirenderer_tpu.core.checkpoint import load_params_npz as jax_load_npz
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.checkpoint import (
    AsyncSaver, CheckpointManager,
)
from unirenderer_tpu_torch.core.convert import flax_from_module
from unirenderer_tpu_torch.data.objaverse import collate_from_scene
from unirenderer_tpu_torch.data.scene_bank import (
    bank_sizes, bank_to_device, draw_scenes, scenes_from_draws,
    synthetic_bank,
)
from unirenderer_tpu_torch.train.train_step import (
    BATCH_KEYS, draw, make_train_step, make_two_phase_train_step,
    train_step_launches,
)
from unirenderer_tpu_torch.train import trainer as trainer_module
from unirenderer_tpu_torch.train.trainer import Trainer

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**train):
    cfg = tcfg.tiny()
    over = dict(learning_rate=1e-3)
    over.update(train)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **over))


def assert_same_params(a, b):
    for (n, p), (m, q) in zip(a.items(), b.items()):
        assert n == m and torch.equal(p, q), n


def lat_hw(cfg):
    r = cfg.data.resolution // cfg.vae.downscale
    return (r, r)


def test_bank_step_is_its_composition(tmp_path):
    cfg = tiny_cfg()
    bank = synthetic_bank(cfg.data)
    a = Trainer(cfg, str(tmp_path / "a"), "cpu", scene_bank=bank)
    b = Trainer(cfg, str(tmp_path / "b"), "cpu")
    assert_same_params(a.state.params, b.state.params)
    step = make_train_step(cfg, b.dual, b.vae, b.schedule, torch.float32)
    dev_bank = bank_to_device(bank, "cpu")
    T = cfg.diffusion.num_train_timesteps
    for inverse in (True, False):
        ma = a.step(is_inverse=inverse)
        sd = draw_scenes(b.generator, bank_sizes(bank),
                         cfg.train.batch_size_per_device, cfg.data)
        draws = draw(b.generator, cfg.train.batch_size_per_device,
                     lat_hw(cfg), T, inverse)
        with torch.no_grad():
            maps = collate_from_scene(scenes_from_draws(dev_bank, sd,
                                                        cfg.data),
                                      cfg.data.resolution, cfg.data.ssaa)
        mb = step(b.state, b.ctx, {k: maps[k] for k in BATCH_KEYS}, draws)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        assert_same_params(a.state.params, b.state.params)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_render_in_step_equals_the_plain_step(tmp_path):
    cfg = tiny_cfg()
    bank = bank_to_device(synthetic_bank(cfg.data), "cpu")
    render = Trainer(cfg, str(tmp_path / "r"), "cpu", render_in_step=True)
    plain = Trainer(cfg, str(tmp_path / "p"), "cpu")
    gen = torch.Generator().manual_seed(11)
    for inverse in (False, True):
        scene = scenes_from_draws(bank, draw_scenes(
            gen, bank_sizes(bank), 2, cfg.data), cfg.data)
        with torch.no_grad():
            maps = collate_from_scene(scene, cfg.data.resolution,
                                      cfg.data.ssaa)
        m_render = render.step({k: v.numpy() for k, v in scene.items()},
                               is_inverse=inverse)
        m_plain = plain.step(maps, is_inverse=inverse)
        for k in m_plain:
            assert torch.equal(m_render[k], m_plain[k]), k
        assert_same_params(render.state.params, plain.state.params)


def test_two_phase_is_bit_equal_to_the_fused_step(tmp_path):
    cfg = tiny_cfg()
    bank = bank_to_device(synthetic_bank(cfg.data), "cpu")
    fused = Trainer(cfg, str(tmp_path / "f"), "cpu")
    split = Trainer(cfg, str(tmp_path / "s"), "cpu")

    def collate(scene):
        return collate_from_scene(scene, cfg.data.resolution, cfg.data.ssaa)

    step = make_train_step(cfg, fused.dual, fused.vae, fused.schedule,
                           torch.float32)
    grad_step, update_step = make_two_phase_train_step(
        cfg, split.dual, split.vae, split.schedule, torch.float32,
        batch_transform=collate)
    gen = torch.Generator().manual_seed(3)
    T = cfg.diffusion.num_train_timesteps
    for inverse in (True, False, True):
        scene = scenes_from_draws(bank, draw_scenes(
            gen, bank_sizes(bank), 2, cfg.data), cfg.data)
        draws = draw(gen, 2, lat_hw(cfg), T, inverse)
        with torch.no_grad():
            maps = collate(scene)
        m_fused = step(fused.state, fused.ctx,
                       {k: maps[k] for k in BATCH_KEYS}, draws)
        grads, m_split = grad_step(split.state.params, split.ctx, scene,
                                   draws)
        m_split["grad_norm"] = update_step(split.state, grads)
        assert set(m_split) == set(m_fused)
        for k in m_fused:
            assert torch.equal(m_split[k], m_fused[k]), k
        assert_same_params(split.state.params, fused.state.params)


def test_render_steps_count_one_rasterizer_launch():
    cfg = tcfg.flagship()
    for inverse in (True, False):
        plain = train_step_launches(cfg, 2, inverse)
        render = train_step_launches(cfg, 2, inverse, render=True)
        assert "rasterize" not in plain
        assert render.pop("rasterize") == 1 and render == plain


def test_checkpoint_manager_rotates_and_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), total_limit=2)
    for step in range(1, 5):
        mgr.save(step, {"params/w": np.full((3,), step, np.float32)},
                 dict(step=step, t=torch.arange(step)))
    assert mgr.all_steps() == [3, 4]
    os.makedirs(tmp_path / ".tmp-checkpoint-6")      # a killed save
    os.makedirs(tmp_path / "checkpoint-5")           # an unreadable one
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    params = mgr.restore_params()
    assert mgr.restored_step() == 4
    np.testing.assert_array_equal(params["params/w"], [4, 4, 4])
    params, state = mgr.restore()
    assert mgr.restored_step() == 4 and state["step"] == 4
    assert torch.equal(state["t"], torch.arange(4))
    with pytest.raises(Exception):
        mgr.restore(5)


def test_async_saver_and_the_jax_reader(tmp_path):
    cfg = tiny_cfg()
    tr = Trainer(cfg, str(tmp_path), "cpu")
    saver = AsyncSaver(tr.ckpt)
    saver.save(7, tr.dual, tr.state.params, tr.resume_state())
    saver.join()
    flat = flax_from_module(tr.dual)
    params = tr.ckpt.restore_params(7)
    assert set(params) == set(flat)
    jparams, jstep = jax_load_npz(os.path.join(tr.ckpt.step_dir(7),
                                               "params.npz"))
    assert jstep == 7

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), v

    jflat = dict(walk(jparams))
    assert set(jflat) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)
    bad = AsyncSaver(CheckpointManager(str(tmp_path / "bad")))
    bad.save(1, tr.dual, {}, {})          # no tensors for the module
    with pytest.raises(KeyError):
        bad.join()


@pytest.mark.parametrize("optimizer,k", [("adamw", 1), ("adafactor", 3)])
def test_resume_is_bit_equal(tmp_path, monkeypatch, optimizer, k):
    monkeypatch.setattr(trainer_module, "LOG_EVERY", 1)   # log every loss
    cfg = tiny_cfg(optimizer=optimizer, gradient_accumulation_steps=k,
                   checkpoint_every=2)
    bank = synthetic_bank(cfg.data)

    def trainer(name):
        return Trainer(cfg, str(tmp_path / name), "cpu", scene_bank=bank)

    straight = trainer("straight")
    straight.train(max_steps=4)
    trainer("resumed").train(max_steps=2)
    resumed = trainer("resumed")
    assert resumed.state.step == 0
    resumed.train(max_steps=4)
    assert resumed.state.step == straight.state.step == 4
    assert resumed.state.updates == straight.state.updates == 4 // k
    assert_same_params(resumed.state.params, straight.state.params)
    sa = straight.state.optimizer.state_dict()
    sb = resumed.state.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for name, v in st.items():
            w = sb["state"][i][name]
            assert (torch.equal(v, w) if isinstance(v, torch.Tensor)
                    else v == w), (i, name)
    assert (straight.state.acc is None) == (resumed.state.acc is None)
    if straight.state.acc is not None:
        for x, y in zip(straight.state.acc, resumed.state.acc):
            assert torch.equal(x, y)
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())

    def losses(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [(r["step"], r["loss"]) for r in map(json.loads, f)]

    assert losses("straight") == losses("resumed")
    assert [s for s, _ in losses("straight")] == [1, 2, 3, 4]
    assert resumed.ckpt.all_steps() == [2, 4]
