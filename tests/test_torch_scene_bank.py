"""The port's scene bank (`data/scene_bank.py`) against the JAX package's
`unirenderer_tpu/data/scene_bank.py`, at `tiny()` on the CPU:

  * `synthetic_bank` gives the JAX bank's arrays exactly;
  * `load_scene_bank` over a directory of 2 meshes and 2 envs (written by
    the port's `data/synthetic.write_dataset`) gives the JAX loader's
    arrays exactly (meshes padded to the largest (V, T) rounded up to 128,
    textures resized to the config's);
  * `scenes_from_draws`, fed the draws of JAX's own `split(rng, 12)`,
    matches JAX's eager `sample_scenes` on every key to 1e-6 absolute,
    with the augmentations on (with and without the rotation) and off;
  * `draw_scenes` keeps every draw in its range and is a function of the
    generator's state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirenderer_tpu.core import config as jcfg
from unirenderer_tpu.data import scene_bank as jsb
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.data import scene_bank as tsb

ATOL = 1e-6

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_synthetic_bank_is_the_jax_bank():
    want = jsb.synthetic_bank(jcfg.tiny().data)
    got = tsb.synthetic_bank(tcfg.tiny().data)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_scene_bank_matches_jax(tmp_path):
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    write_dataset(str(tmp_path), n_mesh=2, n_env=2, env_res=16,
                  env_min_res=4, env_samples=8, sphere_res=6, tex_res=16,
                  device="cpu", log=lambda msg: None)
    args = (str(tmp_path / "meshes"), str(tmp_path / "envs"))
    want = jsb.load_scene_bank(*args, jcfg.tiny().data)
    got = tsb.load_scene_bank(*args, tcfg.tiny().data)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["t_idx"].shape[1] % 128 == 0
    assert got["kds"].shape[1] == tcfg.tiny().data.texture_res


def jax_scene_draws(key, sizes, batch, cfg) -> tsb.SceneDraws:
    """The random numbers of JAX's `sample_scenes(bank, key, batch)`,
    replayed from its `split(key, 12)`, as the port's SceneDraws."""
    n_mesh, n_env = sizes
    g = cfg.material_grid
    ks = jax.random.split(key, 12)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(dtype)

    def uniform(k, shape, lo, hi):
        return t(jax.random.uniform(k, shape, minval=lo, maxval=hi))

    def index(k, n):
        return t(jax.random.randint(k, (batch,), 0, n), torch.long)

    return tsb.SceneDraws(
        midx=index(ks[0], n_mesh), eidx=index(ks[1], n_env),
        metallic=index(ks[2], g), roughness=index(ks[3], g),
        az=uniform(ks[4], (batch,), 0.0, 360.0),
        el=uniform(ks[5], (batch,), 30.0, 150.0),
        scale=uniform(ks[6], (batch, 1, 3), 0.7, 1.1),
        perm=index(ks[7], 6),
        gain=uniform(ks[8], (batch, 1, 1, 3), 0.55, 1.0),
        intensity=uniform(ks[9], (batch, 1, 1, 1, 1), 0.6, 1.4),
        tint=uniform(ks[10], (batch, 1, 1, 1, 3), 0.8, 1.25),
        quat=t(jax.random.normal(ks[11], (batch, 4))))


@pytest.mark.parametrize("augment,rotation", [(True, True), (True, False),
                                              (False, True)])
def test_scenes_from_draws_match_jax(augment, rotation):
    jc = dataclasses.replace(jcfg.tiny().data, rotation_augment=rotation)
    tc = dataclasses.replace(tcfg.tiny().data, rotation_augment=rotation)
    bank = jsb.synthetic_bank(jc)
    batch = 6
    for seed in (0, 1):
        key = jax.random.key(seed)
        want = jsb.sample_scenes(jax.tree.map(jnp.asarray, bank), key, batch,
                                 jc, augment=augment)
        draws = jax_scene_draws(key, tsb.bank_sizes(bank), batch, jc)
        got = tsb.scenes_from_draws(tsb.bank_to_device(bank, "cpu"), draws,
                                    tc, augment=augment)
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, k
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)


def test_draw_scenes_ranges_and_determinism():
    cfg = tcfg.tiny().data
    a = tsb.draw_scenes(torch.Generator().manual_seed(5), (3, 2), 512, cfg)
    b = tsb.draw_scenes(torch.Generator().manual_seed(5), (3, 2), 512, cfg)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert set(a.midx.tolist()) == {0, 1, 2}
    assert set(a.eidx.tolist()) == {0, 1}
    assert set(a.perm.tolist()) == set(range(6))
    assert set(a.metallic.tolist()) == set(range(cfg.material_grid))
    for name, lo, hi in (("az", 0, 360), ("el", 30, 150),
                         ("scale", 0.7, 1.1), ("gain", 0.55, 1.0),
                         ("intensity", 0.6, 1.4), ("tint", 0.8, 1.25)):
        x = getattr(a, name)
        assert lo <= float(x.min()) and float(x.max()) < hi, name
    rot = tsb.quaternion_rotations(a.quat)
    eye = torch.eye(3).expand_as(rot)
    assert torch.allclose(rot @ rot.transpose(1, 2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(rot), torch.ones(512), atol=1e-5)
