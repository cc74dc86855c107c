"""The port's SD-v1.4 weight port (`models/surgery.py`) against the JAX
package's, on the CPU at tiny(): random diffusers-shaped state dicts (keys
from the port's path maps, shapes from its modules, values from a seeded
numpy generator) through the port's `fill_from_torch` with the three maps,
`dual_stream_from_unet` and `port_sd_checkpoint(fast_init=True)`, and
through the JAX ones (`fast_init=True`: only `jax.eval_shape` of the
inits runs), taken through `core/convert.state_dict_from_flax`: f32
values bit-equal.  Also the inflation rules, the zero convolutions, the
two inits, key coverage of the flagship maps over the independent
inventory of tests/sd14_keys.py (on meta-device modules), and `--sd-*` on
the CPU CLI.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd14_keys import sd14_clip_keys, sd14_unet_keys, sd14_vae_keys
from torch_port_helpers import ONE_THREAD_ENV, flatten, use_one_thread

use_one_thread()

from unirenderer_tpu.core import config as jcfg  # noqa: E402
from unirenderer_tpu.models import surgery as jsurgery  # noqa: E402
from unirenderer_tpu.models.dual_stream import ImageUNet as JaxUNet  # noqa: E402,E501
from unirenderer_tpu.utils.fast_init import shape_init as jax_shape_init  # noqa: E402,E501
from unirenderer_tpu_torch.core import config as tcfg  # noqa: E402
from unirenderer_tpu_torch.core.convert import state_dict_from_flax  # noqa: E402,E501
from unirenderer_tpu_torch.models import surgery  # noqa: E402
from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder  # noqa: E402,E501
from unirenderer_tpu_torch.models.dual_stream import ImageUNet  # noqa: E402
from unirenderer_tpu_torch.models.vae import AutoencoderKL  # noqa: E402
from unirenderer_tpu_torch.utils.fast_init import shape_init  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = {"unet": (ImageUNet, "unet", surgery.unet_path_map),
        "vae": (AutoencoderKL, "vae", surgery.vae_path_map),
        "text": (CLIPTextEncoder, "text", surgery.clip_path_map)}


def synthetic_state_dicts(cfg, seed=0):
    """{part: diffusers-keyed random f32 arrays} covering every mapped
    parameter of the port's tiny() modules, in their (torch) shapes."""
    out = {}
    for i, (part, (cls, field, path_map)) in enumerate(MAPS.items()):
        with torch.device("meta"):
            mod = cls(getattr(cfg, field))
        rng = np.random.default_rng(seed + i)
        out[part] = {path_map(n): rng.standard_normal(tuple(p.shape))
                     .astype(np.float32)
                     for n, p in mod.named_parameters()}
    return out


@pytest.fixture(scope="module")
def sds():
    return synthetic_state_dicts(tcfg.tiny())


@pytest.fixture(scope="module")
def jax_port(sds):
    """The JAX package's standalone UNet fill and full port, as port
    state dicts."""
    cfg = jcfg.tiny()
    s = cfg.unet.sample_size
    unet = JaxUNet(cfg.unet, jnp.float32)
    template = jax_shape_init(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, s, s, cfg.unet.in_channels)),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.text.max_length, cfg.unet.cross_attention_dim))),
        fill="zeros")
    unet_p, missing = jsurgery.fill_from_torch(template, sds["unet"],
                                               jsurgery.unet_path_map)
    assert not missing
    dual, vae, text = jsurgery.port_sd_checkpoint(
        sds["unet"], sds["vae"], sds["text"], cfg, dtype=jnp.float32,
        fast_init=True)
    return {name: state_dict_from_flax(flatten(p["params"]))
            for name, p in (("unet", unet_p), ("dual", dual), ("vae", vae),
                            ("text", text))}


@pytest.fixture(scope="module")
def port(sds):
    cfg = tcfg.tiny()
    unet = shape_init(lambda: ImageUNet(cfg.unet), fill="zeros",
                      device="cpu")
    assert surgery.fill_from_torch(unet, sds["unet"],
                                   surgery.unet_path_map) == []
    dual, vae, text = surgery.port_sd_checkpoint(
        sds["unet"], sds["vae"], sds["text"], cfg, device="cpu",
        fast_init=True)
    return {"unet": unet, "dual": dual, "vae": vae, "text": text}


def _assert_bit_equal(module, want, what):
    got = module.state_dict()
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        assert got[k].dtype == torch.float32, (what, k)
        assert torch.equal(got[k], w), (what, k)


@pytest.mark.parametrize("part", ["unet", "vae", "text"])
def test_fill_from_torch_matches_jax(part, port, jax_port, sds):
    _assert_bit_equal(port[part], jax_port[part], part)
    # every mapped tensor is the file's
    for name, p in port[part].named_parameters():
        tk = MAPS[part][2](name)
        assert np.array_equal(p.detach().numpy(), sds[part][tk]), name


def test_dual_stream_from_unet_matches_jax(port, jax_port):
    _assert_bit_equal(port["dual"], jax_port["dual"], "dual")


def test_inflation_rules():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    conv = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)),
            "bias": jnp.asarray(b)}
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    for mine, theirs in ((surgery.inflate_conv_in, jsurgery.inflate_conv_in),
                         (surgery.inflate_conv_out,
                          jsurgery.inflate_conv_out)):
        gw, gb = mine(wt, bt)
        want = theirs(conv)
        assert np.array_equal(gw.numpy(),
                              np.asarray(want["kernel"]).transpose(3, 2, 0, 1))
        assert np.array_equal(gb.numpy(), np.asarray(want["bias"]))
    gw, gb = surgery.inflate_conv_in(wt, bt)
    assert gw.shape == (8, 28, 3, 3) and torch.equal(gb, bt)
    assert torch.equal(gw[:, 4:8], wt * 0.142)
    gw, gb = surgery.inflate_conv_out(wt, bt)
    assert gw.shape == (56, 4, 3, 3)
    assert torch.equal(gw[8:16], wt * 0.142)
    assert torch.equal(gb[48:], bt * 0.142)


def test_zero_convs_are_zero_and_copies_own_storage(port):
    dual = port["dual"]
    zero = [(n, p) for n, p in dual.named_parameters()
            if n.split(".")[1].startswith(("zero_", "control_"))]
    assert len(zero) >= 8
    assert all(not p.any() for _, p in zero)
    ptrs = [p.data_ptr() for p in dual.parameters()]
    assert len(ptrs) == len(set(ptrs))


def test_both_inits_give_the_same_bits(port, sds):
    dual, vae, text = surgery.port_sd_checkpoint(
        sds["unet"], sds["vae"], sds["text"], tcfg.tiny(), device="cpu",
        fast_init=False)
    for name, mod in (("dual", dual), ("vae", vae), ("text", text)):
        _assert_bit_equal(mod, port[name].state_dict(), name)


def test_strict_fill_and_the_vae_attention_as_1x1_conv(sds):
    cfg = tcfg.tiny()
    vae_sd = dict(sds["vae"])
    key = "encoder.mid_block.attentions.0.to_q.weight"
    w = vae_sd[key]
    vae_sd[key] = w[:, :, None, None]              # a 1x1 conv's layout
    vae = shape_init(lambda: AutoencoderKL(cfg.vae), fill="zeros",
                     device="cpu")
    surgery.fill_from_torch(vae, vae_sd, surgery.vae_path_map)
    assert np.array_equal(vae.encoder.mid_attn.to_q.weight.detach().numpy(),
                          w)
    bad = dict(sds["vae"])
    bad["encoder.conv_in.weight"] = w[:, :, None, None]
    with pytest.raises(ValueError, match="shape mismatch"):
        surgery.fill_from_torch(vae, bad, surgery.vae_path_map)
    del bad["encoder.conv_in.weight"]
    with pytest.raises(KeyError, match="missing"):
        surgery.fill_from_torch(vae, bad, surgery.vae_path_map)
    assert surgery.fill_from_torch(vae, bad, surgery.vae_path_map,
                                   strict=False) == ["encoder.conv_in.weight"]


@pytest.mark.parametrize("part", ["unet", "vae", "text"])
def test_flagship_maps_cover_sd14_keys(part):
    cls, field, path_map = MAPS[part]
    with torch.device("meta"):
        mod = cls(getattr(tcfg.flagship(), field))
    ours = {path_map(n) for n, _ in mod.named_parameters()}
    real = {"unet": sd14_unet_keys, "vae": sd14_vae_keys,
            "text": sd14_clip_keys}[part]()
    assert ours == real, (sorted(ours - real)[:5], sorted(real - ours)[:5])


def test_sd_cli_ports_and_trains(sds, tmp_path):
    """`--sd-unet/--sd-vae/--sd-text` from .bin files on the CPU CLI: one
    step, a checkpoint, a finite loss; all three or none."""
    from unirenderer_tpu_torch.train.__main__ import main
    paths = {}
    for part in ("unet", "vae", "text"):
        paths[part] = str(tmp_path / f"{part}.bin")
        torch.save({k: torch.from_numpy(v) for k, v in sds[part].items()},
                   paths[part])
    work = tmp_path / "run"
    cmd = [sys.executable, "-m", "unirenderer_tpu_torch.train", "--workdir",
           str(work), "--tiny", "--synthetic", "--steps", "1", "--device",
           "cpu", "--sd-unet", paths["unet"], "--sd-vae", paths["vae"],
           "--sd-text", paths["text"]]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, **ONE_THREAD_ENV), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SD weights ported" in res.stdout
    assert os.path.isdir(work / "checkpoints" / "checkpoint-1")
    import json
    rec = json.loads((work / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(rec["loss"])
    with pytest.raises(SystemExit) as e:
        main(["--workdir", str(work), "--tiny", "--synthetic", "--device",
              "cpu", "--sd-unet", paths["unet"]])
    assert e.value.code == 2
