"""f32 compute in the port, on the CPU: what the card's f32 kernels are
held to, and the type each entry point picks.

  * the compute type on the card: `resolve_compute_dtype` takes bf16 and
    f32 (the kernels' types), None gives bf16 (the JAX Trainer's default),
    f16 and f64 raise;
  * the CLIs' default type with none asked for equals the JAX tools'
    choice per config (tools/train.py:163-165, tools/train_vae.py:122,
    tools/eval_quality.py:90-93);
  * the wrappers' checks of f32 operands (strides of 16 bytes, one type);
  * the plain versions in f32 against the JAX kernels as the JAX package's
    own tests run them on the CPU: K1 against `_fused_fwd(interpret=True)`,
    K2s against `tpu_splash_attention(interpret=True)`, K3 against
    `unet_flash_attention(interpret=True)`, each with its Q pre-scaled by
    the f32 factor;
  * `exact_f32` restores the caller's TF32 flags, and an f32 pipeline
    leaves them as they were;
  * `eval/vae_recon` against tools/eval_vae.py's arithmetic at tiny() (the
    JAX pipeline's `encode_images` / `decode_latents` on the same collated
    batches, JAX's posterior draw handed to the port): every modality's
    PSNR within 1e-3 dB.

Tolerances: K1 1e-5 * max|ref| (the same formula, f32 sums in another
order); K2s and K3 2e-5 * max|ref| (the JAX kernels' online softmax over
128-key blocks against one softmax over all keys, f32 throughout, as
tests/test_attn_kernel.py holds them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_rel_close, tiny_pipelines
from unirenderer_tpu.ops.attn_kernel import (
    unet_flash_attention as jax_unet_flash,
)
from unirenderer_tpu.ops.flash_attention import tpu_splash_attention
from unirenderer_tpu.ops.groupnorm import _fused_fwd
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.ops import flash_attention as fa
from unirenderer_tpu_torch.ops import groupnorm as gn
from unirenderer_tpu_torch.ops.attn_kernel import unet_flash_reference
from unirenderer_tpu_torch.ops.splash_attention import (
    splash_attention_reference,
)
from unirenderer_tpu_torch.utils.runtime import exact_f32

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()

CONFIGS = ("tiny", "small", "medium", "flagship")
# what the JAX tools compute in, per config: tools/train.py:163-165 and
# tools/eval_quality.py:90-93 (bf16 for flagship, f32 otherwise);
# tools/train_vae.py:122 (f32 always)
JAX_TRAIN = {"tiny": "float32", "small": "float32", "medium": "float32",
             "flagship": "bfloat16"}


# ---------------------------------------------------------------------------
# The compute type
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("asked,want", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16),
    (None, torch.bfloat16), ("float16", ValueError), ("float64", ValueError),
])
def test_resolve_compute_dtype_on_the_card(asked, want):
    from unirenderer_tpu_torch.train.trainer import resolve_compute_dtype
    cfg = dataclasses.replace(tcfg.tiny().train, compute_dtype=asked)
    card = torch.device("cuda")
    if want is ValueError:
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            resolve_compute_dtype(cfg, card)
    else:
        assert resolve_compute_dtype(cfg, card) == want


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", CONFIGS[:2] + CONFIGS[3:])
def test_train_cli_default_dtype_is_the_jax_tools(name, tmp_path,
                                                  monkeypatch):
    from unirenderer_tpu_torch.train import __main__ as cli
    from unirenderer_tpu_torch.train import trainer
    seen = {}

    def fake_trainer(cfg, workdir, **kwargs):
        seen["dtype"] = cfg.train.compute_dtype
        raise _Stop

    monkeypatch.setattr(trainer, "Trainer", fake_trainer)
    with pytest.raises(_Stop):
        cli.main(["--workdir", str(tmp_path), "--config", name,
                  "--synthetic", "--steps", "1", "--device", "cpu"])
    assert seen["dtype"] == JAX_TRAIN[name]


@pytest.mark.parametrize("name", ("tiny", "small", "flagship"))
def test_vae_cli_default_dtype_is_f32(name, tmp_path, monkeypatch):
    from unirenderer_tpu_torch.train import vae as cli
    from unirenderer_tpu_torch.train import vae_train
    seen = {}

    def fake_train_vae(cfg, batches, workdir, steps, **kwargs):
        seen["dtype"] = cfg.train.compute_dtype
        raise _Stop

    monkeypatch.setattr(vae_train, "train_vae", fake_train_vae)
    with pytest.raises(_Stop):
        cli.main(["--workdir", str(tmp_path), "--config", name,
                  "--synthetic", "--steps", "1", "--device", "cpu"])
    assert seen["dtype"] == "float32"


def test_quality_cli_default_dtype_is_the_jax_tools(monkeypatch):
    from unirenderer_tpu_torch.eval import quality
    seen = {}

    def fake_pipeline(device, dtype):
        seen["dtype"] = dtype
        raise _Stop

    monkeypatch.setattr(quality, "small_trained_pipeline", fake_pipeline)
    with pytest.raises(_Stop):
        quality.main(["--device", "cpu"])
    assert seen["dtype"] == getattr(torch, JAX_TRAIN["small"])


# ---------------------------------------------------------------------------
# The wrappers' checks of f32 operands (they raise before any launch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,pitch,error", [
    (torch.float32, 40, None),
    (torch.float32, 44, None),          # heads 176 bytes apart
    (torch.bfloat16, 44, "multiple of 8"),   # 88 bytes apart
    (torch.float32, 42, "multiple of 4"),
])
def test_attention_operands_strides_of_16_bytes(dtype, pitch, error):
    """Strides in elements a multiple of 16 bytes: 4 in f32, 8 in bf16."""
    q = torch.zeros((1, 16, 3, pitch), dtype=dtype)[..., :40]
    k = torch.zeros((1, 16, 3, 40), dtype=dtype)
    if error is None:
        assert fa.check_operands(q, k, k, fa.MAX_HEAD_DIM) == (
            1, 16, 16, 3, 40)
    else:
        with pytest.raises(ValueError, match=error):
            fa.check_operands(q, k, k, fa.MAX_HEAD_DIM)


@pytest.mark.parametrize("types,error", [
    ((torch.float16,) * 3, TypeError), ((torch.float64,) * 3, TypeError),
    ((torch.float32, torch.bfloat16, torch.float32), TypeError),
    ((torch.float32,) * 3, None), ((torch.bfloat16,) * 3, None),
])
def test_attention_operands_one_type_bf16_or_f32(types, error):
    q, k, v = (torch.zeros((1, 16, 2, 24), dtype=t) for t in types)
    if error is None:
        fa.check_operands(q, k, v, fa.MAX_HEAD_DIM)
    else:
        with pytest.raises(error):
            fa.check_operands(q, k, v, fa.MAX_HEAD_DIM)


@pytest.mark.parametrize("dtype,c,error", [
    (torch.float32, 36, None), (torch.float32, 18, ValueError),
    (torch.bfloat16, 36, ValueError), (torch.float16, 32, TypeError),
    (torch.float32, 4100, ValueError),
])
def test_groupnorm_kernel_takes_f32_with_c_a_multiple_of_4(dtype, c, error,
                                                           monkeypatch):
    """K1's checks: f32 x with C % 4 == 0 (4 channels a 16-byte vector), bf16
    with C % 8 == 0, C up to 4096; f16 raises.  A call that passes them
    goes on to load a kernel library (stopped here: the cooperative one,
    or for f32 first the cluster kernel's, whose plan decides the
    route)."""
    def no_library():
        raise _Stop
    monkeypatch.setattr(gn, "_lib", no_library)
    monkeypatch.setattr(gn, "_lib_f32", no_library)
    x = torch.zeros((1, 2, 2, c), dtype=dtype)
    w = torch.ones(c)
    with pytest.raises(error or _Stop):
        gn._launch(x, w, w, 2, 1e-5, True)


# ---------------------------------------------------------------------------
# The plain versions in f32 against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 8, 8, 32), 8, 1e-6, True),         # tiny()'s VAE level
    ((1, 5, 7, 36), 4, 1e-5, False),        # C % 8 != 0: f32 takes it
])
def test_plain_k1_f32_matches_jax_kernel(shape, groups, eps, silu):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bi = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    want = _fused_fwd(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi),
                      groups, eps, silu, interpret=True)
    got = gn.groupnorm_silu_reference(torch.from_numpy(x),
                                      torch.from_numpy(sc),
                                      torch.from_numpy(bi), groups, eps,
                                      silu)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert_rel_close(got.numpy(), np.asarray(want), 1e-5, "plain K1 f32")


def _qkv(shape, seed):
    ks = jax.random.split(jax.random.key(seed), 3)
    return [np.array(jax.random.normal(k, shape, jnp.float32)) for k in ks]


def test_plain_k2s_f32_matches_jax_splash_kernel():
    q, k, v = _qkv((1, 256, 2, 32), 3)
    want = tpu_splash_attention(*map(jnp.asarray, (q, k, v)), block_q=128,
                                block_kv=128, interpret=True)
    got = splash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert_rel_close(got.numpy(), np.asarray(want), 2e-5, "plain K2s f32")


@pytest.mark.parametrize("running_max", [True, False])
def test_plain_k3_f32_matches_jax_unet_flash_kernel(running_max):
    q, k, v = _qkv((2, 256, 2, 32), 4)
    want = jax_unet_flash(*map(jnp.asarray, (q, k, v)), block_q=128,
                          block_k=128, running_max=running_max,
                          interpret=True)
    got = unet_flash_reference(*map(torch.from_numpy, (q, k, v)),
                               running_max=running_max)
    assert_rel_close(got.numpy(), np.asarray(want), 2e-5, "plain K3 f32")


def test_k3_f32_prescale_is_the_f32_factor():
    """The f32 route pre-scales Q by softmax_scale * log2 e rounded to f32
    (JAX's `q.dtype` factor), not by the bf16 factor the bf16 kernel
    stages with."""
    from unirenderer_tpu_torch.ops import attn_kernel as k3
    d = 40
    f32 = fa.prescale_factor(torch.float32, k3._factor(d))
    assert f32 == float(np.float32(1.0 / np.sqrt(d) * np.log2(np.e)))
    assert f32 != k3.qscale(d)
    q = torch.from_numpy(_qkv((1, 4, 1, d), 5)[0])
    want = np.asarray(jnp.asarray(q.numpy())
                      * jnp.asarray(1.0 / np.sqrt(d) * np.log2(np.e),
                                    jnp.float32))
    assert np.array_equal(fa.prescale_q(q, k3._factor(d)).numpy(), want)


# ---------------------------------------------------------------------------
# TF32
# ---------------------------------------------------------------------------


def test_exact_f32_restores_the_callers_flags():
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    try:
        mm.allow_tf32, dnn.allow_tf32 = True, True
        with exact_f32():
            assert not mm.allow_tf32 and not dnn.allow_tf32
        assert mm.allow_tf32 and dnn.allow_tf32
        with exact_f32(False):
            assert mm.allow_tf32 and dnn.allow_tf32
        with pytest.raises(_Stop):
            with exact_f32():
                raise _Stop
        assert mm.allow_tf32 and dnn.allow_tf32
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def test_f32_pipeline_runs_without_tf32_and_restores_the_flags():
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    pipe = UniRendererPipeline.create(tcfg.tiny(), torch.Generator()
                                      .manual_seed(0), device="cpu",
                                      dtype=torch.float32)
    decode, seen = pipe.vae.decode, []

    def watched(z):
        seen.append((mm.allow_tf32, dnn.allow_tf32))
        return decode(z)

    pipe.vae.decode = watched
    saved = (mm.allow_tf32, dnn.allow_tf32)
    try:
        mm.allow_tf32, dnn.allow_tf32 = True, True
        pipe._vae_decode(torch.zeros((1, 8, 8, 4)))
        assert seen == [(False, False)]
        assert mm.allow_tf32 and dnn.allow_tf32
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# The held-out VAE reconstruction eval against tools/eval_vae.py
# ---------------------------------------------------------------------------


def test_vae_recon_matches_jax_tool_arithmetic(tmp_path):
    from unirenderer_tpu.eval import metrics as jm
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    from unirenderer_tpu_torch.eval import vae_recon
    from unirenderer_tpu_torch.eval.quality import held_out_paths
    jpipe, tpipe = tiny_pipelines()
    cfg = tpipe.cfg
    write_dataset(str(tmp_path), n_mesh=3, n_env=2, env_res=16,
                  env_min_res=4, env_samples=16, sphere_res=8, tex_res=16,
                  seed=99, device="cpu", log=lambda msg: None)
    meshes, envs = held_out_paths(str(tmp_path))
    n = 10                                  # two batches: 8 and 2 items

    def jax_draws(start, shape, device):
        # pipelines.py:164: jax.random.normal(key, mean.shape, mean.dtype)
        z = jax.random.normal(jax.random.key(start), shape, jnp.float32)
        return torch.from_numpy(np.array(z))

    got = vae_recon.reconstruction_psnr(tpipe, meshes, envs, n=n,
                                        draws=jax_draws)
    # tools/eval_vae.py:68-82, on the port's collated batches
    want = {m: [] for m in vae_recon.MODALITIES}
    for start, images in vae_recon.recon_batches(cfg, meshes, envs, n,
                                                 "cpu"):
        for name in vae_recon.MODALITIES:
            img = jnp.asarray(images[name].numpy())
            z = jpipe.encode_images(img, jax.random.key(start))
            dec = np.clip(np.asarray(jpipe.decode_latents(z)), -1, 1)
            gt = (np.asarray(img) + 1) / 2
            want[name].append(float(jm.psnr((dec + 1) / 2, gt)))
    assert got["n"] == n and set(got["psnr"]) == set(want)
    for name, vals in want.items():
        assert abs(got["psnr"][name] - np.mean(vals)) <= 1e-3, (
            name, got["psnr"][name], np.mean(vals))
    assert abs(got["psnr_mean"]
               - np.mean([np.mean(v) for v in want.values()])) <= 1e-3
