"""The port's two kernels: their plain PyTorch versions against the JAX
package's TPU kernels (run as the JAX tests run them on the CPU), the
wrappers' dispatch and the build.  The CUDA kernels themselves are tested
on the card by tests/test_torch_card.py.

Tolerances, f32 on both sides: GroupNorm 1e-5 * max|ref| (same formula,
f32 reduction order), attention 2e-5 * max|ref| (the TPU kernel's online
softmax against a dense softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_port_helpers import assert_rel_close
from unirenderer_tpu.models.layers import dmajor_attention
from unirenderer_tpu.ops.flash_attention import tpu_flash_attention
from unirenderer_tpu.ops.groupnorm import _fused_fwd
from unirenderer_tpu_torch.ops import _build
from unirenderer_tpu_torch.ops.flash_attention import (
    attention_reference, flash_attention,
)
from unirenderer_tpu_torch.ops.groupnorm import (
    fused_groupnorm_silu, groupnorm_silu_reference,
)

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()

def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bi = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    return x, sc, bi


@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 8, 8, 64), 8, 1e-5, True),
    ((2, 8, 8, 64), 8, 1e-6, False),
    ((1, 6, 10, 80), 8, 1e-5, True),        # C/G = 10, as 320/32
    ((2, 4, 4, 96), 24, 1e-6, True),        # C/G = 4, as the VAE's 128/32
])
def test_groupnorm_plain_matches_pallas_kernel(shape, groups, eps, silu):
    x, sc, bi = _gn_inputs(shape, seed=sum(shape))
    want = _fused_fwd(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi),
                      groups, eps, silu, interpret=True)
    got = groupnorm_silu_reference(torch.from_numpy(x), torch.from_numpy(sc),
                                   torch.from_numpy(bi), groups, eps, silu)
    assert_rel_close(got, np.asarray(want), 1e-5, "groupnorm")


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s,d", [(128, 40), (256, 80), (128, 128)])
def test_attention_plain_matches_pallas_flash(s, d):
    q, k, v = _qkv(2, s, s, 4, d, seed=s + d)
    with pltpu.force_tpu_interpret_mode():
        want = tpu_flash_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_rel_close(got, np.asarray(want), 2e-5, f"flash s={s} d={d}")


@pytest.mark.parametrize("sq,sk,d", [(256, 77, 40), (64, 77, 160),
                                     (256, 256, 160)])
def test_attention_plain_matches_dmajor(sq, sk, d):
    """The shapes the TPU left to XLA: cross-attention over 77 keys and
    the D=160 levels."""
    q, k, v = _qkv(2, sq, sk, 4, d, seed=sq + sk + d)
    want = dmajor_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_rel_close(got, np.asarray(want), 2e-5, f"dmajor {sq}/{sk}/{d}")


def test_wrappers_run_plain_version_on_cpu_without_counting():
    x, sc, bi = (torch.from_numpy(a) for a in _gn_inputs((2, 4, 4, 32), 0))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 9, 2, 8, 0))
    n_gn, n_fa = fused_groupnorm_silu.launches, flash_attention.launches
    assert torch.equal(fused_groupnorm_silu(x, sc, bi, 8, 1e-5, True),
                       groupnorm_silu_reference(x, sc, bi, 8, 1e-5, True))
    assert torch.equal(flash_attention(q, k, v), attention_reference(q, k, v))
    assert (fused_groupnorm_silu.launches, flash_attention.launches) == (
        n_gn, n_fa)


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    card is refused."""
    x = torch.empty((2, 4, 4, 32), device="meta")
    w = torch.empty(32, device="meta")
    with pytest.raises(ValueError):
        fused_groupnorm_silu(x, w, w, 8, 1e-5, True)
    q = torch.empty((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_library_name_tracks_source_and_flags():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
