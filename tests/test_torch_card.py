"""The port's CUDA kernels and its pipeline on the card.

Every test here needs a CUDA card and is marked `gpu`; without one each
skips in its body.  The file imports no JAX, so on a machine with a card
and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_card.py

Tolerance: bf16 in and out, max|kernel - plain| <= 2^-7 * max|plain|: the
rounding of a bf16 output plus the bf16 rounding of the softmax
probabilities fed to the tensor cores.  The plain versions run in f32 on
the same bf16 inputs, with TF32 off.
"""

import numpy as np
import pytest
import torch

from unirenderer_tpu_torch.core import config
from unirenderer_tpu_torch.ops import _build
from unirenderer_tpu_torch.ops.flash_attention import (
    attention_reference, flash_attention,
)
from unirenderer_tpu_torch.ops.groupnorm import (
    fused_groupnorm_silu, groupnorm_silu_reference,
)
from unirenderer_tpu_torch.pipelines import UniRendererPipeline

REL = 2.0 ** -7
pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    tol = REL * want.float().abs().max().item()
    assert err <= tol, f"{what}: max|diff| {err:.3g} > {tol:.3g}"


def test_build_produces_both_libraries(card):
    built = _build.build()
    assert set(built) == set(_build.SOURCES)
    for b in built.values():
        assert b.path.exists() and b.path.parent == _build.BUILD_DIR


@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 64, 64, 320), 32, 1e-5, True),
    ((2, 16, 16, 1920), 32, 1e-5, True),
    ((2, 64, 64, 320), 32, 1e-6, False),
    ((2, 8, 8, 2560), 32, 1e-5, True),
    ((1, 37, 29, 128), 32, 1e-6, True),     # odd HW, C/G = 4
])
def test_groupnorm_kernel(card, shape, groups, eps, silu):
    g = torch.Generator(device=card).manual_seed(0)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=card) * 2 + 0.5).bfloat16()
    sc = 1 + 0.1 * torch.randn(c, generator=g, device=card)
    bi = 0.1 * torch.randn(c, generator=g, device=card)
    n = fused_groupnorm_silu.launches
    got = fused_groupnorm_silu(x, sc, bi, groups, eps, silu)
    torch.cuda.synchronize()
    assert fused_groupnorm_silu.launches == n + 1
    _close(got, groupnorm_silu_reference(x.float(), sc, bi, groups, eps,
                                         silu), "groupnorm")


def test_groupnorm_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros((1, 4, 4, 20), dtype=torch.bfloat16, device=card)
    w = torch.ones(20, device=card)
    with pytest.raises(ValueError):                 # C % 8 != 0
        fused_groupnorm_silu(x, w, w, 4, 1e-5, True)
    with pytest.raises(TypeError):                  # f32 input
        fused_groupnorm_silu(torch.zeros((1, 4, 4, 32), device=card),
                             torch.ones(32, device=card),
                             torch.ones(32, device=card), 8, 1e-5, True)


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160),
    (2, 64, 77, 8, 160), (1, 1000, 333, 3, 24), (2, 16, 16, 4, 128),
])
def test_flash_attention_kernel(card, b, sq, sk, h, d):
    g = torch.Generator(device=card).manual_seed(1)
    q = torch.randn((b, sq, h, d), generator=g, device=card).bfloat16()
    k = torch.randn((b, sk, h, d), generator=g, device=card).bfloat16()
    v = torch.randn((b, sk, h, d), generator=g, device=card).bfloat16()
    n = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    _close(got, attention_reference(q.float(), k.float(), v.float()),
           "flash attention")


def test_flash_attention_kernel_reads_strided_heads(card):
    """q/k/v as views into one fused projection (non-contiguous S stride)."""
    g = torch.Generator(device=card).manual_seed(2)
    qkv = torch.randn((2, 300, 3, 4, 40), generator=g, device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    _close(flash_attention(q, k, v),
           attention_reference(q.float(), k.float(), v.float()), "strided")


def test_flash_attention_kernel_refuses_head_dim_over_160(card):
    q = torch.zeros((1, 16, 1, 192), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


def test_tiny_pipeline_on_card_runs_both_kernels(card):
    cfg = config.tiny()
    gen = torch.Generator(device=card).manual_seed(0)
    pipe = UniRendererPipeline.create(cfg, gen, device=card)
    res = cfg.vae.sample_size
    rng = np.random.default_rng(0)
    maps = {k: rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
            for k in ("normal", "albedo", "spec_light", "diff_light", "env",
                      "mask")}
    n_gn, n_fa = fused_groupnorm_silu.launches, flash_attention.launches
    out = pipe.mask2image_3mod_albedo(
        **maps, metallic=[0.1, 0.9], roughness=[0.5, 0.2], generator=gen)
    torch.cuda.synchronize()
    assert out.shape == (2, res, res, 3)
    assert torch.isfinite(out).all()
    assert fused_groupnorm_silu.launches > n_gn
    assert flash_attention.launches > n_fa
