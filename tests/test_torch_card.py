"""The port's CUDA kernels and its pipeline on the card.

Every test here needs a CUDA card and is marked `gpu`; without one each
skips in its body.  The file imports no JAX, so on a machine with a card
and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_card.py

Tolerance: bf16 in and out, max|kernel - plain| <= 2^-7 * max|plain|: the
rounding of a bf16 output plus the bf16 rounding of the softmax
probabilities fed to the tensor cores.  The attention backward (K2 bwd):
each of dQ, dK, dV within 2^-6 * max|plain| of the plain backward in f32
on the same bf16 inputs (P and dS are also rounded to bf16 for the tensor
cores), the forward's log-sum-exp within 2^-14 of the plain f32 one of its
bf16 inputs (the kernel scales the f32 scores in f32, as JAX does), and
two backward runs on the same inputs within 2^-8 * max|plain| of each
other (dQ's f32 sums are atomic adds in no fixed order).  A train step on
the card (bf16) against the same step in f32 on the CPU: loss within 2 %,
gradient cosine >= 0.99, norm ratio within 2 % (tiny() random weights; the
bf16 gap alone measures well inside that).  The plain versions run in f32 on
the same bf16 inputs, with TF32 off.  The rasterizer (f32) is held to the
rule of tests/test_rasterize_pallas.py (`ops.rasterize.within_rule`:
coverage equal, z and u, v within 1e-5, < 2 % of triangle ids different,
only where both sides hit) and bit-equal to its plain version, its set-up
bit-equal to `_setup` and its tile lists equal to `rast_bins_reference`;
the collate on the card to 1e-3 against the same collate on the CPU on
>= 99 % of values (clip positions from cuBLAS and from the CPU can differ
by an ulp, which can move a silhouette subsample).  The sampling modes
(encoder reuse, guidance, joint sampling) at small() with the trained
weights, 3 steps, on the card within 0.05 * max|ref| of f32 on the CPU.

The f32 kernels (f32 in and out) against their plain versions in f32:
K1 within 2^-16 * max|plain| and a rerun bit-equal; K2, K2s and K3 within
2^-14 * max|plain| (f32 FMAs summed in another order than the CPU's, and
exp2 on the special-function unit), K2's log-sum-exp within 2^-16; K2 bwd's
dQ, dK, dV within 2^-12 * max|plain| and a rerun within the same (no
atomics: the same bits).  tiny() in f32 on the card against f32 on the
CPU: the model within 1e-4 * max|ref|, a train step's loss within 1e-4,
gradient cosine >= 0.99999.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from unirenderer_tpu_torch.core import config
from unirenderer_tpu_torch.ops import _build
from unirenderer_tpu_torch.ops.attn_kernel import (
    unet_flash_attention, unet_flash_reference,
)
from unirenderer_tpu_torch.ops.flash_attention import (
    attention_backward_reference, attention_reference, flash_attention,
    attention_lse_reference, flash_attention_backward,
    flash_attention_with_lse,
)
from unirenderer_tpu_torch.ops.groupnorm import (
    fused_groupnorm_silu, groupnorm_silu_reference,
)
from unirenderer_tpu_torch.ops.rasterize import (
    _setup, match_stats, rast_bins_reference, rasterize, rasterize_reference,
    rasterize_with_bins, within_rule,
)
from unirenderer_tpu_torch.ops.splash_attention import (
    splash_attention, splash_attention_reference,
)
from unirenderer_tpu_torch.pipelines import UniRendererPipeline

from torch_port_helpers import use_one_thread

REL = 2.0 ** -7
pytestmark = pytest.mark.gpu
if not torch.cuda.is_available():
    use_one_thread()      # on the card the CPU references keep every core


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


def test_build_produces_every_library(card):
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


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 64, 64, 320), 32, 1e-5, True),
    ((2, 8, 8, 2560), 32, 1e-5, True),
    ((1, 37, 29, 128), 32, 1e-6, True),
    ((1, 4, 4, 24), 3, 1e-5, False),        # odd groups, tiny HW
])
def test_groupnorm_kernel_param_types_and_rerun(card, shape, groups, eps,
                                                silu, param_dtype):
    """Scale and bias read in their own type (the model passes bf16), and
    a second run on the same inputs gives the same bits (the statistics
    merge in a fixed order)."""
    g = torch.Generator(device=card).manual_seed(5)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=card) * 2 + 0.5).bfloat16()
    sc = (1 + 0.1 * torch.randn(c, generator=g, device=card)).to(param_dtype)
    bi = (0.1 * torch.randn(c, generator=g, device=card)).to(param_dtype)
    got = fused_groupnorm_silu(x, sc, bi, groups, eps, silu)
    again = fused_groupnorm_silu(x, sc, bi, groups, eps, silu)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, groupnorm_silu_reference(x.float(), sc, bi, groups, eps,
                                         silu), "groupnorm")


def _device_kernels(fn):
    """(name, count) of every device kernel one call of fn runs.  Spin
    kernels and a pause come first in the session (dropped): after an
    earlier session in the process, a session can lose the device events
    at its very start."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and "spin_kernel" not in e.key]


def test_groupnorm_kernel_is_one_device_kernel_a_call(card):
    x = torch.randn((2, 64, 64, 320), device=card).bfloat16()
    w = torch.ones(320, device=card, dtype=torch.bfloat16)
    kernels = _device_kernels(
        lambda: fused_groupnorm_silu(x, w, w, 32, 1e-5, True))
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "gn_fused_kernel" in kernels[0][0]


def test_groupnorm_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros((1, 4, 4, 20), dtype=torch.bfloat16, device=card)
    w = torch.ones(20, device=card)
    with pytest.raises(ValueError):                 # C % 8 != 0
        fused_groupnorm_silu(x, w, w, 4, 1e-5, True)
    with pytest.raises(ValueError):                 # f32, C % 4 != 0
        fused_groupnorm_silu(torch.zeros((1, 4, 4, 18), device=card),
                             torch.ones(18, device=card),
                             torch.ones(18, device=card), 2, 1e-5, True)
    with pytest.raises(TypeError):                  # f16 input
        fused_groupnorm_silu(torch.zeros((1, 4, 4, 32), device=card).half(),
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


def _qkv(card, b, sq, sk, h, d, seed, scale=1.0):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple((scale * torch.randn((b, n, h, d), generator=g,
                                      device=card)).bfloat16()
                 for n in (sq, sk, sk))


@pytest.mark.parametrize("b,s,h,d", [(2, 4096, 8, 40), (2, 256, 4, 128)])
def test_splash_attention_kernel(card, b, s, h, d):
    q, k, v = _qkv(card, b, s, s, h, d, seed=3)
    n = splash_attention.launches
    got = splash_attention(q, k, v)
    torch.cuda.synchronize()
    assert splash_attention.launches == n + 1
    _close(got, splash_attention_reference(q, k, v, torch.float32),
           "splash attention")


def test_splash_attention_refuses_untileable_shapes(card):
    q = torch.zeros((1, 77, 2, 40), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        splash_attention(q, q, q)


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("running_max", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 1024, 1024, 8, 80),
                                         (1, 200, 77, 3, 24),
                                         (2, 320, 320, 4, 40),
                                         (2, 256, 256, 2, 8),
                                         (2, 256, 256, 2, 128)])
def test_unet_flash_kernel(card, b, sq, sk, h, d, pipelined, running_max):
    # bounded logits (|q.k|/sqrt(d) well under 26) for running_max=False
    q, k, v = _qkv(card, b, sq, sk, h, d, seed=4,
                   scale=1.0 if running_max else 0.5)
    n = unet_flash_attention.launches
    got = unet_flash_attention(q, k, v, pipelined=pipelined,
                               running_max=running_max)
    torch.cuda.synchronize()
    assert unet_flash_attention.launches == n + 1
    _close(got, unet_flash_reference(q, k, v, running_max, torch.float32),
           "unet_flash")


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("running_max", [True, False])
def test_unet_flash_kernel_reads_strided_heads(card, pipelined,
                                               running_max):
    """q/k/v as views into one fused projection (non-contiguous S stride,
    head stride below it): the tensor maps take the strides as they are."""
    g = torch.Generator(device=card).manual_seed(6)
    scale = 1.0 if running_max else 0.5
    qkv = (scale * torch.randn((2, 300, 3, 4, 40), generator=g,
                               device=card)).bfloat16()
    q, k, v = qkv.unbind(2)
    _close(unet_flash_attention(q, k, v, pipelined=pipelined,
                                running_max=running_max),
           unet_flash_reference(q, k, v, running_max, torch.float32),
           "unet_flash strided")


def test_unet_flash_is_one_device_kernel_a_call(card):
    """Q's pre-scale happens inside the kernel: no elementwise launch."""
    q, k, v = _qkv(card, 2, 1024, 1024, 8, 40, seed=8)
    kernels = _device_kernels(lambda: unet_flash_attention(q, k, v))
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "unet_flash_kernel" in kernels[0][0]


def test_unet_flash_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 1536, 2, 40), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="not divisible"):
        unet_flash_attention(q, q, q)
    q = torch.zeros((1, 256, 1, 160), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        unet_flash_attention(q, q, q)


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


def _deformed_spheres(card, views, res, t_pad, seed):
    """Clip positions (B, t_pad, 4) and triangles (B, t_pad, 3) of deformed
    spheres (the data generator's shapes) seen from random cameras."""
    from unirenderer_tpu_torch.data.synthetic import make_shape
    from unirenderer_tpu_torch.ops.transform import xfm_points
    from unirenderer_tpu_torch.render import camera
    from unirenderer_tpu_torch.render.mesh import (
        make_sphere, unit_normalize_mesh,
    )
    rng = np.random.default_rng(seed)
    base = make_sphere(res)
    pos, tris = [], []
    for _ in range(views):
        v = np.zeros((t_pad, 3), np.float32)
        v[:base.v_pos.shape[0]] = unit_normalize_mesh(
            make_shape(base.v_pos, rng))
        t = np.zeros((t_pad, 3), np.int32)
        t[:base.t_pos_idx.shape[0]] = base.t_pos_idx
        mvp, _ = camera.spherical_camera(rng.uniform(0, 360),
                                         rng.uniform(30, 150), 4.0)
        pos.append(xfm_points(torch.from_numpy(v)[None].to(card),
                              mvp[None].to(card))[0])
        tris.append(torch.from_numpy(t).to(card))
    return torch.stack(pos), torch.stack(tris)


@pytest.mark.parametrize("views,res,t_pad,h,w", [
    (2, 32, 8192, 128, 128),            # the small() collate shape
    (1, 20, 2048, 75, 53),              # ragged: not multiples of 16
])
def test_rasterize_kernel(card, views, res, t_pad, h, w):
    pos, tri = _deformed_spheres(card, views, res, t_pad, seed=h)
    n = rasterize.launches
    got = rasterize(pos, tri, h, w)
    torch.cuda.synchronize()
    assert rasterize.launches == n + 1
    want = rasterize_reference(pos, tri, h, w)
    stats = match_stats(got, want)
    assert within_rule(stats) and stats["bit_equal"], stats
    assert (got.tri_id > 0).float().mean() > 0.05


def test_rasterize_kernel_peels(card):
    pos, tri = _deformed_spheres(card, 2, 32, 8192, seed=3)
    first = rasterize_reference(pos, tri, 128, 128)
    got = rasterize(pos, tri, 128, 128, prev_z=first.z.contiguous())
    want = rasterize_reference(pos, tri, 128, 128, prev_z=first.z)
    stats = match_stats(got, want)
    assert within_rule(stats) and stats["bit_equal"], stats
    assert (got.tri_id > 0).any()          # the back of the shape


@pytest.mark.parametrize("h,w", [(128, 128), (75, 53)])
def test_rasterize_setup_and_tile_lists(card, h, w):
    """The set-up kernel's records and boxes are `_setup`'s, bit for bit;
    the tile lists, each sorted (the fill's atomics order them), are
    `rast_bins_reference`'s."""
    pos, tri = _deformed_spheres(card, 2, 32, 8192, seed=h)
    _, rec, box, bins = rasterize_with_bins(pos, tri, h, w)
    want_rec, want_box = _setup(pos, tri, h, w)
    assert torch.equal(rec.view(torch.int32), want_rec.view(torch.int32))
    assert torch.equal(box.view(torch.int32), want_box.view(torch.int32))
    want = rast_bins_reference(want_box, h, w)
    assert torch.equal(bins.start, want.start)
    assert torch.equal(bins.wide_count, want.wide_count)
    start = want.start.long().tolist()
    for i in range(len(start) - 1):
        got_list = torch.sort(bins.pairs[start[i]:start[i + 1]]).values
        assert torch.equal(got_list, want.pairs[start[i]:start[i + 1]]), i


@pytest.mark.parametrize("tri_dtype", [torch.int32, torch.int64])
def test_rasterize_full_screen_and_wide_triangles(card, tri_dtype):
    """A triangle over the whole 200 x 300 view (more than 64 tiles: the
    wide list) in front of a sphere, int32 and int64 indices."""
    pos, tri = _deformed_spheres(card, 1, 20, 2048, seed=8)
    pos[0, -3:] = torch.tensor([[-1.0, -1.0, -0.5, 1.0],
                                [3.0, -1.0, -0.5, 1.0],
                                [-1.0, 3.0, -0.5, 1.0]], device=card)
    tri[0, -1] = torch.tensor([2045, 2046, 2047])
    tri = tri.to(tri_dtype)
    got = rasterize(pos, tri, 200, 300)
    want = rasterize_reference(pos, tri, 200, 300)
    assert match_stats(got, want)["bit_equal"]
    assert (got.tri_id == 2048).all()
    _, _, _, bins = rasterize_with_bins(pos, tri, 200, 300)
    assert bins.wide_count.tolist() == [1]


def test_rasterize_degenerate_triangles_cover_nothing(card):
    pos, tri = _deformed_spheres(card, 2, 20, 2048, seed=9)
    tri[..., 2] = tri[..., 0]                         # repeated indices
    got = rasterize(pos, tri, 96, 80)
    assert (got.tri_id == 0).all() and (got.z == 0).all()
    _, _, _, bins = rasterize_with_bins(pos, tri, 96, 80)
    assert bins.pairs.numel() == 0 and bins.wide_count.tolist() == [0, 0]


def test_rasterize_is_five_device_operations_a_call(card):
    pos, tri = _deformed_spheres(card, 2, 32, 8192, seed=10)
    ops = _device_kernels(lambda: rasterize(pos, tri, 128, 128))
    assert sum(c for _, c in ops) <= 5, ops
    assert sum(c for k, c in ops if "rast_" in k) == 4, ops


def test_rasterize_kernel_refuses_what_it_does_not_take(card):
    pos, tri = _deformed_spheres(card, 1, 8, 256, seed=4)
    with pytest.raises(TypeError):
        rasterize(pos.double(), tri, 16, 16)
    with pytest.raises(ValueError):
        rasterize(pos, tri, 16, 16,
                  prev_z=torch.zeros((1, 8, 8), device=card))


def test_collate_render_on_card_matches_cpu(card, tmp_path):
    """small(): the held-out generator's data, 4 items, on the card (K4)
    and on the CPU (plain versions)."""
    from unirenderer_tpu_torch.data import objaverse, synthetic
    from unirenderer_tpu_torch.eval.quality import held_out_paths
    synthetic.write_dataset(str(tmp_path), n_mesh=4, n_env=2, env_res=32,
                            env_min_res=8, seed=99, device="cpu")
    meshes, envs = held_out_paths(str(tmp_path))
    ds = objaverse.ObjaverseDataTest(config.small().data, meshes, envs,
                                     seed=1234)
    items = [ds[i] for i in range(4)]
    n = rasterize.launches
    got = objaverse.collate_render(items, resolution=64, device=card)
    torch.cuda.synchronize()
    assert rasterize.launches == n + 1
    want = objaverse.collate_render(items, resolution=64, device="cpu")
    for k, w in want.items():
        g = got[k].cpu()
        assert g.shape == w.shape and torch.isfinite(g).all(), k
        close = ((g - w).abs() <= 1e-3).float().mean().item()
        assert close >= 0.99, (k, close)


def _tiny_inverse_request(cfg, b, seed):
    rng = np.random.default_rng(seed)
    res = cfg.vae.sample_size
    image = rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32)
    mask = np.where(rng.uniform(size=(b, res, res, 1)) > 0.3, 1.0, -1.0)
    return image, np.repeat(mask, 3, -1).astype(np.float32)


@pytest.mark.parametrize("route", ["auto", "splash", "unet_flash"])
def test_tiny_inverse_on_card(card, route, monkeypatch):
    """Inverse rendering at tiny(16) (a 16^2 latent: the 256-token
    self-attention is tileable) under each attention route: finite maps of
    the right shapes, and the route's kernel launched."""
    monkeypatch.setenv("UNIRENDER_ATTN", route)
    cfg = config.tiny(16)
    gen = torch.Generator(device=card).manual_seed(0)
    pipe = UniRendererPipeline.create(cfg, gen, device=card)
    image, mask = _tiny_inverse_request(cfg, 2, seed=1)
    counters = {"auto": flash_attention, "splash": splash_attention,
                "unet_flash": unet_flash_attention}
    n = counters[route].launches
    out = pipe.real_image2mask_3mod_albedo(image=image, mask=mask,
                                           generator=gen, ensemble=2)
    torch.cuda.synchronize()
    res = cfg.vae.sample_size
    for key in ("normal", "albedo", "spec_light", "diff_light", "env"):
        assert out[key].shape == (2, res, res, 3), key
        assert torch.isfinite(out[key]).all(), key
    for key in ("metallic", "roughness"):
        assert out[key].shape == (2, res, res), key
        assert torch.isfinite(out[key]).all(), key
    assert counters[route].launches > n


# ---------------------------------------------------------------------------
# Training: the attention backward (K2 bwd) and the step on the card
# ---------------------------------------------------------------------------


def _check_backward(q, k, v, do, what):
    o, lse = flash_attention_with_lse(q, k, v)
    lse_ref = attention_lse_reference(q, k, v)[1]
    n = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == n + 1
    lse_err = (lse - lse_ref).abs().max().item()
    assert lse_err <= 2.0 ** -14, f"{what} lse: {lse_err:.3g}"
    want = attention_backward_reference(q, k, v, o, lse, do, torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        err = (g.float() - w).abs().max().item()
        tol = 2.0 ** -6 * w.abs().max().item()
        assert err <= tol, f"{what} {name}: max|diff| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 256, 77, 8, 40),
    (2, 64, 64, 8, 160), (2, 64, 77, 8, 160), (1, 1000, 333, 3, 24),
    (2, 16, 16, 2, 16),
])
def test_flash_attention_backward_kernel(card, b, sq, sk, h, d):
    q, k, v = _qkv(card, b, sq, sk, h, d, seed=5)
    g = torch.Generator(device=card).manual_seed(6)
    do = torch.randn((b, sq, h, d), generator=g, device=card).bfloat16()
    _check_backward(q, k, v, do, f"({b},{sq},{sk},{h},{d})")


def test_flash_attention_backward_reads_strided_operands(card):
    g = torch.Generator(device=card).manual_seed(7)
    qkv = torch.randn((2, 300, 3, 4, 40), generator=g, device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    do = torch.randn((2, 300, 2, 4, 40), generator=g,
                     device=card).bfloat16()[:, :, 0]
    _check_backward(q, k, v, do, "strided")


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 4096, 77, 8, 40), (2, 256, 256, 8, 160),
])
def test_flash_attention_backward_reruns_agree(card, b, sq, sk, h, d):
    """dQ (and dK, dV where the kernel splits the query tiles) sums f32
    atomic adds in no fixed order: two runs on the same inputs may differ in
    the last bits, never by more than a small part of the tolerance."""
    q, k, v = _qkv(card, b, sq, sk, h, d, seed=9)
    g = torch.Generator(device=card).manual_seed(10)
    do = torch.randn((b, sq, h, d), generator=g, device=card).bfloat16()
    o, lse = flash_attention_with_lse(q, k, v)
    first = flash_attention_backward(q, k, v, o, lse, do)
    second = flash_attention_backward(q, k, v, o, lse, do)
    want = attention_backward_reference(q, k, v, o, lse, do, torch.float32)
    for name, a, c, w in zip(("dq", "dk", "dv"), first, second, want):
        diff = (a.float() - c.float()).abs().max().item()
        assert diff <= 2.0 ** -8 * w.abs().max().item(), f"{name}: {diff}"


def test_flash_attention_autograd_on_card(card):
    q, k, v = (t.requires_grad_() for t in _qkv(card, 2, 256, 77, 4, 40, 8))
    n_f, n_b = flash_attention.launches, flash_attention_backward.launches
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == n_f + 1
    assert flash_attention_backward.launches == n_b + 1
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def test_flash_attention_backward_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 16, 1, 40), dtype=torch.bfloat16, device=card)
    lse = torch.zeros((1, 1, 16), device=card)
    with pytest.raises(ValueError):                 # lse of the wrong shape
        flash_attention_backward(q, q, q, q, lse[:, :, :8], q)
    with pytest.raises(TypeError):                  # f32 operands
        flash_attention_backward(q.float(), q, q, q, lse, q)


def _tiny_trainers(card, tmp_path):
    """tiny() trainers on the card (bf16) and on the CPU (f32) holding the
    same weights."""
    from unirenderer_tpu_torch.core.convert import flax_from_module
    from unirenderer_tpu_torch.train.trainer import Trainer
    cfg = config.tiny()
    on_card = Trainer(cfg, str(tmp_path / "card"), device=card)
    on_cpu = Trainer(cfg, str(tmp_path / "cpu"), device="cpu")
    for part in ("dual", "vae", "text"):
        flat = flax_from_module(getattr(on_card, part))
        getattr(on_cpu, f"install_{part}")(flat)
    return cfg, on_card, on_cpu


@pytest.mark.parametrize("inverse", [True, False])
def test_tiny_train_step_on_card_matches_cpu(card, tmp_path, inverse):
    from unirenderer_tpu_torch.train.compare import (
        agreement, smooth_batch, step_grads,
    )
    from unirenderer_tpu_torch.train.train_step import draw
    cfg, on_card, on_cpu = _tiny_trainers(card, tmp_path)
    batch = smooth_batch(cfg, 2, seed=0)
    lat = cfg.vae.sample_size // cfg.vae.downscale
    draws = draw(torch.Generator().manual_seed(1), 2, (lat, lat), 1000,
                 inverse)
    r = agreement(step_grads(on_card, batch, draws),
                  step_grads(on_cpu, batch, draws))
    assert r["loss_rel_err"] <= 0.02, r
    assert r["grad_cos"] >= 0.99, r
    assert abs(r["norm_ratio"] - 1) <= 0.02, r


@pytest.mark.parametrize("inverse", [True, False])
def test_every_dual_parameter_gets_a_gradient_on_card(card, tmp_path,
                                                      inverse):
    """K1 and K2 under autograd on CUDA: no parameter upstream of a kernel
    call is cut off from the loss."""
    from unirenderer_tpu_torch.train.compare import smooth_batch
    from unirenderer_tpu_torch.train.train_step import (
        draw, make_grad_fn, train_step_launches,
    )
    from unirenderer_tpu_torch.train.trainer import Trainer
    cfg = config.tiny()
    tr = Trainer(cfg, str(tmp_path), device=card)
    batch = {k: v.to(card) for k, v in smooth_batch(cfg, 2, 0).items()}
    lat = cfg.vae.sample_size // cfg.vae.downscale
    draws = draw(torch.Generator().manual_seed(2), 2, (lat, lat), 1000,
                 inverse).to(card)
    counters = {"groupnorm_silu": fused_groupnorm_silu,
                "flash_attention": flash_attention,
                "flash_attention_backward": flash_attention_backward}
    before = {k: c.launches for k, c in counters.items()}
    grads, metrics = make_grad_fn(cfg, tr.dual, tr.vae, tr.schedule,
                                  tr.compute_dtype)(tr.state.params, batch,
                                                    tr.ctx, draws)
    torch.cuda.synchronize()
    names = list(tr.state.params)
    assert len(grads) == len(names)
    for name, g in zip(names, grads):
        assert g is not None and g.dtype == torch.float32, name
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
    want = train_step_launches(cfg, 2, inverse)
    for k, c in counters.items():
        assert c.launches - before[k] == want[k], k
    before = [p.detach().clone() for p in tr.state.params.values()]
    metrics = tr.step(batch, is_inverse=inverse)
    assert torch.isfinite(metrics["loss"]) and tr.state.step == 1
    assert all(not torch.equal(a, p) for a, p in
               zip(before, tr.state.params.values()))


# ---------------------------------------------------------------------------
# The sampling modes: encoder reuse, guidance, joint sampling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_pipes():
    """The trained small() pipeline on the card (bf16) and on the CPU
    (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from unirenderer_tpu_torch.eval.quality import small_trained_pipeline
    return (small_trained_pipeline("cuda", torch.bfloat16),
            small_trained_pipeline("cpu", torch.float32))


@pytest.mark.parametrize("mode", ["encoder_reuse", "guidance", "joint"])
def test_sampling_modes_on_card_match_cpu(small_pipes, monkeypatch, mode):
    """`_sample` at small() on the same latents, 3 steps: forward with
    encoder_reuse 2 (full, cached, full), forward under guidance 3 with a
    negative context (the model at batch 4), joint sampling (the whole
    model a step): every output within 0.05 * max|ref| of f32 on the CPU
    (the bf16 model rule of chip_smoke.py phase 4); K1/K2 launches as the
    config counts them."""
    from unirenderer_tpu_torch.pipelines import (
        FORWARD_RENDER, JOINT_SAMPLE, KernelCalls,
    )
    on_card, on_cpu = small_pipes
    cfg = on_card.cfg
    if mode == "encoder_reuse":
        cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
            cfg.sampler, encoder_reuse=2))
        for p in small_pipes:
            monkeypatch.setattr(p, "cfg", cfg)
    rng = np.random.default_rng(7)
    lat = cfg.unet.sample_size
    img, mask = (rng.standard_normal((2, lat, lat, 4)).astype(np.float32)
                 for _ in range(2))
    attr = rng.standard_normal((6, 2, lat, lat, 4)).astype(np.float32)
    guidance, neg = (3.0, rng.standard_normal(
        (2, cfg.text.max_length, cfg.unet.cross_attention_dim)).astype(
            np.float32)) if mode == "guidance" else (0.0, None)
    sample_mode = JOINT_SAMPLE if mode == "joint" else FORWARD_RENDER

    def run(pipe):
        dev = pipe.device
        t = [torch.from_numpy(x).to(dev) for x in (img, attr, mask)]
        ctx = pipe.blank_context(2)
        n = None if neg is None else torch.from_numpy(neg).to(dev, ctx.dtype)
        return pipe._sample(sample_mode, *t, ctx, 3, guidance, n)

    want = run(on_cpu)
    before = (fused_groupnorm_silu.launches, flash_attention.launches)
    got = run(on_card)
    torch.cuda.synchronize()
    calls = KernelCalls(cfg, cfg.vae.sample_size).sample(
        sample_mode, 2, 3, guidance=guidance > 1,
        encoder_reuse=cfg.sampler.encoder_reuse).launches
    assert (fused_groupnorm_silu.launches - before[0],
            flash_attention.launches - before[1]) == (
        calls["groupnorm_silu"], calls["flash_attention"])
    for what, g, w in zip(("image latent", "attribute groups"), got, want):
        err = (g.cpu() - w).abs().max().item()
        tol = 0.05 * w.abs().max().item()
        assert torch.isfinite(g).all() and err <= tol, (what, err, tol)


def test_small_bank_step_on_card_matches_cpu(card):
    """small() scene-bank steps with the trained r05 weights: scenes drawn
    from `synthetic_bank` on each device from the same draws (seed 21),
    collated (K4 on the card), one step's gradients on the card (bf16)
    against f32 on the CPU, both branches (`train.compare.compare_bank`).
    The collates agree to 1e-3 on >= 99 % of values (the collate test's
    rule); the step's loss within 1 % and the gradient cosine >= 0.995.
    The card read 0.832 % / 0.99759 (inverse) and 0.272 % / 0.99942
    (forward) here, the plain bf16 step on the CPU 0.162 % / 0.99912 and
    0.252 % / 0.99983.  The cosine is held below phase 9's 0.999 because
    the card's bf16 step reads the same with K1, K2 and K2 bwd replaced
    by their plain versions, with cuDNN, TF32 or cuBLAS's reduced bf16
    sums off (0.99668-0.99759): the gap is not the kernels' (PERF.md,
    the rest-of-training findings)."""
    from unirenderer_tpu_torch.data.scene_bank import synthetic_bank
    from unirenderer_tpu_torch.train.compare import compare_bank
    out = compare_bank([f"{card.type}:bfloat16", "cpu:float32"],
                       synthetic_bank(config.small().data), seeds=(21,))
    for step, r in out.items():
        assert r["collate_within_1e-3"] >= 0.99, (step, r)
        assert r["loss_rel_err"] <= 0.01, (step, r)
        assert r["grad_cos"] >= 0.995, (step, r)


def test_adafactor_on_card_matches_cpu(card):
    """Three Adafactor updates (global-norm clip, warmup-cosine learning
    rate) of the same parameters from the same gradients on the card and
    on the CPU, f32: within 1e-4 relative (reduction order only)."""
    import copy
    from torch import nn
    from unirenderer_tpu_torch.core.convert import flax_permutations
    from unirenderer_tpu_torch.train.train_step import (
        TrainState, make_optimizer, make_update_fn,
    )
    cfg = config.tiny()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer="adafactor", learning_rate=1e-2,
        lr_schedule="cosine", lr_warmup_steps=1, lr_decay_steps=5))
    torch.manual_seed(0)
    mods = [nn.Sequential(nn.Conv2d(128, 256, 3), nn.Linear(160, 192),
                          nn.GroupNorm(4, 16))]
    mods.append(copy.deepcopy(mods[0]).to(card))
    states = []
    for m in mods:
        params = dict(m.named_parameters())
        states.append(TrainState(params, make_optimizer(
            cfg, params, flax_permutations(m))))
    update = make_update_fn(cfg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=gen)
                 for p in states[0].params.values()]
        for st in states:
            dev = next(iter(st.params.values())).device
            update(st, [g.to(dev) for g in grads])
    for (n, p), q in zip(states[0].params.items(),
                         states[1].params.values()):
        err = (q.cpu() - p).abs().max().item()
        assert err <= 1e-4 * p.abs().max().item(), (n, err)


def test_prefetched_collate_on_a_side_stream_matches(card, tmp_path):
    """`rendered_batches(prefetch=2)` on the card (the collate in a thread
    on a side CUDA stream, the consumer waiting on its event) gives the
    same batches as the collate in the loop, and a tiny() Trainer's steps
    on the card consume them as they come: the same losses within 1e-3
    relative (the first bit-equal; later ones follow K2 bwd's dQ
    atomics)."""
    from unirenderer_tpu_torch.data.objaverse import ObjaverseData
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    from unirenderer_tpu_torch.eval.quality import held_out_paths
    from unirenderer_tpu_torch.train.trainer import Trainer, rendered_batches
    write_dataset(str(tmp_path), n_mesh=3, n_env=1, env_res=32,
                  env_min_res=8, env_samples=16, sphere_res=16, tex_res=32,
                  device=card, log=lambda msg: None)
    meshes, envs = held_out_paths(str(tmp_path))
    cfg = config.tiny()

    def batches(prefetch):
        tr = Trainer(cfg, str(tmp_path / f"t{prefetch}"), device=card)
        gen = rendered_batches(ObjaverseData(config.small().data, meshes,
                                             envs, seed=1), 2,
                               cfg.data.resolution, 2, device=card, seed=4,
                               prefetch=prefetch)
        out, losses = [], []
        for i in range(4):
            b = next(gen)
            losses.append(tr.step(b, is_inverse=bool(i % 2))["loss"])
            out.append({k: (v * 1.0).cpu() for k, v in b.items()})
        gen.close()
        return out, [float(x) for x in losses]

    (a_maps, a_loss), (b_maps, b_loss) = batches(0), batches(2)
    for a, b in zip(a_maps, b_maps):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert a_loss[0] == b_loss[0], (a_loss, b_loss)
    for x, y in zip(a_loss, b_loss):
        assert math.isfinite(x) and abs(x - y) <= 1e-3 * abs(x), (a_loss,
                                                                  b_loss)


def test_small_app_decompose_on_card_is_finite_and_repeatable(card):
    """A small() `AppBackend` (the trained r05 weights, bf16) decomposes a
    64^2 photo on the card with a box prompt: 6 uint8 maps at 64^2, the
    same bits on a repeat (each request draws from a generator seeded 0),
    K1/K2 launches as the config counts them."""
    from unirenderer_tpu_torch.eval.app import MAP_NAMES, AppBackend
    from unirenderer_tpu_torch.eval.quality import small_trained_pipeline
    from unirenderer_tpu_torch.pipelines import KernelCalls
    pipe = small_trained_pipeline("cuda", torch.bfloat16)
    backend = AppBackend(pipe, steps=3, ensemble=2)
    rng = np.random.default_rng(8)
    photo = np.full((80, 72, 3), 255, np.uint8)
    photo[12:68, 10:62] = rng.integers(0, 200, (56, 52, 3))
    before = (fused_groupnorm_silu.launches, flash_attention.launches)
    maps = backend.decompose(photo, None, "8,10,64,70")
    calls = KernelCalls(pipe.cfg, 64).real_image2mask_3mod_albedo(
        1, 3, 2).launches
    assert (fused_groupnorm_silu.launches - before[0],
            flash_attention.launches - before[1]) == (
        calls["groupnorm_silu"], calls["flash_attention"])
    again = backend.decompose(photo, None, "8,10,64,70")
    assert sorted(maps) == sorted(MAP_NAMES)
    for k, v in maps.items():
        assert v.shape == (64, 64, 3) and v.dtype == np.uint8, k
        assert np.array_equal(v, again[k]), k


def test_native_obj_scanner_on_card_machine(tmp_path):
    """The g++ build of native/objio.cpp on this machine gives the numpy
    parser's arrays bit for bit, for a sphere written with 9 significant
    digits (needs no card: the scanner runs on the host)."""
    from unirenderer_tpu_torch.data.obj_io import load_obj
    from unirenderer_tpu_torch.render.mesh import make_sphere
    s = make_sphere(24)
    path = tmp_path / "s.obj"
    with open(path, "w") as f:
        for key, tag in (("v_pos", "v"), ("v_tex", "vt"), ("v_nrm", "vn")):
            for row in getattr(s, key).tolist():
                f.write(f"{tag} " + " ".join(f"{x:.9g}" for x in row) + "\n")
        for row in (s.t_pos_idx + 1).tolist():
            f.write("f " + " ".join(f"{i}/{i}/{i}" for i in row) + "\n")
    native = load_obj(str(path), use_native=True)
    plain = load_obj(str(path), use_native=False)
    for k in ("v_pos", "t_idx", "v_nrm", "v_tex", "v_tng", "kd"):
        assert native[k].dtype == plain[k].dtype
        assert np.array_equal(native[k], plain[k]), k


def test_lpips_and_inception_on_card_match_cpu(card):
    """The seeded random LPIPS and InceptionV3 in f32 (TF32 off) on the
    card against the same modules on the CPU: distances and pool3
    features within 1e-3 relative (of max|CPU|)."""
    from unirenderer_tpu_torch.eval import inception, lpips
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(9)
    a, b = rng.uniform(-1, 1, (2, 3, 64, 64, 3)).astype(np.float32)
    want = lpips.make_lpips_fn(device="cpu")[0](a, b)
    got = lpips.make_lpips_fn(device=card)[0](a, b)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    x = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    want = inception.make_feature_fn(device="cpu")(x)
    got = inception.make_feature_fn(device=card)(x)
    assert got.shape == (3, 2048)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


# ---------------------------------------------------------------------------
# f32: the f32 forms of K1, K2 (with its log-sum-exp), K2s, K3 and K2 bwd
# ---------------------------------------------------------------------------

F32_GN = 2.0 ** -16
F32_ATTN = 2.0 ** -14
F32_LSE = 2.0 ** -16
F32_BWD = 2.0 ** -12


def _within(got, want, rel, what):
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * want.float().abs().max().item()
    assert err <= tol, f"{what}: max|diff| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 64, 64, 320), 32, 1e-5, True),     # the flagship headline
    ((2, 8, 8, 2560), 32, 1e-5, True),      # an up-block concat: 640 vectors
    ((2, 16, 16, 128), 16, 1e-6, True),     # small()'s UNet
    ((2, 64, 64, 32), 8, 1e-6, True),       # small()'s VAE
    ((1, 37, 29, 36), 4, 1e-6, False),      # C % 8 != 0, ragged HW
])
def test_groupnorm_kernel_f32(card, shape, groups, eps, silu, param_dtype):
    g = torch.Generator(device=card).manual_seed(11)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=card) * 2 + 0.5
    sc = (1 + 0.1 * torch.randn(c, generator=g, device=card)).to(param_dtype)
    bi = (0.1 * torch.randn(c, generator=g, device=card)).to(param_dtype)
    n = fused_groupnorm_silu.launches_f32
    got = fused_groupnorm_silu(x, sc, bi, groups, eps, silu)
    again = fused_groupnorm_silu(x, sc, bi, groups, eps, silu)
    torch.cuda.synchronize()
    assert fused_groupnorm_silu.launches_f32 == n + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    _within(got, groupnorm_silu_reference(x, sc, bi, groups, eps, silu),
            F32_GN, "groupnorm f32")


# the cluster kernel (csrc/groupnorm_f32.cu): (shape, groups, eps, silu,
# the cluster sizes its plan may give on an H100 SXM, 0 for the
# cooperative kernel: the largest that keeps 4096 / C rows a CTA and whose
# clusters the card holds all at once, where that depends on placement,
# else the least that holds the slice)
GN_CLUSTER_CASES = [
    ((2, 16, 16, 128), 16, 1e-5, True, (8,)),   # small()'s UNet: 32 rows
    ((16, 64, 64, 64), 8, 1e-5, True, (8, 16)),  # small()'s largest
    ((2, 64, 64, 32), 8, 1e-6, True, (8, 16)),  # small()'s VAE
    ((4, 4, 4, 1024), 32, 1e-5, True, (4,)),    # wide C, 4 rows a CTA
    ((2, 3, 3, 1024), 32, 1e-5, False, (2,)),   # 9 rows: 5 + 4
    ((80, 8, 8, 64), 8, 1e-5, True, (1,)),      # 64 rows: no split
    ((1, 37, 29, 36), 4, 1e-6, False, (8,)),    # ragged: 7 x 135 + 128
    ((1, 4, 4, 24), 3, 1e-5, True, (1,)),       # C / G = 8, one warp
    ((1, 64, 64, 128), 32, 1e-5, True, (0, 16)),  # 2 MB: 16 if placeable
]


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,eps,silu,ctas", GN_CLUSTER_CASES)
def test_groupnorm_cluster_kernel_f32(card, shape, groups, eps, silu, ctas,
                                      param_dtype):
    """f32 shapes the cluster plan takes go to csrc/groupnorm_f32.cu:
    within 2^-16 of the plain version, a rerun bit-equal, two launches of
    the cluster kernel; a shape it leaves goes to the cooperative kernel
    (its plan says which)."""
    from unirenderer_tpu_torch.ops.groupnorm import plan
    got_plan = plan(shape, groups, torch.float32, param_dtype)
    taken = got_plan["branch"] == "cluster"
    assert (got_plan["ctas"] if taken else 0) in ctas, got_plan
    assert got_plan["cached"]
    g = torch.Generator(device=card).manual_seed(13)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=card) * 2 + 0.5
    sc = (1 + 0.1 * torch.randn(c, generator=g, device=card)).to(param_dtype)
    bi = (0.1 * torch.randn(c, generator=g, device=card)).to(param_dtype)
    n = fused_groupnorm_silu.launches_cluster
    got = fused_groupnorm_silu(x, sc, bi, groups, eps, silu)
    again = fused_groupnorm_silu(x, sc, bi, groups, eps, silu)
    torch.cuda.synchronize()
    assert fused_groupnorm_silu.launches_cluster == n + (2 if taken else 0)
    assert got.dtype == torch.float32 and torch.equal(got, again)
    _within(got, groupnorm_silu_reference(x, sc, bi, groups, eps, silu),
            F32_GN, "groupnorm f32 (cluster)")


def test_groupnorm_cluster_kernel_is_one_device_kernel_a_call(card):
    x = torch.randn((2, 16, 16, 128), device=card)
    w = torch.ones(128, device=card)
    kernels = _device_kernels(
        lambda: fused_groupnorm_silu(x, w, w, 16, 1e-5, True))
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "gn_cluster_kernel" in kernels[0][0]


def _qkv32(card, b, sq, sk, h, d, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randn((b, n, h, d), generator=g, device=card)
                 for n in (sq, sk, sk))


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 256, 16, 4, 32), (2, 64, 64, 4, 64),
    (2, 16, 16, 4, 128), (2, 64, 77, 8, 160), (1, 1000, 333, 3, 24),
])
def test_flash_attention_kernel_f32(card, b, sq, sk, h, d):
    q, k, v = _qkv32(card, b, sq, sk, h, d, seed=12)
    n = flash_attention.launches_f32
    got = flash_attention(q, k, v)
    o, lse = flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_f32 == n + 2
    assert got.dtype == torch.float32 and torch.equal(got, o)
    _within(got, attention_reference(q, k, v), F32_ATTN, "flash f32")
    lse_err = (lse - attention_lse_reference(q, k, v)[1]).abs().max().item()
    assert lse_err <= F32_LSE, f"lse: {lse_err:.3g}"


def test_flash_attention_kernel_f32_reads_strided_heads(card):
    g = torch.Generator(device=card).manual_seed(13)
    qkv = torch.randn((2, 300, 3, 4, 40), generator=g, device=card)
    q, k, v = qkv.unbind(2)
    _within(flash_attention(q, k, v), attention_reference(q, k, v),
            F32_ATTN, "strided f32")


@pytest.mark.parametrize("b,s,h,d", [(2, 4096, 8, 40), (2, 256, 4, 32)])
def test_splash_attention_kernel_f32(card, b, s, h, d):
    q, k, v = _qkv32(card, b, s, s, h, d, seed=14)
    n = splash_attention.launches_f32
    got = splash_attention(q, k, v)
    torch.cuda.synchronize()
    assert splash_attention.launches_f32 == n + 1
    _within(got, splash_attention_reference(q, k, v), F32_ATTN, "splash f32")


@pytest.mark.parametrize("running_max", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 1024, 1024, 8, 80),
                                         (2, 256, 256, 4, 32)])
def test_unet_flash_kernel_f32(card, b, sq, sk, h, d, running_max):
    q, k, v = _qkv32(card, b, sq, sk, h, d, seed=15)
    n = unet_flash_attention.launches_f32
    got = unet_flash_attention(q, k, v, running_max=running_max)
    torch.cuda.synchronize()
    assert unet_flash_attention.launches_f32 == n + 1
    _within(got, unet_flash_reference(q, k, v, running_max), F32_ATTN,
            "unet_flash f32")


def _check_backward_f32(q, k, v, do, what):
    o, lse = flash_attention_with_lse(q, k, v)
    n = flash_attention_backward.launches_f32
    got = flash_attention_backward(q, k, v, o, lse, do)
    again = flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches_f32 == n + 2
    want = attention_backward_reference(q, k, v, o, lse, do)
    for name, a, c, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        _within(a, w, F32_BWD, f"{what} {name}")
        # no atomics: a rerun gives the same bits
        assert torch.equal(c, a), f"{what} {name}: a rerun differs"


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 256, 256, 4, 32), (2, 256, 16, 4, 32),
    (2, 64, 64, 4, 64), (2, 64, 77, 8, 160), (1, 1000, 333, 3, 24),
])
def test_flash_attention_backward_kernel_f32(card, b, sq, sk, h, d):
    q, k, v = _qkv32(card, b, sq, sk, h, d, seed=16)
    g = torch.Generator(device=card).manual_seed(17)
    do = torch.randn((b, sq, h, d), generator=g, device=card)
    _check_backward_f32(q, k, v, do, f"({b},{sq},{sk},{h},{d}) f32")


def test_flash_attention_backward_f32_reads_strided_operands(card):
    g = torch.Generator(device=card).manual_seed(18)
    q, k, v = torch.randn((2, 300, 3, 4, 40), generator=g,
                          device=card).unbind(2)
    do = torch.randn((2, 300, 2, 4, 40), generator=g, device=card)[:, :, 0]
    _check_backward_f32(q, k, v, do, "strided f32")


# the head widths the models use, through every padded width the tensor-core
# tiles take (24, 32, 40: exact; 80: 32-row streamed tiles; 160: launch 2's
# columns in two halves), at a self shape and a ragged cross shape
F32_HEAD_DIMS = (24, 32, 40, 80, 160)
F32_SQ_SK = ((256, 256), (300, 77))


@pytest.mark.parametrize("d", F32_HEAD_DIMS)
@pytest.mark.parametrize("sq,sk", F32_SQ_SK)
def test_flash_attention_kernel_f32_head_dims(card, sq, sk, d):
    q, k, v = _qkv32(card, 2, sq, sk, 3, d, seed=20 + d)
    o, lse = flash_attention_with_lse(q, k, v)
    o2, lse2 = flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "a rerun differs"
    _within(o, attention_reference(q, k, v), F32_ATTN, f"flash f32 D={d}")
    lse_err = (lse - attention_lse_reference(q, k, v)[1]).abs().max().item()
    assert lse_err <= F32_LSE, f"lse: {lse_err:.3g}"


@pytest.mark.parametrize("d", F32_HEAD_DIMS)
@pytest.mark.parametrize("sq,sk", F32_SQ_SK)
def test_flash_attention_backward_kernel_f32_head_dims(card, sq, sk, d):
    q, k, v = _qkv32(card, 2, sq, sk, 3, d, seed=30 + d)
    g = torch.Generator(device=card).manual_seed(31 + d)
    do = torch.randn((2, sq, 3, d), generator=g, device=card)
    _check_backward_f32(q, k, v, do, f"(2,{sq},{sk},3,{d}) f32")


@pytest.mark.parametrize("running_max", [True, False])
@pytest.mark.parametrize("d", (24, 32, 40, 80))     # K3 takes D <= 128
@pytest.mark.parametrize("sq,sk", ((256, 256), (300, 200)))
def test_unet_flash_kernel_f32_head_dims(card, sq, sk, d, running_max):
    q, k, v = _qkv32(card, 2, sq, sk, 3, d, seed=40 + d)
    got = unet_flash_attention(q, k, v, running_max=running_max)
    again = unet_flash_attention(q, k, v, running_max=running_max)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "a rerun differs"
    _within(got, unet_flash_reference(q, k, v, running_max), F32_ATTN,
            f"unet_flash f32 D={d} running_max={running_max}")


@pytest.mark.parametrize("d", (24, 32, 40, 80))     # K2s: tileable shapes
def test_splash_attention_kernel_f32_head_dims(card, d):
    q, k, v = _qkv32(card, 2, 256, 256, 3, d, seed=50 + d)
    got = splash_attention(q, k, v)
    again = splash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "a rerun differs"
    _within(got, splash_attention_reference(q, k, v), F32_ATTN,
            f"splash f32 D={d}")


def test_flash_attention_autograd_f32_on_card(card):
    q, k, v = (t.requires_grad_() for t in _qkv32(card, 2, 256, 16, 4, 32,
                                                  19))
    n_f = flash_attention.launches_f32
    n_b = flash_attention_backward.launches_f32
    flash_attention(q, k, v).square().sum().backward()
    torch.cuda.synchronize()
    assert flash_attention.launches_f32 == n_f + 1
    assert flash_attention_backward.launches_f32 == n_b + 1
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def test_f32_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((1, 16, 1, 40), device=card)
    with pytest.raises(TypeError):                  # f16 operands
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):                  # mixed types
        flash_attention(q, q.bfloat16(), q)
    wide = torch.zeros((1, 16, 43), device=card)[..., :40].reshape(
        1, 16, 1, 40)
    with pytest.raises(ValueError):                 # a stride of 43
        flash_attention(wide, q, q)


def test_tiny_pipeline_f32_on_card_matches_cpu(card):
    """tiny() in f32: one forward request through the public entry point's
    noise, card (the f32 kernels) against the CPU (plain versions)."""
    cfg = config.tiny()
    pipes = [UniRendererPipeline.create(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.float32) for dev in (card, "cpu")]
    from unirenderer_tpu_torch.core.convert import flax_from_module
    pipes[1].load_flax(**{n: flax_from_module(getattr(pipes[0], n))
                          for n in ("dual", "vae", "text")})
    res = cfg.vae.sample_size
    rng = np.random.default_rng(0)
    maps = {k: torch.from_numpy(rng.uniform(-1, 1, (2, res, res, 3))
                                .astype(np.float32))
            for k in ("normal", "albedo", "spec_light", "diff_light", "env",
                      "mask")}
    lat = res // cfg.vae.downscale
    noise = dict(enc_noise=torch.from_numpy(rng.standard_normal(
        (12, lat, lat, 4)).astype(np.float32)),
                 img_noise=torch.from_numpy(rng.standard_normal(
                     (2, lat, lat, 4)).astype(np.float32)))
    n_gn = fused_groupnorm_silu.launches_f32
    n_fa = flash_attention.launches_f32
    outs = [p.mask2image_3mod_albedo_with_noise(
        **maps, metallic=torch.tensor([0.1, 0.9]),
        roughness=torch.tensor([0.5, 0.2]), **noise).cpu() for p in pipes]
    assert fused_groupnorm_silu.launches_f32 > n_gn
    assert flash_attention.launches_f32 > n_fa
    _within(outs[0], outs[1], 1e-3, "tiny() f32 render")


@pytest.mark.parametrize("inverse", [True, False])
def test_tiny_train_step_f32_on_card_matches_cpu(card, tmp_path, inverse):
    from unirenderer_tpu_torch.core.convert import flax_from_module
    from unirenderer_tpu_torch.train.compare import (
        agreement, smooth_batch, trainer_with, step_grads,
    )
    from unirenderer_tpu_torch.train.train_step import draw
    cfg = config.tiny()
    on_card = trainer_with(cfg, None, card, torch.float32,
                           str(tmp_path / "card"))
    weights = {n: flax_from_module(getattr(on_card, n))
               for n in ("dual", "vae", "text")}
    on_cpu = trainer_with(cfg, weights, "cpu", torch.float32,
                          str(tmp_path / "cpu"))
    batch = smooth_batch(cfg, 2, seed=0)
    lat = cfg.vae.sample_size // cfg.vae.downscale
    draws = draw(torch.Generator().manual_seed(1), 2, (lat, lat), 1000,
                 inverse)
    n_b = flash_attention_backward.launches_f32
    r = agreement(step_grads(on_card, batch, draws),
                  step_grads(on_cpu, batch, draws))
    assert flash_attention_backward.launches_f32 > n_b
    assert r["loss_rel_err"] <= 1e-4, r
    assert r["grad_cos"] >= 0.99999, r
    assert abs(r["norm_ratio"] - 1) <= 1e-4, r
