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
cores, and Q is pre-scaled in bf16 as the forward does), the forward's
log-sum-exp within 2^-14 of the plain one of its own bf16-staged Q, and
two backward runs on the same inputs within 2^-8 * max|plain| of each
other (dQ's f32 sums are atomic adds in no fixed order).  A train step on
the card (bf16) against the same step in f32 on the CPU: loss within 2 %,
gradient cosine >= 0.99, norm ratio within 2 % (tiny() random weights; the
bf16 gap alone measures well inside that).  The plain versions run in f32 on
the same bf16 inputs, with TF32 off.  The rasterizer (f32) is held to the
rule of tests/test_rasterize_pallas.py (`ops.rasterize.within_rule`:
coverage equal, z and u, v within 1e-5, < 2 % of triangle ids different,
only where both sides hit); the collate on the card to 1e-3 against the
same collate on the CPU on >= 99 % of values (clip positions from cuBLAS
and from the CPU can differ by an ulp, which can move a silhouette
subsample).
"""

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
    flash_attention_backward, flash_attention_with_lse, staged_lse_reference,
)
from unirenderer_tpu_torch.ops.groupnorm import (
    fused_groupnorm_silu, groupnorm_silu_reference,
)
from unirenderer_tpu_torch.ops.rasterize import (
    match_stats, rasterize, rasterize_reference, within_rule,
)
from unirenderer_tpu_torch.ops.splash_attention import (
    splash_attention, splash_attention_reference,
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
                                         (1, 200, 77, 3, 24)])
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
    assert within_rule(stats), stats
    assert (got.tri_id > 0).float().mean() > 0.05


def test_rasterize_kernel_peels(card):
    pos, tri = _deformed_spheres(card, 2, 32, 8192, seed=3)
    first = rasterize_reference(pos, tri, 128, 128)
    got = rasterize(pos, tri, 128, 128, prev_z=first.z.contiguous())
    want = rasterize_reference(pos, tri, 128, 128, prev_z=first.z)
    stats = match_stats(got, want)
    assert within_rule(stats), stats
    assert (got.tri_id > 0).any()          # the back of the shape


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
    lse_ref = staged_lse_reference(q, k)
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
