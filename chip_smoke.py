#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`unirenderer_tpu_torch`) on one card.

    python3 chip_smoke.py [--out DIR] [--phases 0,1,...,10] [--profile]

Phases, each printing its elapsed seconds as it goes (in the order 0-6,
8, 7, 9, 10: phase 8 reuses phase 3's flagship weights, freed before
phase 7):
  0  device: name, count, torch/CUDA versions, nvidia-smi name and power limit
  1  build: one nvcc per kernel source, all started together; build seconds
     and the -Xptxas -v report (registers, shared memory, spills, and any
     note that ptxas serialized the wgmma instructions)
  2  kernels against their plain PyTorch versions in bf16, at every call
     signature the flagship forward path (batch 2) and the flagship inverse
     path (batch 2 x ensemble 5) give them, plus a ragged case each; the
     splash (K2s) and unet_flash (K3) routes at every tileable
     self-attention shape of both paths, K3 also without the running max
     (bounded logits) and unpipelined; time of kernel, plain version and
     one PyTorch library call (F.group_norm + F.silu,
     F.scaled_dot_product_attention: timed here as yardsticks, never called
     by the port), and each case's bound; the attention backward (K2 bwd)
     at every attention shape of the flagship training step (batch 2) plus
     a ragged case each: dQ, dK, dV each within 2^-6 * max|plain| of the
     plain backward in f32 on the same bf16 inputs and the kernel's own O
     and log-sum-exp, that log-sum-exp within 2^-14 of the plain one of
     its own bf16-staged Q, the forward's output with the log-sum-exp
     bit-identical to the serving launch's, and a second backward run on
     the same inputs (dQ's f32 sums are atomic adds in no fixed order)
     within the tolerance of the first; library = autograd of
     F.scaled_dot_product_attention; every case prints its ratio to the
     library call
  3  the main path at flagship width: random bf16 weights made on the card
     from a seed, 2 requests (one batch of 2) through
     `UniRendererPipeline.mask2image_3mod_albedo`, 20 UniPC steps; checks
     shape, finiteness, that both kernels ran and that every call they got
     was checked in phase 2
  4  the repo's trained small() weights through the flax converter onto the
     card, every key loaded (the attribute decoder's too): one forward and
     one inverse model evaluation against the same weights in f32 on the
     CPU (plain versions); one forward render at batch 2 through the public
     entry point; one forward render and one inverse render (20 steps) on
     card and CPU from the same noise, compared
  5  the rasterizer (K4) against its plain version on the card: the
     flagship collate's shape (2 views at 1024^2, deformed 90-ring spheres,
     T padded to 32768), the small() shape (128^2, T 8192), a depth-peel
     layer and a ragged size; the comparison rule of the JAX package's
     Pallas test; kernel, plain and bound times
  6  the flagship render chain: one env prefiltered on the card (512 base,
     6 specular mips), `collate_render` of 2 scenes at DataConfig()
     (512^2, SSAA 2, T 32768, 256^2 textures), its 8 maps through
     `mask2image_3mod_albedo` (flagship width, random bf16 weights, 20
     steps, material_image_encode); collate cold/warm times, K4's share,
     launches of all three kernels on this path
  7  the held-out harness: the seed-99 held-out set (32 meshes, 8 envs)
     generated on the card, the trained small() weights and the JAX
     harness's text encoder in bf16, 32 objects, 20 steps; the forward
     PSNR (`eval.quality.forward_psnr`) fails more than 1 dB below
     QUALITY_r05_fixed.json's 25.17 dB; the inverse leg
     (`eval.quality.inverse_scores`) at ensemble 1 and 5 fails more than
     1 dB below QUALITY_r05_fixed(_ens5).json's normal and albedo PSNR,
     more than 3 degrees above its mean normal angle or more than 0.05
     above its metallic/roughness MAE
  8  the flagship inverse request: random bf16 flagship weights (phase 3's),
     2 photos x ensemble 5 through `real_image2mask_3mod_albedo`, 20
     steps; cold and warm wall, peak memory, launches; every output finite
     and of its shape, every kernel call checked in phase 2; then one warm
     forward request under UNIRENDER_ATTN=splash and one under
     =unet_flash: the route's launches equal the tileable self-attention
     calls worked out from the config, and the image is within 0.05 *
     max|ref| (phase 4's bf16 model rule) of the default route's
  9  training at small(): the trained r05 weights loaded strictly into a
     Trainer on the card (bf16) and one on the CPU (f32); one step's
     gradients from the same batch and draws, an inverse and a forward
     step: the loss within 1 % of f32, the flattened gradients' cosine
     >= 0.999 and their norm within 1 % (the bf16 gap alone, port in bf16
     on the CPU: < 0.06 %, 1 - cos < 2e-5, < 0.08 %); then 2 steps of
     `Trainer.train` on the card write a params npz that loads back
     strictly
 10  flagship training: random f32 master weights from the seed, batch 2
     of maps collated from phase 6's scenes (K4), 4 steps of the Trainer
     (bf16 compute, remat on, AdamW), forward / inverse / forward /
     inverse (the branch forced through the draws): cold and warm seconds
     per step of each kind, peak memory; loss and grad norm finite, the
     parameters changed, the launches of K1, K2 and K2 bwd per step equal
     to the count from the config (`train_step_launches`, with remat's
     recompute), every call they got checked in phase 2

Any failure exits non-zero.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}, after
a line {"kernels": [...]}.  --out DIR also writes every measured case to
DIR/chip_smoke.json; --profile adds a torch.profiler breakdown by kernel
class of one flagship forward request (phase 3), one flagship inverse
request (phase 8) and one warm flagship inverse train step (phase 10).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
SEED = 1234
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
CARD_REL = 2.0 ** -7             # bf16 output rounding, relative to max|ref|
SMALL_MODEL_REL = 0.05           # bf16 small() model vs f32, rel. to max|ref|
SMALL_RENDER_MEAN_ABS = 0.1      # bf16 vs f32 forward render, mean |diff|
INVERSE_ENSEMBLE = 5             # the flagship recipe (SamplerConfig)
FP32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
RAST_TILE = 16                   # csrc/rasterize.cu's tile side
RAST_TEST_FLOPS = 12             # 3 edge functions, 2 mul + 2 add each
DUAL_NPZ = "artifacts/r05/dual_small.npz"
VAE_NPZ = "artifacts/r04/vae_small.npz"
PSNR_REFERENCE = 25.167056013939117  # QUALITY_r05_fixed.json, n=32
PSNR_MARGIN = 1.0                # dB below a reference that fails
ANGLE_MARGIN = 3.0               # degrees above the reference that fail
MR_MAE_MARGIN = 0.05             # above the reference metallic/rough MAE
# the inverse leg of the JAX harness, n=32, 20 steps, by ensemble:
# QUALITY_r05_fixed.json (1) and QUALITY_r05_fixed_ens5.json (5)
INVERSE_REFERENCE = {
    1: dict(normal=18.029916766059294, albedo=15.004557956342436,
            angle=31.522995305241448, mr_mae=0.2856240663677454),
    5: dict(normal=19.031464968418838, albedo=16.181585165493882,
            angle=28.55341614233909, mr_mae=0.23219199385493994),
}
BWD_REL = 2.0 ** -6              # K2 bwd vs plain, rel. to max|ref|
# K2's log-sum-exp vs the plain one of its own bf16-staged Q, absolute:
# 9.5e-7-1.9e-6 read on the H100, 1.3e-3-6.7e-3 more against f32 Q
LSE_ABS = 2.0 ** -14
TRAIN_LOSS_REL = 0.01            # small() train step, card bf16 vs CPU f32:
TRAIN_GRAD_COS = 0.999           # loss, gradient cosine and norm ratio
TRAIN_NORM_REL = 0.01
ALL_PHASES = "0,1,2,3,4,5,6,7,8,9,10"
PAD_CYCLES = 1_000_000           # ~0.5 ms of spin before each timed launch


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


class Timer:
    """Mean device time of fn() over reps, each launch after an L2 flush
    (the main path finds its inputs cold), from CUDA events.  A spin kernel
    of PAD_CYCLES keeps the card busy while the host enqueues fn()'s
    launches, so the start event does not count the host's own time in the
    wrappers (Python, ctypes, PyTorch's dispatch) as device time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()                                  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        est_ms = (time.perf_counter() - t) * 1e3
        reps = int(min(20, max(3, 40 / max(est_ms, 1e-3))))
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(PAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def gn_case(torch, F, timer, gen, case):
    from unirenderer_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu, groupnorm_silu_reference,
    )
    shape, groups, eps, silu = case
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5
         ).bfloat16()
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    y = fused_groupnorm_silu(x, scale, bias, groups, eps, silu)
    ref = groupnorm_silu_reference(x.float(), scale, bias, groups, eps, silu)
    torch.cuda.synchronize()
    err = (y.float() - ref).abs().max().item()
    tol = CARD_REL * ref.abs().max().item()
    del ref, y
    xc = x.permute(0, 3, 1, 2)
    w16, b16 = scale.bfloat16(), bias.bfloat16()

    def library():
        out = F.group_norm(xc, groups, w16, b16, eps)
        return F.silu(out) if silu else out

    ms = timer(lambda: fused_groupnorm_silu(x, scale, bias, groups, eps, silu))
    plain_ms = timer(lambda: groupnorm_silu_reference(x, scale, bias, groups,
                                                      eps, silu))
    library_ms = timer(library)
    nbytes = x.numel() * 2
    bound_ms = (2 * nbytes + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
    return dict(kernel="groupnorm_silu", shape=list(shape), groups=groups,
                eps=eps, silu=silu, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes",
                three_pass_floor_ms=3 * nbytes / HBM_BYTES_PER_S * 1e3)


def _attention_kernels():
    """name -> (wrapper, plain version) of the three attention kernels."""
    from unirenderer_tpu_torch.ops.attn_kernel import (
        unet_flash_attention, unet_flash_reference,
    )
    from unirenderer_tpu_torch.ops.flash_attention import (
        attention_reference, flash_attention,
    )
    from unirenderer_tpu_torch.ops.splash_attention import (
        splash_attention, splash_attention_reference,
    )
    return {"flash_attention": (flash_attention, attention_reference),
            "splash_attention": (splash_attention,
                                 splash_attention_reference),
            "attn_kernel": (unet_flash_attention, unet_flash_reference)}


def attn_case(torch, F, timer, gen, case, kernel="flash_attention",
              **options):
    """One attention kernel (K2, K2s or K3 with `options`) at (q shape, k
    shape): error against its plain version on the same bf16 inputs (its
    pre-scale of Q rounded as the kernel's caller rounds it) with an f32
    output, and the times."""
    fn, reference = _attention_kernels()[kernel]
    ref_options = {k: v for k, v in options.items() if k == "running_max"}
    qs, ks = case
    q = torch.randn(qs, generator=gen, device="cuda").bfloat16()
    k = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    v = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    o = fn(q, k, v, **options)
    ref = reference(q, k, v, out_dtype=torch.float32, **ref_options)
    torch.cuda.synchronize()
    err = (o.float() - ref).abs().max().item()
    tol = CARD_REL * ref.abs().max().item()
    del ref, o
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = timer(lambda: fn(q, k, v, **options))
    plain_ms = timer(lambda: reference(q, k, v, **ref_options))
    library_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    b, sq, h, d = qs
    sk = ks[1]
    flop_ms = 4.0 * b * h * sq * sk * d / BF16_FLOPS * 1e3
    byte_ms = 2.0 * (2 * q.numel() + 2 * k.numel()) / HBM_BYTES_PER_S * 1e3
    return dict(kernel=kernel, shape=[list(qs), list(ks)], options=options,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes")


def attn_bwd_case(torch, F, timer, gen, case):
    """K2 bwd at (q shape, k shape): dQ, dK, dV against the plain backward
    on the same bf16 inputs, O and log-sum-exp from the K2 forward (whose
    log-sum-exp is held against the plain one, and whose output must be
    the serving launch's, bit for bit); the times."""
    from unirenderer_tpu_torch.ops.flash_attention import (
        attention_backward_reference, attention_lse_reference,
        flash_attention, flash_attention_backward, flash_attention_with_lse,
        staged_lse_reference,
    )
    qs, ks = case
    q = torch.randn(qs, generator=gen, device="cuda").bfloat16()
    k = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    v = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    do = torch.randn(qs, generator=gen, device="cuda").bfloat16()
    o, lse = flash_attention_with_lse(q, k, v)
    same_o = bool(torch.equal(o, flash_attention(q, k, v)))
    lse_err = (lse - staged_lse_reference(q, k)).abs().max().item()
    # the part of the plain f32 version's distance that is Q's bf16 staging
    lse_rounding = (lse - attention_lse_reference(q, k, v)[1]
                    ).abs().max().item()
    got = flash_attention_backward(q, k, v, o, lse, do)
    # dQ's f32 sums are atomic adds in no fixed order (and dK, dV's where
    # the kernel splits the query tiles): a second run on the same inputs
    # may differ in the last bits, and must stay well inside the tolerance
    again = flash_attention_backward(q, k, v, o, lse, do)
    want = attention_backward_reference(q, k, v, o, lse, do, torch.float32)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = ((g.float() - w).abs().max().item(),
                      BWD_REL * w.abs().max().item())
    rerun = max((g.float() - a.float()).abs().max().item()
                for g, a in zip(got, again))
    del got, again, want
    ok = (same_o and lse_err <= LSE_ABS
          and all(e <= t for e, t in errs.values())
          and rerun <= min(t for _, t in errs.values()))
    ms = timer(lambda: flash_attention_backward(q, k, v, o, lse, do))
    plain_ms = timer(lambda: attention_backward_reference(q, k, v, o, lse,
                                                          do))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    library_ms = timer(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                   retain_graph=True))
    del out
    b, sq, h, d = qs
    sk = ks[1]
    # five products of 2 Sq Sk D per (batch, head): S, dP, dV, dQ, dK
    flop_ms = 10.0 * b * h * sq * sk * d / BF16_FLOPS * 1e3
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(kernel="flash_attention_backward",
                shape=[list(qs), list(ks)], errs=errs, lse_err=lse_err,
                lse_tol=LSE_ABS, lse_rounding=lse_rounding, rerun_diff=rerun,
                forward_bit_identical=same_o, ok=ok,
                max_abs_err=max(e for e, _ in errs.values()),
                tol=min(t for _, t in errs.values()), ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes")


def case_ok(r) -> bool:
    return r["ok"] if "ok" in r else r["max_abs_err"] <= r["tol"]


def phase_kernels(torch, F, timer, gn_cases, attn_cases, route_cases,
                  bwd_cases):
    """`route_cases`: (kernel name, case, options) of the two routes;
    `bwd_cases`: (q shape, k shape) of K2 bwd."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    jobs = ([lambda c=c: gn_case(torch, F, timer, gen, c) for c in gn_cases]
            + [lambda c=c: attn_case(torch, F, timer, gen, c)
               for c in attn_cases]
            + [lambda n=n, c=c, o=o: attn_case(torch, F, timer, gen, c, n,
                                               **o)
               for n, c, o in route_cases]
            + [lambda c=c: attn_bwd_case(torch, F, timer, gen, c)
               for c in bwd_cases])
    results = []
    for job in jobs:
        r = job()
        results.append(r)
        ok = case_ok(r)
        log(f"  {r['kernel']:16s} {json.dumps(r['shape'])} "
            + (f"g={r['groups']} eps={r['eps']:g} silu={int(r['silu'])} "
               if "groups" in r else "")
            + (f"{r['options']} " if r.get("options") else "")
            + (" ".join(f"{n} {e:.3g}/{t:.3g}"
                        for n, (e, t) in r["errs"].items())
               + f" lse {r['lse_err']:.3g}/{r['lse_tol']:.3g} (bf16 Q "
               f"{r['lse_rounding']:.3g}) bit-identical "
               f"fwd {int(r['forward_bit_identical'])} rerun diff "
               f"{r['rerun_diff']:.3g}/{r['tol']:.3g} "
               if "errs" in r else "")
            + f"err={r['max_abs_err']:.3g} tol={r['tol']:.3g} "
            f"{'ok' if ok else 'FAIL'}  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f}  library {r['library_ms']:.4f}  "
            + (f"ratio {r['ms'] / r['library_ms']:.2f}  "
               if r.get("library_ms") else "")
            + f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
        torch.cuda.empty_cache()
    bad = [r for r in results if not case_ok(r)]
    check(not bad, f"{len(bad)} kernel case(s) out of tolerance")
    return results


# ---------------------------------------------------------------------------
# Phase 3: the main path at flagship width
# ---------------------------------------------------------------------------


def synthetic_request(torch, F, gen, batch, res):
    """Seeded intrinsic maps on the card: smooth fields in [-1, 1] and a
    disc mask, plus metallic/roughness per request."""
    def smooth(ch):
        z = torch.randn((batch, ch, 16, 16), generator=gen, device="cuda")
        z = F.interpolate(z, size=(res, res), mode="bilinear",
                          align_corners=False)
        return torch.tanh(z).permute(0, 2, 3, 1).contiguous()

    yy, xx = torch.meshgrid(torch.linspace(-1, 1, res, device="cuda"),
                            torch.linspace(-1, 1, res, device="cuda"),
                            indexing="ij")
    disc = ((xx ** 2 + yy ** 2) < 0.6).float() * 2.0 - 1.0
    req = {k: smooth(3) for k in ("normal", "albedo", "spec_light",
                                  "diff_light", "env")}
    req["mask"] = disc[None, :, :, None].expand(batch, res, res, 3)
    req["metallic"] = torch.rand(batch, generator=gen, device="cuda")
    req["roughness"] = torch.rand(batch, generator=gen, device="cuda")
    return req


def _wrappers():
    from unirenderer_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
    )
    from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
    from unirenderer_tpu_torch.ops.rasterize import rasterize
    out = {"groupnorm_silu": fused_groupnorm_silu, "rasterize": rasterize,
           "flash_attention_backward": flash_attention_backward}
    out.update((k, fn) for k, (fn, _) in _attention_kernels().items())
    return out


def reset_counters():
    for w in _wrappers().values():
        w.launches = 0
        w.seen.clear()


def read_counters():
    wrappers = _wrappers()
    return ({k: w.launches for k, w in wrappers.items()},
            {k: set(w.seen) for k, w in wrappers.items()})


def flagship_pipeline(torch, cfg):
    """Random bf16 flagship weights made on the card from the seed."""
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t = time.perf_counter()
    pipe = UniRendererPipeline.create(cfg, gen, device="cuda",
                                      dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.dual, pipe.vae, pipe.text)
                   for p in m.parameters())
    log(f"  flagship weights on the card: {n_params / 1e9:.3f} B params "
        f"bf16 in {time.perf_counter() - t:.1f} s")
    return pipe, n_params


def phase_main_path(torch, F, cfg, pipe, n_params, checked, profile):
    batch, res = 2, cfg.vae.sample_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    req = synthetic_request(torch, F, gen, batch, res)

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = pipe.mask2image_3mod_albedo(**req, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, seen = read_counters()
    peak = torch.cuda.max_memory_allocated()

    check(tuple(out.shape) == (batch, res, res, 3),
          f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    for name in ("groupnorm_silu", "flash_attention"):
        check(launches[name] > 0,
              f"kernel {name} was never launched on the main path")
        missed = seen[name] - checked[name]
        check(not missed, f"{name} got calls phase 2 did not check: "
              f"{sorted(missed)[:3]}")
    log(f"  2 requests x {cfg.sampler.num_steps} steps at {res}^2: wall "
        f"{wall:.3f} s, {wall / batch:.3f} s/request (first call, cold), "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}, "
        f"output range [{out.min().item():.3f}, {out.max().item():.3f}]")

    t = time.perf_counter()
    out2 = pipe.mask2image_3mod_albedo(**req, generator=gen)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    check(bool(torch.isfinite(out2).all()), "non-finite output (2nd call)")
    log(f"  second call (warm): wall {warm:.3f} s, "
        f"{warm / batch:.3f} s/request")
    result = dict(batch=batch, steps=cfg.sampler.num_steps, wall_s=wall,
                  warm_wall_s=warm, peak_bytes=peak, launches=launches,
                  params=n_params)
    if profile:
        result["profile"] = profile_request(
            torch, lambda: pipe.mask2image_3mod_albedo(**req, generator=gen))
    torch.cuda.empty_cache()
    return result


KERNEL_CLASSES = (          # (class, substrings of a device kernel's name)
    ("K1 groupnorm_silu", ("gn_stats_kernel", "gn_finalize_kernel",
                           "gn_apply_kernel")),
    ("K2 flash_attention", ("flash_fwd_kernel",)),
    ("K2 bwd flash_attention_backward", ("bwd_prep_kernel", "bwd_kernel<",
                                         "dq_convert_kernel")),
    ("K2s splash_attention", ("splash_fwd_kernel",)),
    ("K3 attn_kernel", ("unet_flash_kernel",)),
    ("convolution", ("fprop", "convolve", "implicit_gemm", "winograd")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
    ("normalisation (LayerNorm)", ("layer_norm",)),
    ("softmax", ("softmax",)),
)


def profile_request(torch, request):
    """Device time by kernel class over one full request (torch.profiler,
    device kernels only), against the wall of the profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    # device kernels only: a user annotation (the optimizer's
    # "Optimizer.step#AdamW.step") spans kernels that are counted already
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    by_class = {}
    for ms, n, key in kernels:
        cls = next((c for c, subs in KERNEL_CLASSES
                    if any(x in key for x in subs)), "elementwise / copy")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    syncs = sum(e.count for e in prof.key_averages() if "DtoH" in e.key)
    log(f"  profile of one request batch: wall {wall_ms:.1f} ms (profiler "
        f"on), device busy {busy:.1f} ms, idle {100 * (1 - busy / wall_ms):.1f}%"
        f", device-to-host copies {syncs}")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  {cls}")
    for ms, n, key in kernels[:15]:
        log(f"    {ms:9.3f} ms {n:6d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy, by_class=by_class,
                device_to_host_copies=syncs,
                top=[dict(ms=ms, count=n, name=key)
                     for ms, n, key in kernels[:60]])


# ---------------------------------------------------------------------------
# Phase 4: the trained small() weights through the converter
# ---------------------------------------------------------------------------


def small_inverse_request(torch, F, gen, batch, res):
    """A photo-like image (smooth fields) and the disc mask of
    `synthetic_request`, both on the card in [-1, 1]."""
    req = synthetic_request(torch, F, gen, batch, res)
    return dict(image=req["albedo"], mask=req["mask"])


def phase_small_weights(torch, F):
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.eval.quality import TEXT_NPZ
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    cfg = config.small()
    dual_flat, step = load_params_npz(DUAL_NPZ)
    vae_flat, _ = load_params_npz(VAE_NPZ)
    text_flat, _ = load_params_npz(TEXT_NPZ)
    n_keys = len(dual_flat) + len(vae_flat) + len(text_flat)
    card = UniRendererPipeline.create(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
        dtype=torch.bfloat16)
    loaded = card.load_flax(dual=dual_flat, vae=vae_flat, text=text_flat)
    host = UniRendererPipeline.create(
        cfg, torch.Generator().manual_seed(SEED), device="cpu",
        dtype=torch.float32)
    host.load_flax(dual=dual_flat, vae=vae_flat, text=text_flat)
    n_dec = sum("/controldec/" in k for k in dual_flat)
    log(f"  loaded {DUAL_NPZ} (step {step}; {len(dual_flat)} keys, "
        f"{n_dec} of them the attribute decoder's), {VAE_NPZ} and "
        f"{TEXT_NPZ}: {loaded} of {n_keys} keys, {n_keys - loaded} skipped")
    check(loaded == n_keys, "the converter skipped keys")

    # one forward and one inverse model evaluation, card bf16 against host
    # f32 plain versions
    g = torch.Generator().manual_seed(SEED)
    u, s, b = cfg.unet, cfg.unet.sample_size, 2
    img = torch.randn((b, s, s, u.in_channels), generator=g)
    attr = torch.randn((b, s, s, u.attr_channels), generator=g)
    ctx = torch.randn((b, cfg.text.max_length, u.cross_attention_dim),
                      generator=g)
    t_img = torch.tensor([999, 400])
    preds, attr_preds = [], []
    for pipe in (card, host):
        dev = pipe.device
        with torch.no_grad():
            down, mid = pipe.dual.encode_attr(
                attr.to(dev), torch.zeros(b, dtype=torch.long, device=dev),
                ctx.to(dev))
            preds.append(pipe.dual.image_stream_with_residuals(
                img.to(dev), t_img.to(dev), ctx.to(dev), down, mid).cpu())
            down, mid = pipe.dual.unet_raw_taps(
                img.to(dev), torch.zeros(b, dtype=torch.long, device=dev),
                ctx.to(dev))
            attr_preds.append(pipe.dual.attr_streams_with_unet_taps(
                attr.to(dev), t_img.to(dev), ctx.to(dev), down, mid).cpu())
    result = dict(loaded_keys=loaded, file_keys=n_keys)
    for what, (got, want) in (("forward", preds), ("inverse", attr_preds)):
        err = (got - want).abs().max().item()
        tol = SMALL_MODEL_REL * want.abs().max().item()
        log(f"  small() {what} model eval, card bf16 vs CPU f32: max|diff| "
            f"{err:.4g} tol {tol:.4g}")
        check(err <= tol, f"small() {what} model on the card disagrees "
              f"with the CPU")
        result[f"{what}_model_max_abs_err"] = err
        result[f"{what}_model_tol"] = tol

    # forward renders at batch 2: one through the public entry point (noise
    # from a generator on the card), then card and CPU on the same noise
    res = cfg.vae.sample_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    req = synthetic_request(torch, F, gen, b, res)
    out = card.mask2image_3mod_albedo(**req, generator=gen)
    check(tuple(out.shape) == (b, res, res, 3), "small render shape")
    check(bool(torch.isfinite(out).all()), "small render not finite")
    req = {k: v.cpu() for k, v in req.items()}
    lat = res // cfg.vae.downscale
    enc_noise = torch.randn((6 * b, lat, lat, 4), generator=g)
    img_noise = torch.randn((b, lat, lat, 4), generator=g)
    outs = [pipe.mask2image_3mod_albedo_with_noise(
        **req, enc_noise=enc_noise, img_noise=img_noise).cpu()
        for pipe in (card, host)]
    check(bool(torch.isfinite(outs[0]).all()), "small render not finite")
    diff = (outs[0].clamp(-1, 1) - outs[1].clamp(-1, 1))
    mse = (diff / 2).pow(2).mean().item()
    psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
    mean_abs = diff.abs().mean().item()
    log(f"  small() forward render (20 steps), card bf16 vs CPU f32: mean "
        f"|diff| {mean_abs:.4g} (limit {SMALL_RENDER_MEAN_ABS}), PSNR "
        f"{psnr:.2f} dB")
    check(mean_abs <= SMALL_RENDER_MEAN_ABS,
          "small() render on the card disagrees with the CPU")
    result.update(render_mean_abs_diff=mean_abs, render_psnr_db=psnr)

    # the inverse path at batch 2 (small()'s ensemble, 1), card and CPU on
    # the same noise: every output within 0.05 * max|ref| of f32
    inv = small_inverse_request(torch, F, gen, b, res)
    inv = {k: v.cpu() for k, v in inv.items()}
    enc_noise = torch.randn((2 * b, lat, lat, 4), generator=g)
    attr_noise = torch.randn((6, b, lat, lat, 4), generator=g)
    outs = [pipe.real_image2mask_3mod_albedo_with_noise(
        **inv, enc_noise=enc_noise, attr_noise=attr_noise)
        for pipe in (card, host)]
    worst = {}
    for k, want in outs[1].items():
        got = outs[0][k].cpu()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"small() inverse output {k}")
        worst[k] = (got - want).abs().max().item() / max(
            want.abs().max().item(), 1e-12)
    log(f"  small() inverse render (20 steps), card bf16 vs CPU f32, "
        f"max|diff| / max|ref| per output: "
        + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
        + f" (limit {SMALL_MODEL_REL})")
    check(max(worst.values()) <= SMALL_MODEL_REL,
          "small() inverse render on the card disagrees with the CPU")
    result["inverse_rel_err"] = worst
    return result


# ---------------------------------------------------------------------------
# Phase 5: the rasterizer against its plain version
# ---------------------------------------------------------------------------


def deformed_spheres(torch, views, sphere_res, v_pad, t_pad, seed):
    """Clip positions (B, v_pad, 4) and triangles (B, t_pad, 3) on the card:
    deformed spheres (the data generator's `make_shape`), unit-normalised,
    each seen from a random camera at distance 4 (the test split's pose
    sampler)."""
    import numpy as np
    from unirenderer_tpu_torch.data.synthetic import make_shape
    from unirenderer_tpu_torch.ops.transform import xfm_points
    from unirenderer_tpu_torch.render import camera
    from unirenderer_tpu_torch.render.mesh import (
        make_sphere, unit_normalize_mesh,
    )
    rng = np.random.default_rng(seed)
    base = make_sphere(sphere_res)
    pos, tris = [], []
    for _ in range(views):
        v = np.zeros((v_pad, 3), np.float32)
        v[:base.v_pos.shape[0]] = unit_normalize_mesh(
            make_shape(base.v_pos, rng))
        t = np.zeros((t_pad, 3), np.int32)
        t[:base.t_pos_idx.shape[0]] = base.t_pos_idx
        mvp, _ = camera.spherical_camera(rng.uniform(0, 360),
                                         rng.uniform(30, 150), 4.0)
        pos.append(xfm_points(torch.from_numpy(v)[None].cuda(),
                              mvp[None].cuda())[0])
        tris.append(torch.from_numpy(t).cuda())
    return torch.stack(pos).contiguous(), torch.stack(tris).contiguous()


def rast_bound(torch, pos, tri, h, w, peel):
    """Least time for the work: the per-triangle records in (64 B each)
    and the outputs out (16 B a pixel; prev_z in, 4 B) at the HBM rate, or
    the edge tests the 16x16 tile bins imply (every pixel of every tile a
    live triangle's box overlaps, 12 f32 operations each) at the f32 rate,
    whichever is larger."""
    from unirenderer_tpu_torch.ops.rasterize import _setup
    rec, box = _setup(pos, tri, h, w)
    nb, t = tri.shape[:2]
    live = rec[..., 9] != 0
    box = torch.where(live[..., None], box, torch.zeros_like(box))
    n_tx, n_ty = -(-w // RAST_TILE), -(-h // RAST_TILE)

    def tiles(lo, hi, n):
        first = torch.floor(lo / RAST_TILE).clamp(min=0)
        last = (torch.ceil(hi / RAST_TILE) - 1).clamp(max=n - 1)
        return (last - first + 1).clamp(min=0)

    per_tri = tiles(box[..., 0], box[..., 1], n_tx) * tiles(
        box[..., 2], box[..., 3], n_ty)
    tests = float((per_tri * live).sum().item()) * RAST_TILE * RAST_TILE
    nbytes = nb * t * 64 + nb * h * w * (16 + (4 if peel else 0))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = tests * RAST_TEST_FLOPS / FP32_FLOPS * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else
            "operations", tests)


def rast_case(torch, timer, name, pos, tri, h, w, prev_z=None):
    from unirenderer_tpu_torch.ops.rasterize import (
        match_stats, rasterize, rasterize_reference, within_rule,
    )
    got = rasterize(pos, tri, h, w, prev_z=prev_z)
    want = rasterize_reference(pos, tri, h, w, prev_z=prev_z)
    torch.cuda.synchronize()
    stats = match_stats(got, want)
    hits = (got.tri_id > 0).float().mean().item()
    del got, want
    ms = timer(lambda: rasterize(pos, tri, h, w, prev_z=prev_z))
    plain_ms = timer(lambda: rasterize_reference(pos, tri, h, w,
                                                 prev_z=prev_z))
    bound_ms, bound_by, tests = rast_bound(torch, pos, tri, h, w,
                                           prev_z is not None)
    return dict(kernel="rasterize", case=name,
                shape=[tri.shape[0], pos.shape[1], tri.shape[1], h, w],
                peel=prev_z is not None, ok=within_rule(stats), **stats,
                max_abs_err=max(stats["z_err"], stats["uv_err"]),
                coverage=hits, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, edge_tests=tests, library_ms=None)


def rast_signatures(cfg):
    """The rasterizer calls phase 5 checks, in the form the wrapper records
    in `.seen`: the flagship collate's (plain and peeled) and small()'s."""
    from unirenderer_tpu_torch.core import config
    out = set()
    for d, peels in ((cfg.data, (False, True)),
                     (config.small().data, (False,))):
        res = d.resolution * d.ssaa
        for peel in peels:
            out.add(((2, d.v_pad, 4), (2, d.t_pad, 3), res, res, peel))
    return out


def phase_rasterize(torch, cfg, timer):
    """K4 at the flagship collate's shape, the small() collate's shape, a
    peel layer and a ragged size."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.ops.rasterize import rasterize_reference
    d, s = cfg.data, config.small().data
    flag = cfg.data.resolution * cfg.data.ssaa
    small = s.resolution * s.ssaa
    pos, tri = deformed_spheres(torch, 2, 90, d.v_pad, d.t_pad, SEED)
    cases = [rast_case(torch, timer, "flagship collate", pos, tri, flag,
                       flag)]
    first = rasterize_reference(pos, tri, flag, flag)
    cases.append(rast_case(torch, timer, "flagship peel", pos, tri, flag,
                           flag, prev_z=first.z.contiguous()))
    del first
    cases.append(rast_case(torch, timer, "ragged", pos[:1], tri[:1], 1000,
                           744))
    pos_s, tri_s = deformed_spheres(torch, 2, 32, s.v_pad, s.t_pad, SEED + 1)
    cases.append(rast_case(torch, timer, "small collate", pos_s, tri_s,
                           small, small))
    for r in cases:
        log(f"  rasterize {r['case']:16s} {json.dumps(r['shape'])} "
            f"coverage {r['coverage']:.3f}: cover diff "
            f"{r['coverage_mismatch']} z err {r['z_err']:.2g} id diff "
            f"{100 * r['id_mismatch']:.3f}% uv err {r['uv_err']:.2g} "
            f"bit-equal {int(r['bit_equal'])} "
            f"{'ok' if r['ok'] else 'FAIL'}  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}; {r['edge_tests']:.3g} edge tests)")
    torch.cuda.empty_cache()
    bad = [r["case"] for r in cases if not r["ok"]]
    check(not bad, f"rasterize cases outside the rule: {bad}")
    return cases


# ---------------------------------------------------------------------------
# Phase 6: the flagship render chain
# ---------------------------------------------------------------------------


def flagship_items(torch, cfg, rng):
    """Two scenes at DataConfig(): a prefiltered env (on the card), deformed
    90-ring spheres with 256^2 procedural textures, materials from the grid
    and random cameras; the dataset's item layout."""
    from unirenderer_tpu_torch.data.objaverse import material_grid, pad_mesh
    from unirenderer_tpu_torch.data.synthetic import (
        make_env_latlong, make_shape, make_texture,
    )
    from unirenderer_tpu_torch.ops.cubemap import (
        build_env_mips, latlong_to_cubemap,
    )
    from unirenderer_tpu_torch.render.mesh import (
        auto_normals, compute_tangents, make_sphere, unit_normalize_mesh,
    )
    d, r = cfg.data, cfg.render
    torch.cuda.synchronize()
    t = time.perf_counter()
    latlong = torch.from_numpy(make_env_latlong(rng)).cuda()
    spec, diff = build_env_mips(latlong_to_cubemap(latlong, r.env_res),
                                min_res=r.env_min_res)
    torch.cuda.synchronize()
    env_s = time.perf_counter() - t
    env = {f"specular_{i}": m.cpu().numpy() for i, m in enumerate(spec)}
    env["diffuse"] = diff.cpu().numpy()
    log(f"  env prefiltered on the card in {env_s:.2f} s: specular "
        f"{[m.shape[1] for m in spec]}, diffuse {diff.shape[1]}")
    base = make_sphere(90)
    grid = material_grid(d.material_grid)
    items = []
    for _ in range(2):
        v = unit_normalize_mesh(make_shape(base.v_pos, rng))
        n = auto_normals(v, base.t_pos_idx)
        tng = compute_tangents(v, base.t_pos_idx, base.v_tex,
                               base.t_pos_idx, n, base.t_pos_idx)
        tex = make_texture(d.texture_res, rng)
        mesh = pad_mesh(dict(v_pos=v, t_idx=base.t_pos_idx, v_nrm=n,
                             v_tex=base.v_tex, v_tng=tng), d.v_pad, d.t_pad)
        mesh["kd_tex"] = tex
        met, rough = grid[rng.integers(len(grid))]
        items.append(dict(mesh=mesh, env=env, metallic=met,
                          roughness=rough, azimuth=rng.uniform(0, 360),
                          elevation=rng.uniform(30, 150),
                          distance=d.camera_distance))
    return items, env_s


def collate_profile(torch, items, d):
    """Device time of one warm collate (torch.profiler): total busy, the
    rasterizer kernel's, and the wall of the profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from unirenderer_tpu_torch.data.objaverse import collate_render
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        collate_render(items, resolution=d.resolution, ssaa=d.ssaa,
                       device="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.self_device_time_total / 1e3, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for ms, _ in kernels)
    k4 = sum(ms for ms, key in kernels if "rast_tile_kernel" in key)
    top = sorted(kernels, reverse=True)[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy, k4_device_ms=k4,
                top=[dict(ms=ms, name=key[:90]) for ms, key in top])


def phase_render_chain(torch, cfg, pipe, checked, rast_checked):
    import numpy as np
    from unirenderer_tpu_torch.data.objaverse import collate_render
    d = cfg.data
    rng = np.random.default_rng(SEED)
    items, env_s = flagship_items(torch, cfg, rng)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    reset_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    maps = collate_render(items, resolution=d.resolution, ssaa=d.ssaa,
                          device="cuda")
    torch.cuda.synchronize()
    collate_cold = time.perf_counter() - t
    after_collate, _ = read_counters()
    t = time.perf_counter()
    out = pipe.mask2image_3mod_albedo(
        normal=maps["normal"], albedo=maps["albedo"],
        spec_light=maps["spec_light"], diff_light=maps["diff_light"],
        env=maps["env"], mask=maps["mask"], metallic=maps["metallic"],
        roughness=maps["roughness"], generator=gen,
        material_image_encode=True)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t
    launches, seen = read_counters()

    res = d.resolution
    for k in ("image", "mask", "material", "normal", "albedo", "spec_light",
              "diff_light", "env"):
        check(tuple(maps[k].shape) == (2, res, res, 3),
              f"collate map {k} has shape {tuple(maps[k].shape)}")
        check(bool(torch.isfinite(maps[k]).all()), f"collate map {k}")
    coverage = [((maps["mask"][i] > 0).float().mean().item())
                for i in range(2)]
    check(all(0.02 < c < 0.98 for c in coverage),
          f"mask coverage {coverage}")
    check(tuple(out.shape) == (2, res, res, 3), "render chain output shape")
    check(bool(torch.isfinite(out).all()), "render chain output not finite")
    for name in ("groupnorm_silu", "flash_attention", "rasterize"):
        check(launches[name] > 0,
              f"kernel {name} was never launched on the render chain")
    for name in ("groupnorm_silu", "flash_attention"):
        missed = seen[name] - checked[name]
        check(not missed, f"{name} got calls phase 2 did not check: "
              f"{sorted(missed)[:3]}")
    missed = seen["rasterize"] - rast_checked
    check(not missed, f"rasterize got calls phase 5 did not check: "
          f"{sorted(missed)}")

    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        collate_render(items, resolution=d.resolution, ssaa=d.ssaa,
                       device="cuda")
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    prof = collate_profile(torch, items, d)
    log(f"  collate of 2 scenes at {res}^2 x SSAA {d.ssaa} "
        f"(T {d.t_pad}, {d.texture_res}^2 textures): cold "
        f"{collate_cold * 1e3:.1f} ms, warm {min(warm) * 1e3:.1f}-"
        f"{max(warm) * 1e3:.1f} ms; K4 launches per collate "
        f"{after_collate['rasterize']}; mask coverage "
        f"{[round(c, 3) for c in coverage]}")
    log(f"  profiled collate: wall {prof['wall_ms']:.1f} ms (profiler on), "
        f"device busy {prof['device_busy_ms']:.2f} ms, K4 "
        f"{prof['k4_device_ms']:.3f} ms = "
        f"{100 * prof['k4_device_ms'] / max(prof['device_busy_ms'], 1e-9):.1f}"
        f"% of device time")
    for k in prof["top"]:
        log(f"    {k['ms']:9.3f} ms  {k['name']}")
    log(f"  forward render of the 8 maps (material_image_encode, "
        f"{cfg.sampler.num_steps} steps): wall {forward_s:.3f} s; launches "
        f"on the chain {launches}; output range "
        f"[{out.min().item():.3f}, {out.max().item():.3f}]")
    return dict(env_prefilter_s=env_s, collate_cold_s=collate_cold,
                collate_warm_s=warm, forward_s=forward_s,
                launches=launches,
                k4_per_collate=after_collate["rasterize"],
                mask_coverage=coverage, collate_profile=prof)


# ---------------------------------------------------------------------------
# Phase 7: the held-out forward PSNR
# ---------------------------------------------------------------------------


def phase_held_out(torch, ensembles=(1, 5)):
    from unirenderer_tpu_torch.eval.quality import (
        held_out_scores, small_trained_pipeline,
    )
    t = time.perf_counter()
    pipe = small_trained_pipeline("cuda", torch.bfloat16)
    out = {}
    for e in ensembles:
        r = held_out_scores(pipe, n=32, num_steps=20, noise_seeds=(1000,),
                            inverse=True, ensemble=e,
                            log=lambda msg: log(f"  {msg}"))
        out[f"ensemble_{e}"] = r
        value, inv, ref = (r["psnr_forward_render"], r["inverse"],
                           INVERSE_REFERENCE[e])
        log(f"  held-out forward PSNR {value:.3f} dB (n=32, 20 steps, bf16 "
            f"on the card) beside QUALITY_r05_fixed's {PSNR_REFERENCE:.2f} "
            f"dB; set generated in {r['generate_seconds']:.1f} s")
        log(f"  held-out inverse, ensemble {e}: PSNR normal "
            f"{inv['psnr_maps']['normal']:.3f} (reference {ref['normal']:.2f})"
            f", albedo {inv['psnr_maps']['albedo']:.3f} ({ref['albedo']:.2f})"
            f", spec {inv['psnr_maps']['spec_light']:.3f}, diff "
            f"{inv['psnr_maps']['diff_light']:.3f} dB; normal angle mean "
            f"{inv['normal_angle_mean']:.2f} deg ({ref['angle']:.2f}); MR "
            f"MAE {inv['metal_rough_mae']:.4f} ({ref['mr_mae']:.3f})")
        check(value >= PSNR_REFERENCE - PSNR_MARGIN,
              f"held-out forward PSNR {value:.3f} dB is more than "
              f"{PSNR_MARGIN} dB below {PSNR_REFERENCE:.2f}")
        for k in ("normal", "albedo"):
            check(inv["psnr_maps"][k] >= ref[k] - PSNR_MARGIN,
                  f"held-out inverse {k} PSNR {inv['psnr_maps'][k]:.3f} dB "
                  f"(ensemble {e}) is more than {PSNR_MARGIN} dB below "
                  f"{ref[k]:.2f}")
        check(inv["normal_angle_mean"] <= ref["angle"] + ANGLE_MARGIN,
              f"held-out mean normal angle {inv['normal_angle_mean']:.2f} "
              f"(ensemble {e}) is more than {ANGLE_MARGIN} deg above "
              f"{ref['angle']:.2f}")
        check(inv["metal_rough_mae"] <= ref["mr_mae"] + MR_MAE_MARGIN,
              f"held-out MR MAE {inv['metal_rough_mae']:.4f} (ensemble {e}) "
              f"is more than {MR_MAE_MARGIN} above {ref['mr_mae']:.3f}")
    log(f"  phase {time.perf_counter() - t:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the flagship inverse request and the attention routes
# ---------------------------------------------------------------------------


def phase_inverse(torch, F, cfg, pipe, checked, profile):
    from unirenderer_tpu_torch.pipelines import forward_self_attention_calls
    batch, res, e = 2, cfg.vae.sample_size, INVERSE_ENSEMBLE
    steps = cfg.sampler.num_steps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    req = small_inverse_request(torch, F, gen, batch, res)

    walls = []
    for i in range(2):
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.real_image2mask_3mod_albedo(**req, generator=gen,
                                               ensemble=e)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if i == 0:
            launches, seen = read_counters()
            peak = torch.cuda.max_memory_allocated()
    lat = res // cfg.vae.downscale
    shapes = dict(normal=(batch, res, res, 3), albedo=(batch, res, res, 3),
                  spec_light=(batch, res, res, 3),
                  diff_light=(batch, res, res, 3), env=(batch, res, res, 3),
                  metallic=(batch, res, res), roughness=(batch, res, res),
                  material_latents=(batch, lat, lat, 4))
    check(set(out) == set(shapes), f"inverse outputs {sorted(out)}")
    for k, shape in shapes.items():
        check(tuple(out[k].shape) == shape,
              f"inverse {k} has shape {tuple(out[k].shape)}")
        check(bool(torch.isfinite(out[k]).all()), f"inverse {k} not finite")
    for name in ("groupnorm_silu", "flash_attention"):
        check(launches[name] > 0,
              f"kernel {name} was never launched on the inverse path")
        missed = seen[name] - checked[name]
        check(not missed, f"{name} got calls phase 2 did not check: "
              f"{sorted(missed)[:3]}")
    log(f"  {batch} photos x ensemble {e} x {steps} steps at {res}^2: wall "
        f"{walls[0]:.3f} s cold, {walls[1]:.3f} s warm, peak memory "
        f"{peak / 2**30:.2f} GiB, launches {launches}")
    result = dict(batch=batch, ensemble=e, steps=steps, wall_s=walls[0],
                  warm_wall_s=walls[1], peak_bytes=peak, launches=launches)
    if profile:
        result["profile"] = profile_request(
            torch, lambda: pipe.real_image2mask_3mod_albedo(
                **req, generator=gen, ensemble=e))

    # one warm forward request per attention route
    fwd = synthetic_request(torch, F, torch.Generator(
        device="cuda").manual_seed(SEED), batch, res)
    expected = forward_self_attention_calls(cfg, batch, res, steps)
    images = {}
    for route, name in (("auto", "flash_attention"),
                        ("splash", "splash_attention"),
                        ("unet_flash", "attn_kernel")):
        os.environ["UNIRENDER_ATTN"] = route
        try:
            reset_counters()
            torch.cuda.synchronize()
            t = time.perf_counter()
            images[route] = pipe.mask2image_3mod_albedo(
                **fwd, generator=torch.Generator(device="cuda").manual_seed(
                    SEED))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            del os.environ["UNIRENDER_ATTN"]
        launches, seen = read_counters()
        log(f"  forward request under UNIRENDER_ATTN={route}: wall "
            f"{wall:.3f} s, launches {launches}")
        result[f"route_{route}"] = dict(wall_s=wall, launches=launches)
        if route == "auto":
            continue
        check(launches[name] == expected,
              f"UNIRENDER_ATTN={route}: {launches[name]} {name} launches, "
              f"{expected} tileable self-attention calls in the code")
        missed = seen[name] - checked[name]
        check(not missed, f"{name} got calls phase 2 did not check: "
              f"{sorted(missed)[:3]}")
        ref = images["auto"]
        err = (images[route] - ref).abs().max().item()
        tol = SMALL_MODEL_REL * ref.abs().max().item()
        mean = (images[route] - ref).abs().mean().item()
        log(f"    image against the default route's: max|diff| {err:.4g} "
            f"(tol {tol:.4g}), mean |diff| {mean:.4g}, bf16 rule 2^-7 * "
            f"max|ref| = {CARD_REL * ref.abs().max().item():.4g}")
        check(bool(torch.isfinite(images[route]).all()) and err <= tol,
              f"UNIRENDER_ATTN={route} image disagrees with the default")
        result[f"route_{route}"].update(max_abs_diff=err, tol=tol,
                                        mean_abs_diff=mean)
    result["route_expected_launches"] = expected
    return result


# ---------------------------------------------------------------------------
# Phase 9: a training step at small(), card against CPU
# ---------------------------------------------------------------------------


def phase_small_training(torch):
    import tempfile
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.core.convert import load_flax
    from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
    from unirenderer_tpu_torch.train.compare import (
        compare, small_weights, smooth_batch, trainer_with,
    )
    cfg = config.small()
    t = time.perf_counter()
    result = compare([("cuda", torch.bfloat16), ("cpu", torch.float32)])
    for branch, r in result.items():
        log(f"  small() {branch} step, card bf16 vs CPU f32: loss "
            f"{r['loss']:.6g} vs {r['loss_ref']:.6g} (rel err "
            f"{r['loss_rel_err']:.3g}, limit {TRAIN_LOSS_REL}), gradient "
            f"cosine {r['grad_cos']:.6f} (>= {TRAIN_GRAD_COS}), norm "
            f"{r['grad_norm']:.5g} vs {r['grad_norm_ref']:.5g} (ratio "
            f"{r['norm_ratio']:.5f}, within {TRAIN_NORM_REL})")
        check(r["loss_rel_err"] <= TRAIN_LOSS_REL
              and r["grad_cos"] >= TRAIN_GRAD_COS
              and abs(r["norm_ratio"] - 1) <= TRAIN_NORM_REL,
              f"small() {branch} train step on the card disagrees with the "
              f"CPU")
    with tempfile.TemporaryDirectory() as tmp:
        tr = trainer_with(cfg, small_weights(), "cuda", torch.bfloat16, tmp)
        batch = {k: v.cuda() for k, v in smooth_batch(cfg, 2, SEED).items()}
        reset_counters()
        tr.train(iter([batch] * 2), max_steps=2)
        torch.cuda.synchronize()
        launches, _ = read_counters()
        for name in ("groupnorm_silu", "flash_attention",
                     "flash_attention_backward"):
            check(launches[name] > 0, f"{name} never launched in training")
        flat, step = load_params_npz(
            os.path.join(tr.ckpt_dir, "params_00000002.npz"))
        n = load_flax(DualStreamModel(cfg.unet), flat)
        with open(tr.metrics_path) as f:
            logged = [json.loads(line)["step"] for line in f]
    check(step == 2 and n == len(flat) and logged == [1],
          f"Trainer checkpoint: step {step}, {n} of {len(flat)} keys, "
          f"logged steps {logged}")
    log(f"  2 Trainer steps on the card: params npz of step {step} reloads "
        f"strictly ({n} keys); launches {launches}; phase "
        f"{time.perf_counter() - t:.1f} s")
    result.update(npz_keys=n, trainer_launches=launches)
    return result


# ---------------------------------------------------------------------------
# Phase 10: flagship training
# ---------------------------------------------------------------------------


def phase_flagship_training(torch, cfg, checked, profile):
    import tempfile
    import numpy as np
    from unirenderer_tpu_torch.train.train_step import train_step_launches
    from unirenderer_tpu_torch.train.trainer import Trainer, rendered_batches
    d = cfg.data
    items, _ = flagship_items(torch, cfg, np.random.default_rng(SEED))
    counted = ("groupnorm_silu", "flash_attention",
               "flash_attention_backward")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        trainer = Trainer(cfg, tmp, device="cuda")
        torch.cuda.synchronize()
        params = trainer.state.params
        n_params = sum(p.numel() for p in params.values())
        log(f"  flagship Trainer: {n_params / 1e9:.3f} B f32 master params, "
            f"compute {trainer.compute_dtype}, remat {cfg.unet.remat}, "
            f"built in {time.perf_counter() - t:.1f} s")
        watch = {n: params[n].detach().clone() for n in
                 (next(k for k in params if k.startswith(m))
                  for m in ("unet.", "controlnet.", "controldec."))}
        batches = rendered_batches(items, 2, d.resolution, d.ssaa,
                                   device="cuda", seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        steps, totals = [], {}
        for inverse in (False, True, False, True):
            batch = next(batches)
            torch.cuda.synchronize()
            reset_counters()
            t = time.perf_counter()
            metrics = trainer.step(batch, is_inverse=inverse)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches, seen = read_counters()
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            want = train_step_launches(cfg, 2, inverse)
            kind = "inverse" if inverse else "forward"
            log(f"  {kind} step {trainer.state.step}: {wall:.3f} s, loss "
                f"{loss:.5g}, grad norm {norm:.5g}, launches "
                + ", ".join(f"{k} {launches[k]} (config {want[k]})"
                            for k in counted))
            check(math.isfinite(loss) and math.isfinite(norm),
                  f"non-finite loss or grad norm at a {kind} step")
            for k in counted:
                check(launches[k] == want[k],
                      f"{k}: {launches[k]} launches in a {kind} step, "
                      f"{want[k]} from the config")
                missed = seen[k] - checked[k]
                check(not missed, f"{k} got calls phase 2 did not check: "
                      f"{sorted(missed)[:3]}")
            steps.append(dict(inverse=inverse, wall_s=wall, loss=loss,
                              grad_norm=norm, launches=launches))
            for k in counted:
                totals[k] = totals.get(k, 0) + launches[k]
        peak = torch.cuda.max_memory_allocated()
        moved = [n for n, p0 in watch.items()
                 if not torch.equal(p0, params[n].detach())]
        check(len(moved) == len(watch), f"parameters did not change: "
              f"{sorted(set(watch) - set(moved))}")
        walls = {k: [s["wall_s"] for s in steps if s["inverse"] == inv]
                 for k, inv in (("forward", False), ("inverse", True))}
        log(f"  flagship train steps at batch 2, {d.resolution}^2: forward "
            f"{walls['forward'][0]:.3f} s cold, {walls['forward'][1]:.3f} s "
            f"warm; inverse {walls['inverse'][0]:.3f} s cold, "
            f"{walls['inverse'][1]:.3f} s warm; peak memory "
            f"{peak / 2**30:.2f} GiB")
        result = dict(params=n_params, steps=steps, peak_bytes=peak,
                      launches=totals, forward_wall_s=walls["forward"],
                      inverse_wall_s=walls["inverse"])
        if profile:
            batch = next(batches)
            result["profile"] = profile_request(
                torch, lambda: trainer.step(batch, is_inverse=True))
        del trainer, params, watch
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------


KERNELS = {
    "groupnorm_silu": dict(
        route="cuda", source="unirenderer_tpu_torch/csrc/groupnorm.cu",
        replaces="unirenderer_tpu/ops/groupnorm.py:42",
        # the UNet's 64^2 ResnetBlock norm: the most frequent large call
        headline=lambda r: (r["shape"] == [2, 64, 64, 320]
                            and r["eps"] == 1e-5 and r["silu"])),
    "flash_attention": dict(
        route="cuda", source="unirenderer_tpu_torch/csrc/flash_attention.cu",
        replaces="unirenderer_tpu/ops/flash_attention.py:68",
        # the 64^2 self-attention: most of the path's attention work
        headline=lambda r: r["shape"] == [[2, 4096, 8, 40]] * 2),
    "flash_attention_backward": dict(
        route="cuda",
        source="unirenderer_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="unirenderer_tpu/ops/flash_attention.py:68",
        # the 64^2 self-attention's backward, in every training step
        headline=lambda r: r["shape"] == [[2, 4096, 8, 40]] * 2),
    "splash_attention": dict(
        route="cuda", source="unirenderer_tpu_torch/csrc/splash_attention.cu",
        replaces="unirenderer_tpu/ops/flash_attention.py:99",
        # the 64^2 self-attention, under UNIRENDER_ATTN=splash
        headline=lambda r: r["shape"] == [[2, 4096, 8, 40]] * 2),
    "attn_kernel": dict(
        route="cuda", source="unirenderer_tpu_torch/csrc/attn_kernel.cu",
        replaces="unirenderer_tpu/ops/attn_kernel.py:48",
        # the 64^2 self-attention, under UNIRENDER_ATTN=unet_flash, with the
        # route's options (running max, pipelined)
        headline=lambda r: (r["shape"] == [[2, 4096, 8, 40]] * 2
                            and r["options"] == {})),
    "rasterize": dict(
        route="cuda", source="unirenderer_tpu_torch/csrc/rasterize.cu",
        replaces="unirenderer_tpu/ops/rasterize_pallas.py:134",
        # the flagship collate's raster: 2 views at 1024^2, T 32768
        headline=lambda r: r.get("case") == "flagship collate"),
}


def kernels_line(results, launches):
    """The result line: per kernel its main-path launches, its worst error
    over all checked cases, and the times and bound of its headline case."""
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in results if r["kernel"] == name]
        head = next(r for r in mine if meta["headline"](r))
        out.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"],
            cases=len(mine)))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (every case)")
    ap.add_argument("--phases", default=ALL_PHASES)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 2
    try:
        from unirenderer_tpu_torch.core import config
        from unirenderer_tpu_torch.ops import _build
        from unirenderer_tpu_torch.ops.flash_attention import tileable
        from unirenderer_tpu_torch.pipelines import (
            inverse_kernel_cases, kernel_cases,
        )
        from unirenderer_tpu_torch.train.train_step import (
            train_kernel_cases,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr, flush=True)
        return 3

    record = {}
    try:
        # ---- 0: device
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi()
        log(f"phase 0 device: {kind} x{count}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
        print(f"nvidia-smi: {smi}", flush=True)
        record["device"] = dict(name=kind, count=count, nvidia_smi=smi,
                                torch=torch.__version__,
                                cuda=torch.version.cuda)
        # ---- 1: build
        if phases - {0}:
            t = time.perf_counter()
            built = _build.build()
            log(f"phase 1 build: {time.perf_counter() - t:.1f} s wall "
                f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
            record["build"] = {}
            for b in built.values():
                log(f"  {b.name}: {b.seconds:.1f} s -> {b.path.name}")
                report = [line.strip() for line in b.log.splitlines()
                          if "entry function" in line or "registers" in line
                          or "spill" in line or "Performance Loss" in line
                          or "injected" in line]
                for line in report:
                    print(f"    {line}", flush=True)
                record["build"][b.name] = dict(seconds=b.seconds,
                                               ptxas=report)

        cfg = config.flagship()
        gn_cases, attn_cases = set(), set()
        res = cfg.vae.sample_size
        train_gn, train_attn = train_kernel_cases(cfg, 2, res)  # phase 10
        for gn, attn in (kernel_cases(cfg, 2, res, False),       # phase 3
                         kernel_cases(cfg, 2, res, True),        # phase 6
                         inverse_kernel_cases(cfg, 2, res,       # phase 8
                                              INVERSE_ENSEMBLE),
                         (train_gn, train_attn)):
            gn_cases |= gn
            attn_cases |= attn
        routed = sorted((q, k) for q, k in attn_cases
                        if q == k and tileable(q[1], k[1], q[3]))
        # the two routes at every tileable self-attention shape; K3 also
        # without the running max (randn inputs: the scaled logits stay
        # far below exp2's range) and unpipelined, at the forward shapes
        route_cases = ([("splash_attention", c, {}) for c in routed]
                       + [("attn_kernel", c, {}) for c in routed]
                       + [("attn_kernel", c, {"running_max": False})
                          for c in routed]
                       + [("attn_kernel", c, {"pipelined": False})
                          for c in routed if c[0][0] == 2])
        checked = {"groupnorm_silu": set(gn_cases),
                   "flash_attention": set(attn_cases),
                   "flash_attention_backward": set(train_attn),
                   "splash_attention": set(routed),
                   "attn_kernel": set(routed)}
        # ---- 2: kernels against their plain versions
        results = []
        if 2 in phases:
            tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            log(f"phase 2 kernels vs plain versions, bf16, tolerance "
                f"2^-7 * max|ref| (TF32 off for the plain versions): "
                f"{len(gn_cases)} GroupNorm + {len(attn_cases)} attention "
                f"main-path cases + ragged, {len(route_cases)} route cases, "
                f"{len(train_attn)} attention backward cases + ragged "
                f"(tolerance 2^-6 * max|ref|)")
            ragged_gn = [((2, 37, 29, 320), 32, 1e-5, True),
                         ((1, 33, 31, 1920), 32, 1e-6, False)]
            ragged_attn = [((2, 1000, 8, 40), (2, 333, 8, 40)),
                           ((1, 77, 3, 24), (1, 200, 3, 24))]
            timer = Timer(torch)
            results = phase_kernels(
                torch, F, timer, sorted(gn_cases) + ragged_gn,
                sorted(attn_cases) + ragged_attn, route_cases,
                sorted(train_attn) + ragged_attn)
            del timer
            torch.cuda.empty_cache()
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32     # PyTorch defaults
            record["kernel_cases"] = results
            log("phase 2 done")
        launches = {}
        pipe = None
        if phases & {3, 6, 8}:
            pipe, n_params = flagship_pipeline(torch, cfg)
        # ---- 3: main path
        if 3 in phases:
            log("phase 3 main path: flagship, 2 requests, "
                f"{cfg.sampler.num_steps} steps")
            main_path = phase_main_path(torch, F, cfg, pipe, n_params,
                                        checked, args.profile)
            launches = main_path["launches"]
            record["main_path"] = main_path
            log("phase 3 done")
        # ---- 4: trained small() weights
        if 4 in phases:
            log("phase 4 converter on the card: small() trained weights")
            record["small_weights"] = phase_small_weights(torch, F)
            log("phase 4 done")
        # ---- 5: the rasterizer
        if 5 in phases:
            log("phase 5 rasterizer vs its plain version (f32; the rule "
                "of the JAX package's Pallas test)")
            timer = Timer(torch)
            rast_cases = phase_rasterize(torch, cfg, timer)
            del timer
            results += rast_cases
            record["rasterize_cases"] = rast_cases
            log("phase 5 done")
        # ---- 6: the flagship render chain
        if 6 in phases:
            log("phase 6 render chain: env prefilter, collate of 2 flagship "
                "scenes, forward render of its maps")
            chain = phase_render_chain(torch, cfg, pipe, checked,
                                       rast_signatures(cfg))
            launches["rasterize"] = chain["launches"]["rasterize"]
            record["render_chain"] = chain
            log("phase 6 done")
        # ---- 8: the flagship inverse request, the attention routes
        if 8 in phases:
            log("phase 8 flagship inverse request: 2 photos x ensemble "
                f"{INVERSE_ENSEMBLE}, {cfg.sampler.num_steps} steps; one "
                "forward request per attention route")
            inverse = phase_inverse(torch, F, cfg, pipe, checked,
                                    args.profile)
            for route, kernel in (("splash", "splash_attention"),
                                  ("unet_flash", "attn_kernel")):
                launches[kernel] = inverse[f"route_{route}"]["launches"][
                    kernel]
            record["inverse"] = inverse
            log("phase 8 done")
        del pipe
        torch.cuda.empty_cache()
        # ---- 7: the held-out harness
        if 7 in phases:
            log("phase 7 held-out harness: trained small() weights, forward "
                "and inverse legs")
            record["held_out"] = phase_held_out(torch)
            log("phase 7 done")
        # ---- 9: a small() training step, card against CPU
        if 9 in phases:
            log("phase 9 training at small(): trained weights, one step on "
                "the card (bf16) against the CPU (f32); 2 Trainer steps")
            record["small_training"] = phase_small_training(torch)
            log("phase 9 done")
        # ---- 10: flagship training
        if 10 in phases:
            log("phase 10 flagship training: batch 2 of collated maps, 4 "
                "steps (forward, inverse, forward, inverse)")
            training = phase_flagship_training(torch, cfg, checked,
                                               args.profile)
            launches["flash_attention_backward"] = training["launches"][
                "flash_attention_backward"]
            record["flagship_training"] = training
            log("phase 10 done")
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
                json.dump(record, f, indent=1, default=str)

    if phases != {int(p) for p in ALL_PHASES.split(",")}:
        log(f"phases {sorted(phases)} passed (partial run: no result line)")
        return 0
    log("all phases passed")
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(json.dumps(kernels_line(results, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
