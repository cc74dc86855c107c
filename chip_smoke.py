#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`unirenderer_tpu_torch`) on one card.

    python3 chip_smoke.py [--out DIR] [--phases 0,1,...,16] [--profile]

Phases, each printing its elapsed seconds as it goes (in the order 0-6,
8, 7, 9-16: phase 8 reuses phase 3's flagship weights, freed before phase
7):
  0  device: name, count, torch/CUDA versions, nvidia-smi name and power limit
  1  build: one nvcc per kernel source, all started together; build seconds
     and the -Xptxas -v report (registers, shared memory, spills, and any
     note that ptxas serialized the wgmma instructions); the f32 attention
     kernels' instances must not spill
  2  kernels against their plain PyTorch versions in bf16, at every call
     signature the flagship forward path (batch 2) and the flagship inverse
     path (batch 2 x ensemble 5) give them, plus a ragged case each (K1
     with the model's bf16 scale and bias, and with f32 ones at the ragged
     and headline cases; every K1 case run twice, the same bits); the
     splash (K2s) and unet_flash (K3) routes at every tileable
     self-attention shape of both paths, K3 under all four running-max /
     pipelined combinations (bounded logits) and at a ragged shape; time
     of kernel, plain version and one PyTorch
     library call (F.group_norm + F.silu, F.scaled_dot_product_attention:
     timed here as yardsticks, never called by the port), the timer's own
     floor, and each case's bound (for the forward attention kernels the
     largest of tensor-core operations, bytes and one exp2 a score on the
     special-function unit, each printed); the attention backward (K2 bwd)
     at every attention shape of the flagship training step (batch 2) plus
     a ragged case each: dQ, dK, dV each within 2^-6 * max|plain| of the
     plain backward in f32 on the same bf16 inputs and the kernel's own O
     and log-sum-exp, that log-sum-exp within 2^-14 of the plain f32 one
     of its bf16 inputs, the forward's output with the log-sum-exp
     bit-identical to the serving launch's, and a second backward run on
     the same inputs (dQ's f32 sums are atomic adds in no fixed order)
     within the tolerance of the first; library = autograd of
     F.scaled_dot_product_attention; every case prints its ratio to the
     library call; K2 on 8 fresh draws at (2,4096,8,40), each within its
     2^-7 * max|plain|
  3  the main path at flagship width: random bf16 weights made on the card
     from a seed, 2 requests (one batch of 2) through
     `UniRendererPipeline.mask2image_3mod_albedo`, 20 UniPC steps; checks
     shape, finiteness, that both kernels ran and that every call they got
     was checked in phase 2 (with --profile: one K1 device kernel a call)
  4  the repo's trained small() weights through the flax converter onto the
     card, every key loaded (the attribute decoder's too): one forward and
     one inverse model evaluation against the same weights in f32 on the
     CPU (plain versions); one forward render at batch 2 through the public
     entry point; one forward render and one inverse render (20 steps) on
     card and CPU from the same noise, compared
  5  the rasterizer (K4) against its plain version on the card: the
     flagship collate's shape (2 views at 1024^2, deformed 90-ring spheres,
     T padded to 32768), the small() shape (128^2, T 8192), a depth-peel
     layer, a ragged size, a full-screen triangle over the flagship views
     and a mesh of degenerate and padding triangles only; each within the
     comparison rule of the JAX package's Pallas test and bit-equal; the
     set-up kernel's records and boxes bit-equal to `_setup` and its tile
     lists equal to `rast_bins_reference` at the flagship collate; device
     kernels a call (torch.profiler, at most 5); kernel, plain and bound
     times
  6  the flagship render chain: one env prefiltered on the card (512 base,
     6 specular mips), `collate_render` of 2 scenes at DataConfig()
     (512^2, SSAA 2, T 32768, 256^2 textures), its 8 maps through
     `mask2image_3mod_albedo` (flagship width, random bf16 weights, 20
     steps, material_image_encode); collate cold/warm times, K4's share,
     launches of all three kernels on this path
  7  the held-out harness: the seed-99 held-out set (32 meshes, 8 envs)
     generated on the card, the trained small() weights and the JAX
     harness's text encoder in bf16, 32 objects, 20 steps; the forward
     PSNR (`eval.quality.held_out_scores`) fails more than 1 dB below
     QUALITY_r05_fixed.json's 25.17 dB; the inverse leg (the same
     batches' `tool_scores`) at ensemble 1 and 5 fails more than
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
     max|ref| (phase 4's bf16 model rule) of the default route's (with
     --profile: the warm unet_flash request profiled beside the default
     one, one K3 device kernel a call and no kernel beside it)
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
 11  the sampling modes: random bf16 flagship weights from the seed (phase
     3's), every request's K1/K2 launches equal to the config's count
     (`pipelines.KernelCalls`) and every call checked in phase 2 (its new
     shapes run there after every earlier case): forward at batch 2 x 20
     steps with encoder_reuse 1, 2, 3 on the same inputs and noise (1 the
     bits of the default request; 2 and 3 finite, differing from it by a
     mean |diff| under 1.0; warm wall, device busy time from the profiler,
     peak memory); a guided forward `_sample` (scale 3, the model at batch
     4) with and without a negative context; `joint_sample` at batch 2;
     inverse at batch 2 x ensemble 1 with `hoist_invariant` on and off,
     every map within 2^-7 * max|hoisted|; `relight` at batch 1 with a
     seeded latlong prefiltered at 128 with 64 samples; `rendering` and
     `inverse_rendering` at batch 1 on a legacy16() and a legacy12() model,
     each built, run and freed in turn; the small() r05 held-out forward
     PSNR at encoder_reuse=2 no more than 1 dB below the JAX package's
     (artifacts/r05/encoder_reuse_small.json)
 12  the rest of training: a scene bank on the card from phase 6's two
     flagship scenes (meshes padded to the set's max (V, T) rounded up to
     128), K4 against its plain version at the bank steps' raster shapes;
     4 flagship bank steps of `Trainer(scene_bank=...)` (AdamW), forward /
     inverse / forward / inverse, each step's K1, K2, K2 bwd and K4
     launches equal to `train_step_launches(render=True)` and every call
     checked earlier, warm wall, peak memory, the bank's bytes, a profile
     of one warm step (device busy, idle share, K4's share); the time of
     an `AsyncSaver` snapshot (the clone alone); at the same draws the
     render-in-step and two-phase steps' loss within 1e-3 relative of the
     plain step's; 2 Adafactor bank steps (peak memory against AdamW's); 4
     calls with gradient accumulation k = 2 (parameters move on calls 2
     and 4 only); 3 VAE training steps at flagship width from the bank (1
     scene x 8 maps, bf16; K1 launches from the config, K2 none); at
     small() with the r05 weights, validation on 4 held-out objects (seed
     99) equal to the harness's inverse PSNRs at the same params and
     noise, 2 bank steps over the held-out set with a checkpoint, a fresh
     Trainer resuming bit-equal (params, optimizer state, step, generator)
     and one more step from each within 1e-3 relative
 13  the apps and the rest of eval: the stdlib HTTP server on 127.0.0.1 in
     a thread over a flagship `AppBackend` (random bf16 weights from the
     seed, 20 steps, ensemble 5): the page; a decompose of a 512^2 PNG of
     phase 6's first scene collated alone, with a box prompt around its
     mask, answered with 6 uint8 512^2 maps and the same bits on a
     repeat; a relight under a seeded latlong PNG; a request with no image
     answered with a JSON 500 naming it (any other status of a request
     fails the phase); each served request's K1/K2 launches equal to
     `pipelines.KernelCalls`'s, every call checked in phase 2 (its new
     shapes run there after every earlier case), its cold and warm wall,
     the device time of the same backend call (profiler) and its peak
     memory; `python -m unirenderer_tpu_torch.eval.run_inverse` as a
     subprocess at flagship size with --box and a .hdr from `write_hdr`:
     exit 0 and 8 folders (7 maps and relit); `http_app.build_backend(
     "medium", ...)` answering one decompose (K2 at head dims 24, 48, 96);
     phase 6's first mesh and texture written as an OBJ + MTL + PNG, the
     native scanner's arrays bit-equal to the numpy parser's, collated
     from two cameras with `Material.from_mtl`'s texture: K4 at that shape
     bit-equal to its plain version, one launch in the collate; LPIPS and
     FID (seeded random backbones) of phase 7's 32 held-out forward images
     on the card in f32 (TF32 off) within 1e-3 relative of the CPU's
     (regenerated when phase 7 did not run); Pillow's version
 14  `parallel/mesh.py`, the SD weight port and introspection: (a) an NCCL
     group of one rank (TCP store on 127.0.0.1): 4 flagship train steps
     (batch 2, bf16, remat, AdamW) unwrapped, then under `make_sharded_train_step` (DP), DP with FSDP
     and `make_tp_train_step` on a (1, 1) mesh with FSDP (a model axis of
     one rank wraps no linear: FSDP under the TP plan), from the same
     weights, batches and draws: each step's loss and gradient norm within
     1e-3 relative of the unwrapped step's (a forward and an inverse step,
     each from the initial weights), K1 / K2 / K2 bwd launches equal to
     `train_step_launches` at every step, cold and warm wall (2 more
     rounds) and peak memory; then the unwrapped step, FSDP and TP+FSDP
     with Adafactor, each against the unwrapped Adafactor step: loss and
     norm as above, the masters after the two compared steps within 1e-3
     relative (norms, tensor by tensor, for every variant), Adafactor's
     statistics' agreement printed, one line of the peaks of AdamW,
     Adafactor, FSDP+AdamW and FSDP+Adafactor; (b) two
     processes on the one card through gloo (NCCL will not put two ranks
     on one device), small() r05 weights: a DP step over a global batch of
     4 against one process's step on it, loss within 1e-3 relative and
     gradient cosine >= 0.999; then a Trainer with FSDP and Adafactor
     over the two ranks: its step's loss within 1e-3 of one process's, and
     its sharded optimizer fed rank 0's single-process gradients of two
     steps against one process's Adafactor fed the same, every master
     (relative to its update) and statistic within 1e-3; (c) random
     SD-v1.4-shaped diffusers state
     dicts for the UNet, VAE and CLIP text encoder (keys from the port's
     path maps over its flagship modules) written as fp16 .bin files,
     `port_sd_checkpoint` on the card with fast_init on and off (seconds
     of each): every mapped tensor equal to the file's, the inflated convs
     the tiled kernels x 0.142, the zero convs zero, both inits the same
     bits; then `python -m unirenderer_tpu_torch.train --sd-* --synthetic
     --steps 2` (flagship, Adafactor: a smaller checkpoint) as a
     subprocess: exit 0, a checkpoint, finite losses; the files deleted;
     (d) one small() UNet-stream forward (r05 weights, seeded input, the
     attribute encoder's f32 residuals) captured by
     `models/introspect.capture_activations` as bf16 on the card, bf16 on
     the CPU and f32 on the CPU: the same scopes, finite values; the 10
     worst scopes of card-bf16 against CPU-bf16 and of CPU-bf16 against
     CPU-f32, and the first scope in forward order past 2^-7 relative
 15  f32 on the card (TF32 off): (a) the f32 forms of K1, K2 (with its
     log-sum-exp), K2s, K3 (both running-max settings) and K2 bwd against
     their plain versions in f32 at every K1 / K2 signature of small()'s
     paths in this phase, the flagship headline shapes and ragged ones:
     K1 within 2^-16 * max|plain| and a rerun bit-equal, K2 / K2s / K3
     2^-14 and a rerun bit-equal, K2's log-sum-exp 2^-16 absolute, K2
     bwd's dQ, dK, dV 2^-12 and a rerun bit-equal; times against the f32
     bounds (bytes; the f32-accurate products at the lesser of f32 FMAs
     at 67 TFLOP/s and three TF32 passes at 495 / 3, both printed; one
     exp a score forward), the plain version and one library call in
     f32; K1's f32 launch plans (x kept in shared
     memory or re-read) at every small(), medium() and flagship signature;
     (b) the trained small() weights in f32, card against CPU: one forward
     and one inverse model evaluation within 1e-4 * max|ref|, a 20-step
     forward render from the same noise within 1e-3, and the splash and
     unet_flash routes (K2s / K3 in f32, launches from the config) within
     1e-3 of the default route's render; phase 4's bf16 figures beside;
     (c) the held-out harness in f32 (forward PSNR, inverse at ensemble 1;
     phase 7's margins, phase 7's bf16 figures beside), every K1 / K2 call
     checked in (a); (d) one small() train step in f32 through
     `train/compare.py`, card against CPU, each branch: loss within 1e-4
     relative, gradient cosine >= 0.99999, norm within 1e-4, the cosines by
     stream x attention / norm / other, phase 9's bf16 figures beside; (e)
     `eval/vae_recon` in f32 on the held-out set (n=32, vae_small.npz): the
     six PSNRs and their mean; on 4 objects the card's PSNRs within 0.01 dB
     of the CPU's from the same images and posterior draw; (f) `python -m
     unirenderer_tpu_torch.train` and `.train.vae` at small() with no type
     given, 2 synthetic steps each: f32, finite losses, the f32 kernels
     launched (the counts the CLIs print)
 16  the user's data path: (a) 4 deformed spheres (T 32400) written as OBJ
     + MTL + PNG and 2 seeded 1024x512 latlong HDRs through `python -m
     unirenderer_tpu_torch.data.obj2mesh --workers 8` and `.light2map`
     (512 / 16 / 256) on the card, two processes side by side: every mesh
     npz array-equal to an in-process `load_obj`, 6 specular levels and a
     diffuse map an env, finite; seconds per env and peak memory;
     light2map on the card against the CPU at --res 64 --samples 64 (every
     texel within 1e-5 * max|CPU| but at most 4 a level, on cube seams,
     within 2e-2) and a constant HDR giving constant maps; (b) `python -m
     unirenderer_tpu_torch.eval.quality --config flagship --mesh-dir ...
     --env-dir ... --n 4 --steps 20 --out ...` (random bf16 weights, one
     batch, forward and inverse at ensemble 1): the JAX report's keys,
     finite, `checkpoint_loaded` false, the K1 / K2 launches it prints
     equal to `pipelines.KernelCalls`, K4 once; then the same batch in
     this process, cold and warm (walls, peak memory, launches, every
     shape checked in phase 2) and profiled (device busy); (c) phase 15
     (f)'s small() train-CLI checkpoint (or one made the same way) through
     `core.export_params` in float32 and float16, `eval.quality --config
     small --n 4 --steps 4` with `--ckpt` the directory and the f32 npz
     giving equal reports, the f16 npz read by `load_params_npz` (the f32
     masters rounded) and by eval.quality's loader

Any failure exits non-zero.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}, after
a line {"kernels": [...]}.  --out DIR also writes every measured case to
DIR/chip_smoke.json; --profile adds a torch.profiler breakdown by kernel
class of one flagship forward request (phase 3), one flagship inverse
request and one forward request under each of the default and unet_flash
routes (phase 8), and one warm flagship inverse train step (phase 10).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
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
TF32_FLOPS = 495e12              # H100 SXM dense TF32 tensor cores
MUFU_EXP2_PER_CLOCK = 16         # exp2 results per clock per SM (sm_90)
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
# K2's log-sum-exp vs the plain f32 one of its bf16 inputs, absolute (K2
# takes the f32 scores of its bf16 inputs, scaled in f32)
LSE_ABS = 2.0 ** -14
K2_FRESH_DRAWS = 8               # K2 at (2,4096,8,40), each within CARD_REL
TRAIN_LOSS_REL = 0.01            # small() train step, card bf16 vs CPU f32:
TRAIN_GRAD_COS = 0.999           # loss, gradient cosine and norm ratio
TRAIN_NORM_REL = 0.01
ALL_PHASES = "0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16"
MODES_BATCH = 2                  # phase 11's requests (legacy, relight: 1)
REUSE = (1, 2, 3)                # encoder_reuse values of phase 11
REUSE_ROUNDS = 3                 # warm requests of each, in turns
REUSE_MEAN_ABS = 1.0             # reuse vs exact image, mean |diff| (JAX test)
GUIDANCE = 3.0                   # phase 11's guidance scale
LEGACY = ("legacy16", "legacy12")
RELIGHT_ENV = dict(env_res=128, env_samples=64)
# the JAX package's held-out forward PSNR by encoder_reuse (small() r05, 32
# objects, 20 steps), written by tools/encoder_reuse_reference_r05.py
REUSE_REFERENCE = "artifacts/r05/encoder_reuse_small.json"
PAD_CYCLES = 1_000_000           # ~0.5 ms of spin before each timed launch
GN_HEADLINE = ((2, 64, 64, 320), 32, 1e-5, True)   # K1's headline call
TRAIN_VARIANT_REL = 1e-3         # render-in-step, two-phase, resume: loss
VALIDATION_PSNR_ABS = 1e-3       # validation vs the harness's maps, dB
VAE_BATCH = 1                    # scenes (x 8 maps) per VAE step, phase 12
APP_ENSEMBLE = 5                 # the served decompose's ensemble, phase 13
PERCEPTUAL_REL = 1e-3            # LPIPS / FID, card f32 against the CPU


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


def gn_case(torch, F, timer, gen, case, param_dtype="bfloat16"):
    """K1 at one call signature with scale and bias in `param_dtype` (the
    model's modules pass bf16; the trainer's f32 path and the CPU pass
    f32): error against the plain version on the same inputs, a second run
    that must give the same bits, and the times."""
    from unirenderer_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu, groupnorm_silu_reference,
    )
    shape, groups, eps, silu = case
    c = shape[-1]
    pdt = getattr(torch, param_dtype)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5
         ).bfloat16()
    scale = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
             ).to(pdt)
    bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(pdt)
    y = fused_groupnorm_silu(x, scale, bias, groups, eps, silu)
    again = fused_groupnorm_silu(x, scale, bias, groups, eps, silu)
    torch.cuda.synchronize()          # a fault here is the kernel's
    ref = groupnorm_silu_reference(x.float(), scale, bias, groups, eps, silu)
    torch.cuda.synchronize()
    err = (y.float() - ref).abs().max().item()
    tol = CARD_REL * ref.abs().max().item()
    rerun_equal = bool(torch.equal(y, again))
    del ref, y, again
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
    bound_ms = ((2 * nbytes + 2 * c * scale.element_size())
                / HBM_BYTES_PER_S * 1e3)
    return dict(kernel="groupnorm_silu", shape=list(shape), groups=groups,
                eps=eps, silu=silu, param_dtype=param_dtype,
                rerun_bit_identical=rerun_equal,
                ok=err <= tol and rerun_equal, max_abs_err=err, tol=tol,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes",
                three_pass_floor_ms=3 * nbytes / HBM_BYTES_PER_S * 1e3)


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm, in MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0]) * 1e6


def exp2_rate(torch) -> float:
    """exp2 results a second: 16 a clock per SM on the special-function
    unit (the CUDA programming guide's throughput table for compute
    capability 9.0), times the SMs, at the highest SM clock."""
    if not hasattr(exp2_rate, "value"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        exp2_rate.value = MUFU_EXP2_PER_CLOCK * sms * max_sm_clock_hz()
    return exp2_rate.value


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
    torch.cuda.synchronize()          # a fault here is the kernel's
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
    parts = {"operations": 4.0 * b * h * sq * sk * d / BF16_FLOPS * 1e3,
             "bytes": 2.0 * (2 * q.numel() + 2 * k.numel())
             / HBM_BYTES_PER_S * 1e3,
             # one exp2 a score on the special-function unit
             "exp2": b * h * sq * sk / exp2_rate(torch) * 1e3}
    bound_by = max(parts, key=parts.get)
    return dict(kernel=kernel, shape=[list(qs), list(ks)], options=options,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=parts[bound_by],
                bound_by=bound_by, bound_parts=parts)


def attn_bwd_case(torch, F, timer, gen, case):
    """K2 bwd at (q shape, k shape): dQ, dK, dV against the plain backward
    on the same bf16 inputs, O and log-sum-exp from the K2 forward (whose
    log-sum-exp is held against the plain f32 one of its bf16 inputs, and
    whose output must be the serving launch's, bit for bit); the times."""
    from unirenderer_tpu_torch.ops.flash_attention import (
        attention_backward_reference, attention_lse_reference,
        flash_attention, flash_attention_backward, flash_attention_with_lse,
    )
    qs, ks = case
    q = torch.randn(qs, generator=gen, device="cuda").bfloat16()
    k = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    v = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    do = torch.randn(qs, generator=gen, device="cuda").bfloat16()
    o, lse = flash_attention_with_lse(q, k, v)
    same_o = bool(torch.equal(o, flash_attention(q, k, v)))
    lse_err = (lse - attention_lse_reference(q, k, v)[1]).abs().max().item()
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
                lse_tol=LSE_ABS, rerun_diff=rerun,
                forward_bit_identical=same_o, ok=ok,
                max_abs_err=max(e for e, _ in errs.values()),
                tol=min(t for _, t in errs.values()), ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes")


def k2_fresh_draws(torch, draws=K2_FRESH_DRAWS):
    """K2 at (2,4096,8,40) on `draws` fresh draws from a generator of
    their own (no phase-2 case's inputs move) -> each draw's err / tol
    against the plain version, gated at 1.  Before K2 scaled its f32
    scores (as JAX does) it staged bf16(q * scale * log2 e), and its error
    crossed the gate on about one draw in four."""
    from unirenderer_tpu_torch.ops.flash_attention import (
        attention_reference, flash_attention,
    )
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ratios = []
    for _ in range(draws):
        q, k, v = (torch.randn((2, 4096, 8, 40), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        ref = attention_reference(q, k, v, out_dtype=torch.float32)
        err = (flash_attention(q, k, v).float() - ref).abs().max().item()
        ratios.append(err / (CARD_REL * ref.abs().max().item()))
    return ratios


def wrapper_host_us(torch, calls=200):
    """Host time a call of the K2 and K3 wrappers at (2,1024,8,80), in us:
    `calls` back-to-back calls timed on the host clock without a sync (the
    card runs each faster than the host enqueues it).  K3 encodes its two
    tensor maps on every call; K2 has none to encode."""
    from unirenderer_tpu_torch.ops.attn_kernel import unet_flash_attention
    from unirenderer_tpu_torch.ops.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = (torch.randn((2, 1024, 8, 80), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    out = {}
    for name, fn in (("flash_attention", flash_attention),
                     ("attn_kernel", unet_flash_attention)):
        fn(q, k, v)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn(q, k, v)
        out[name] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    return out


def case_ok(r) -> bool:
    return r["ok"] if "ok" in r else r["max_abs_err"] <= r["tol"]


def phase_kernels(torch, F, timer, gn_cases, attn_cases, route_cases,
                  bwd_cases, later_route_cases, later_gn_cases,
                  modes_gn_cases=(), modes_attn_cases=(), vae_gn_cases=(),
                  apps_gn_cases=(), apps_attn_cases=(), user_gn_cases=(),
                  user_attn_cases=()):
    """`gn_cases`, `later_gn_cases`, `modes_gn_cases`: (call signature,
    parameter type) of K1; `attn_cases`, `modes_attn_cases`: (q shape, k
    shape) of K2; `route_cases`, `later_route_cases`: (kernel name, case,
    options) of the two routes; `bwd_cases`: (q shape, k shape) of K2 bwd.
    All draw their inputs from one seeded generator in this order; the
    `later_` and then the `modes_` cases (phase 11's shapes), added after
    the others, run last, so that each earlier case keeps the inputs it
    had before they were added; the `vae_` cases (phase 12's VAE training
    shapes) after those, then the `apps_` cases (phase 13's), then the
    `user_` cases (phase 16's)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def gn_job(c, p):
        return (f"groupnorm_silu {c} params {p}",
                lambda: gn_case(torch, F, timer, gen, c, p))

    def route_job(n, c, o):
        return (f"{n} {c} {o}",
                lambda: attn_case(torch, F, timer, gen, c, n, **o))

    jobs = ([gn_job(c, p) for c, p in gn_cases]
            + [route_job("flash_attention", c, {}) for c in attn_cases]
            + [route_job(n, c, o) for n, c, o in route_cases]
            + [(f"flash_attention_backward {c}",
                lambda c=c: attn_bwd_case(torch, F, timer, gen, c))
               for c in bwd_cases]
            + [route_job(n, c, o) for n, c, o in later_route_cases]
            + [gn_job(c, p) for c, p in later_gn_cases]
            + [gn_job(c, p) for c, p in modes_gn_cases]
            + [route_job("flash_attention", c, {})
               for c in modes_attn_cases]
            + [gn_job(c, p) for c, p in vae_gn_cases]
            + [gn_job(c, p) for c, p in apps_gn_cases]
            + [route_job("flash_attention", c, {})
               for c in apps_attn_cases]
            + [gn_job(c, p) for c, p in user_gn_cases]
            + [route_job("flash_attention", c, {})
               for c in user_attn_cases])
    # what the timer reads for the least device work: a one-element fill
    one = torch.empty(1, device="cuda")
    floor_ms = timer(lambda: one.fill_(1.0))
    log(f"  timer floor (one-element fill): {floor_ms:.4f} ms")
    results = [dict(kernel="timer_floor", ms=floor_ms, ok=True)]
    for desc, job in jobs:
        try:
            r = job()
        except Exception:
            # name the case a device fault or a refusal came from
            log(f"  raised while running {desc}")
            raise
        results.append(r)
        ok = case_ok(r)
        log(f"  {r['kernel']:16s} {json.dumps(r['shape'])} "
            + (f"g={r['groups']} eps={r['eps']:g} silu={int(r['silu'])} "
               f"params {r['param_dtype']} rerun bit-identical "
               f"{int(r['rerun_bit_identical'])} "
               if "groups" in r else "")
            + (f"{r['options']} " if r.get("options") else "")
            + (" ".join(f"{n} {e:.3g}/{t:.3g}"
                        for n, (e, t) in r["errs"].items())
               + f" lse {r['lse_err']:.3g}/{r['lse_tol']:.3g} bit-identical "
               f"fwd {int(r['forward_bit_identical'])} rerun diff "
               f"{r['rerun_diff']:.3g}/{r['tol']:.3g} "
               if "errs" in r else "")
            + f"err={r['max_abs_err']:.3g} tol={r['tol']:.3g} "
            f"{'ok' if ok else 'FAIL'}  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f}  library {r['library_ms']:.4f}  "
            + (f"ratio {r['ms'] / r['library_ms']:.2f}  "
               if r.get("library_ms") else "")
            + f"bound {r['bound_ms']:.4f} ({r['bound_by']}"
            + ("".join(f"; {k} {v:.4f}" for k, v in r["bound_parts"].items())
               if "bound_parts" in r else "") + ")")
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
        for extra in ("launches_f32", "launches_cluster"):
            if hasattr(w, extra):
                setattr(w, extra, 0)
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
        prof = profile_request(
            torch, lambda: pipe.mask2image_3mod_albedo(**req, generator=gen))
        result["profile"] = prof
        # K1 is one device kernel a call: no statistics or finalize
        # kernels, no casts of its parameters
        k1 = prof["count_by_class"].get("K1 groupnorm_silu", 0)
        log(f"  K1 device kernels in the profiled request: {k1}, wrapper "
            f"calls per request: {launches['groupnorm_silu']}")
        check(k1 == launches["groupnorm_silu"],
              f"{k1} K1 device kernels for {launches['groupnorm_silu']} "
              f"calls")
    torch.cuda.empty_cache()
    return result


KERNEL_CLASSES = (          # (class, substrings of a device kernel's name)
    ("K1 groupnorm_silu", ("gn_fused_kernel",)),
    ("K2 flash_attention", ("flash_fwd_kernel",)),
    ("K2 bwd flash_attention_backward", ("bwd_prep_kernel", "bwd_kernel<",
                                         "dq_convert_kernel")),
    ("K2s splash_attention", ("splash_fwd_kernel",)),
    ("K3 attn_kernel", ("unet_flash_kernel",)),
    ("convolution", ("fprop", "convolve", "implicit_gemm", "winograd")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
    ("normalisation (LayerNorm)", ("layer_norm",)),
    ("K4 rasterize", ("rast_setup_count_kernel", "rast_scan_kernel",
                      "rast_fill_kernel", "rast_raster_kernel")),
    ("softmax", ("softmax",)),
)


def profiled(torch, fn):
    """torch.profiler (host and device) over one synced fn() -> (the
    session's device events, fn's wall in ms).  After an earlier session in
    the same process a session has lost the device events at its very
    start (seen on the H100: the first 4 of K4's 5 operations, a few
    elementwise kernels of a request), so spin kernels and a pause come
    first; their events are dropped."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.cuda._sleep(PAD_CYCLES // 100)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and "spin_kernel" not in e.key]
    return events, wall_ms


def profile_request(torch, request):
    """Device time by kernel class over one full request (torch.profiler,
    device kernels only), against the wall of the profiled call."""
    events, wall_ms = profiled(torch, request)
    # device kernels only: a user annotation (the optimizer's
    # "Optimizer.step#AdamW.step") spans kernels that are counted already
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in events
               if not getattr(e, "is_user_annotation", False)]
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    by_class, count_by_class = {}, {}
    for ms, n, key in kernels:
        cls = next((c for c, subs in KERNEL_CLASSES
                    if any(x in key for x in subs)), "elementwise / copy")
        by_class[cls] = by_class.get(cls, 0.0) + ms
        count_by_class[cls] = count_by_class.get(cls, 0) + n
    syncs = sum(e.count for e in events if "DtoH" in e.key)
    log(f"  profile of one request batch: wall {wall_ms:.1f} ms (profiler "
        f"on), device busy {busy:.1f} ms, idle {100 * (1 - busy / wall_ms):.1f}%"
        f", device-to-host copies {syncs}")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% "
            f"{count_by_class[cls]:6d}x  {cls}")
    for ms, n, key in kernels[:15]:
        log(f"    {ms:9.3f} ms {n:6d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy, by_class=by_class,
                count_by_class=count_by_class,
                device_kernels=sum(n for _, n, _ in kernels),
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


def small_pipes(torch, dtype):
    """The repo's trained small() weights through the flax converter, on
    the card in `dtype` and on the CPU in f32 (plain versions) -> (card,
    host, keys loaded on the card, keys in the files)."""
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
        dtype=dtype)
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
    return card, host, loaded, n_keys


def small_model_evals(torch, cfg, pipes, g):
    """One forward (image stream with the attribute encoder's residuals)
    and one inverse (attribute streams on the UNet's taps) model
    evaluation at batch 2 on each pipeline, from inputs drawn from the CPU
    generator `g` -> {"forward": [out per pipe], "inverse": [...]}, on the
    host."""
    u, s, b = cfg.unet, cfg.unet.sample_size, 2
    img = torch.randn((b, s, s, u.in_channels), generator=g)
    attr = torch.randn((b, s, s, u.attr_channels), generator=g)
    ctx = torch.randn((b, cfg.text.max_length, u.cross_attention_dim),
                      generator=g)
    t_img = torch.tensor([999, 400])
    out = {"forward": [], "inverse": []}
    for pipe in pipes:
        dev = pipe.device
        zero = torch.zeros(b, dtype=torch.long, device=dev)
        with torch.no_grad():
            down, mid = pipe.dual.encode_attr(attr.to(dev), zero,
                                              ctx.to(dev))
            out["forward"].append(pipe.dual.image_stream_with_residuals(
                img.to(dev), t_img.to(dev), ctx.to(dev), down, mid).cpu())
            down, mid = pipe.dual.unet_raw_taps(img.to(dev), zero,
                                                ctx.to(dev))
            out["inverse"].append(pipe.dual.attr_streams_with_unet_taps(
                attr.to(dev), t_img.to(dev), ctx.to(dev), down, mid).cpu())
    return out


def phase_small_weights(torch, F):
    from unirenderer_tpu_torch.core import config
    cfg = config.small()
    card, host, loaded, n_keys = small_pipes(torch, torch.bfloat16)

    # one forward and one inverse model evaluation, card bf16 against host
    # f32 plain versions
    g = torch.Generator().manual_seed(SEED)
    b = 2
    result = dict(loaded_keys=loaded, file_keys=n_keys)
    evals = small_model_evals(torch, cfg, (card, host), g)
    for what, (got, want) in evals.items():
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
    """Least time for the work: the clip positions and triangles in and the
    outputs out (16 B a pixel; prev_z in, 4 B) at the HBM rate, or the edge
    tests of this input (each live triangle at every pixel centre its
    screen box holds, the pixels the raster tests it at; 12 f32 operations
    each) at the f32 rate, whichever is larger."""
    from unirenderer_tpu_torch.ops.rasterize import _setup, pixel_ranges
    _, box = _setup(pos, tri, h, w)
    xl, xh, yl, yh, live = pixel_ranges(box, h, w)
    tests = float(torch.where(live, (xh - xl + 1) * (yh - yl + 1),
                              0.0).sum().item())
    nb = tri.shape[0]
    nbytes = (pos.numel() * pos.element_size()
              + tri.numel() * tri.element_size()
              + nb * h * w * (16 + (4 if peel else 0)))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = tests * RAST_TEST_FLOPS / FP32_FLOPS * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else
            "operations", tests)


def rast_case(torch, timer, name, pos, tri, h, w, prev_z=None):
    from unirenderer_tpu_torch.ops.rasterize import (
        match_stats, rasterize, rasterize_reference, within_rule,
    )
    got = rasterize(pos, tri, h, w, prev_z=prev_z)
    torch.cuda.synchronize()          # a fault here is the kernel's
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
                peel=prev_z is not None,
                ok=within_rule(stats) and stats["bit_equal"], **stats,
                max_abs_err=max(stats["z_err"], stats["uv_err"]),
                coverage=hits, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, edge_tests=tests, library_ms=None)


def rast_setup_and_bins(torch, pos, tri, h, w):
    """The set-up kernel's records and boxes against `_setup`, bit for bit
    (as int32 views), and the kernels' tile lists against
    `rast_bins_reference` (each list sorted: the fill's atomics order it),
    on one call's workspace."""
    from unirenderer_tpu_torch.ops.rasterize import (
        TILE, _setup, rast_bins_reference, rasterize_with_bins,
    )
    _, rec, box, bins = rasterize_with_bins(pos, tri, h, w)
    torch.cuda.synchronize()
    want_rec, want_box = _setup(pos, tri, h, w)
    want = rast_bins_reference(want_box, h, w)
    n_tiles = -(-w // TILE) * -(-h // TILE)
    # each slot's tile, then (tile, triangle) keys in order
    slot_tile = torch.searchsorted(
        bins.start[1:].long(),
        torch.arange(bins.pairs.numel(), device=pos.device), right=True)
    key = torch.sort(slot_tile * tri.shape[1] + bins.pairs.long()).values
    want_slot = torch.searchsorted(
        want.start[1:].long(),
        torch.arange(want.pairs.numel(), device=pos.device), right=True)
    want_key = want_slot * tri.shape[1] + want.pairs.long()
    wide_equal = torch.equal(bins.wide_count, want.wide_count) and all(
        torch.equal(torch.sort(bins.wide[b, :int(n)]).values,
                    want.wide[b, :int(n)])
        for b, n in enumerate(want.wide_count.tolist()))
    out = dict(
        records_bit_equal=bool(torch.equal(rec.view(torch.int32),
                                           want_rec.view(torch.int32))),
        boxes_bit_equal=bool(torch.equal(box.view(torch.int32),
                                         want_box.view(torch.int32))),
        starts_equal=bool(torch.equal(bins.start, want.start)),
        lists_equal=bool(torch.equal(key, want_key)) and wide_equal,
        pairs=int(bins.pairs.numel()), wide=want.wide_count.tolist(),
        tiles=n_tiles * tri.shape[0],
        live=int((want_rec[..., 9] != 0).sum().item()))
    out["ok"] = all(out[k] for k in ("records_bit_equal", "boxes_bit_equal",
                                     "starts_equal", "lists_equal"))
    return out


def rast_device_kernels(torch, pos, tri, h, w):
    """(name, count, device ms) of every device operation one wrapper
    call runs (torch.profiler: kernels and the memset)."""
    from unirenderer_tpu_torch.ops.rasterize import rasterize
    rasterize(pos, tri, h, w)
    events, _ = profiled(torch, lambda: rasterize(pos, tri, h, w))
    return [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in events]


def rast_signatures(cfg):
    """The rasterizer calls phase 5 checks, in the form the wrapper records
    in `.seen`: the flagship collate's (plain and peeled), phase 16's
    flagship collate of USER_MESHES views and small()'s."""
    from unirenderer_tpu_torch.core import config
    out = set()
    for d, views, peels in ((cfg.data, 2, (False, True)),
                            (cfg.data, USER_MESHES, (False,)),
                            (config.small().data, 2, (False,))):
        res = d.resolution * d.ssaa
        for peel in peels:
            out.add(((views, d.v_pad, 4), (views, d.t_pad, 3), res, res,
                     peel))
    return out


def full_screen_and_degenerate(torch, pos, tri):
    """Two views of the flagship's shape: a triangle over the whole screen
    (wide: in every tile's walk) in front of the first view's spheres,
    and a mesh of degenerate, behind-the-eye and padding triangles only."""
    big = torch.tensor([[-1.0, -1.0, -0.5, 1.0], [3.0, -1.0, -0.5, 1.0],
                        [-1.0, 3.0, -0.5, 1.0]], device=pos.device)
    n_v = pos.shape[1]
    full_pos = pos[:1].clone()
    full_pos[0, n_v - 3:] = big
    full_tri = tri[:1].clone()
    full_tri[0, -1] = torch.tensor([n_v - 3, n_v - 2, n_v - 1])
    degen_tri = tri[:1].clone()
    degen_tri[0, :, 1] = degen_tri[0, :, 0]        # every index repeated
    degen_pos = pos[:1].clone()
    degen_pos[0, :, 3] = -degen_pos[0, :, 3].abs()  # and behind the eye
    return (full_pos, full_tri), (degen_pos.contiguous(),
                                  degen_tri.contiguous())


def phase_rasterize(torch, cfg, timer):
    """K4 at the flagship collate's shape, phase 16's flagship collate of
    USER_MESHES views, the small() collate's shape, a peel layer, a ragged
    size, a full-screen triangle and an all-degenerate mesh; the set-up and
    the tile lists at the flagship collate; device kernels a call."""
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
    pos_u, tri_u = deformed_spheres(torch, USER_MESHES, USER_SPHERE_RES,
                                    d.v_pad, d.t_pad, SEED + 2)
    cases.append(rast_case(torch, timer, "flagship user", pos_u, tri_u,
                           flag, flag))
    cases.append(rast_case(torch, timer, "ragged", pos[:1], tri[:1], 1000,
                           744))
    pos_s, tri_s = deformed_spheres(torch, 2, 32, s.v_pad, s.t_pad, SEED + 1)
    cases.append(rast_case(torch, timer, "small collate", pos_s, tri_s,
                           small, small))
    (fp, ft), (dp, dt) = full_screen_and_degenerate(torch, pos, tri)
    cases.append(rast_case(torch, timer, "full screen", fp, ft, flag, flag))
    cases.append(rast_case(torch, timer, "all degenerate", dp, dt, flag,
                           flag))
    for r in cases:
        log(f"  rasterize {r['case']:16s} {json.dumps(r['shape'])} "
            f"coverage {r['coverage']:.3f}: cover diff "
            f"{r['coverage_mismatch']} z err {r['z_err']:.2g} id diff "
            f"{100 * r['id_mismatch']:.3f}% uv err {r['uv_err']:.2g} "
            f"bit-equal {int(r['bit_equal'])} "
            f"{'ok' if r['ok'] else 'FAIL'}  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}; {r['edge_tests']:.3g} edge tests)")
    check(cases[-2]["coverage"] == 1.0, "the full-screen triangle left a "
          "pixel uncovered")
    check(cases[-1]["coverage"] == 0.0, "a degenerate triangle covered a "
          "pixel")
    setup = rast_setup_and_bins(torch, pos, tri, flag, flag)
    setup_u = rast_setup_and_bins(torch, pos_u, tri_u, flag, flag)
    del pos_u, tri_u
    for what, st in (("flagship collate", setup),
                     (f"{USER_MESHES}-view flagship collate", setup_u)):
        log(f"  set-up kernel at the {what}: records bit-equal "
            f"{int(st['records_bit_equal'])}, boxes bit-equal "
            f"{int(st['boxes_bit_equal'])}, list offsets equal "
            f"{int(st['starts_equal'])}, tile lists equal "
            f"{int(st['lists_equal'])}: {st['live']} live triangles, "
            f"{st['pairs']} (triangle, tile) pairs over {st['tiles']} "
            f"tiles, wide {st['wide']}")
    kernels = rast_device_kernels(torch, pos, tri, flag, flag)
    n_ops = sum(c for _, c, _ in kernels)
    log(f"  device operations a call: {n_ops} ("
        + ", ".join(f"{k[:48]} x{c} {ms:.4f} ms" for k, c, ms in kernels)
        + "; profiler, no L2 flush)")
    for r in cases:
        r["device_ops_per_call"] = n_ops
    cases[0]["setup"] = setup
    cases[2]["setup"] = setup_u
    cases[0]["device_ops"] = kernels
    torch.cuda.empty_cache()
    bad = [r["case"] for r in cases if not r["ok"]]
    check(not bad, f"rasterize cases outside the rule or not bit-equal: "
          f"{bad}")
    for st in (setup, setup_u):
        check(st["ok"], f"the set-up kernel or its tile lists differ: {st}")
    check(n_ops <= 5 and sum(c for k, c, _ in kernels if "rast_" in k) == 4,
          f"rasterize ran {n_ops} device operations a call, not its memset "
          f"and 4 kernels: {kernels}")
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
    from unirenderer_tpu_torch.data.objaverse import collate_render
    events, wall_ms = profiled(
        torch, lambda: collate_render(items, resolution=d.resolution,
                                      ssaa=d.ssaa, device="cuda"))
    kernels = [(e.self_device_time_total / 1e3, e.key) for e in events]
    busy = sum(ms for ms, _ in kernels)
    k4 = sum(ms for ms, key in kernels if "rast_" in key and "_kernel" in key)
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


def phase_held_out(torch, ensembles=(1, 5), dtype_name="bfloat16"):
    """The harness on the card computing in `dtype_name` -> (the scores,
    the first leg's held-out (gt, forward) images, which phase 13 scores
    with LPIPS and FID)."""
    from unirenderer_tpu_torch.eval.quality import (
        held_out_scores, small_trained_pipeline,
    )
    t = time.perf_counter()
    pipe = small_trained_pipeline("cuda", getattr(torch, dtype_name))
    out, images = {}, None
    for e in ensembles:
        r = held_out_scores(pipe, n=32, num_steps=20, noise_seeds=(1000,),
                            inverse=True, ensemble=e,
                            log=lambda msg: log(f"  {msg}"),
                            keep_images=images is None)
        if images is None:
            images = r["runs"][0].pop("images")
        out[f"ensemble_{e}"] = r
        value, inv, ref = (r["psnr_forward_render"], r["inverse"],
                           INVERSE_REFERENCE[e])
        log(f"  held-out forward PSNR {value:.3f} dB (n=32, 20 steps, "
            f"{dtype_name} on the card) beside QUALITY_r05_fixed's "
            f"{PSNR_REFERENCE:.2f} dB; set generated in "
            f"{r['generate_seconds']:.1f} s")
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
    return out, images


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
    if profile:
        # K3's share of a warm unet_flash request, and one device kernel a
        # K3 call: the request launches as many device kernels as the
        # default route's, where each of these calls is one K2 kernel (no
        # elementwise pre-scale of Q beside K3)
        counts = {}
        for route in ("auto", "unet_flash"):
            os.environ["UNIRENDER_ATTN"] = route
            try:
                log(f"  profile of the warm forward request under "
                    f"UNIRENDER_ATTN={route}:")
                prof = profile_request(
                    torch, lambda: pipe.mask2image_3mod_albedo(
                        **fwd, generator=torch.Generator(
                            device="cuda").manual_seed(SEED)))
            finally:
                del os.environ["UNIRENDER_ATTN"]
            result[f"route_{route}"]["profile"] = prof
            counts[route] = prof["device_kernels"]
        k3 = result["route_unet_flash"]["profile"]["count_by_class"].get(
            "K3 attn_kernel", 0)
        log(f"  K3 device kernels {k3} (calls {expected}); device kernels "
            f"per request: {counts['unet_flash']} under unet_flash, "
            f"{counts['auto']} under the default route")
        check(k3 == expected, f"{k3} K3 device kernels for {expected} calls")
        check(counts["unet_flash"] == counts["auto"],
              "the unet_flash request launches kernels beside K3 that the "
              "default route does not")
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
            os.path.join(tr.ckpt.step_dir(2), "params.npz"))
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


PREFETCH_STEPS = 4


def prefetch_overlap(torch, cfg, trainer, items):
    """The training CLI's input against the collate in the loop: blocks
    of PREFETCH_STEPS flagship steps (forward and inverse in turn) over
    `rendered_batches(prefetch=0)` (the collate in the loop) and
    `prefetch=2` (in a thread on a side stream), in the order in-loop,
    prefetch, prefetch, in-loop; each block after one untimed warm step
    on a fresh iterator, its wall from the first fetch to the last
    step's end.  K1/K2/K2 bwd launches (the step's thread only) must
    equal the config's; K4's count also takes in the batches the thread
    collated ahead."""
    from unirenderer_tpu_torch.train.train_step import train_step_launches
    from unirenderer_tpu_torch.train.trainer import rendered_batches
    d = cfg.data
    counted = ("groupnorm_silu", "flash_attention",
               "flash_attention_backward")
    want = {k: sum(train_step_launches(cfg, 2, bool(i % 2))[k]
                   for i in range(PREFETCH_STEPS)) for k in counted}
    out = {0: [], 2: []}
    for depth in (0, 2, 2, 0):
        batches = rendered_batches(items, 2, d.resolution, d.ssaa,
                                   device="cuda", seed=SEED,
                                   prefetch=depth)
        try:
            trainer.step(next(batches), is_inverse=True)
            torch.cuda.synchronize()
            reset_counters()
            t = time.perf_counter()
            losses = [trainer.step(next(batches),
                                   is_inverse=bool(i % 2))["loss"]
                      for i in range(PREFETCH_STEPS)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches, _ = read_counters()
        finally:
            batches.close()
        losses = [float(x) for x in losses]
        check(all(map(math.isfinite, losses)),
              f"non-finite loss over prefetch={depth} batches: {losses}")
        for k in counted:
            check(launches[k] == want[k],
                  f"{k}: {launches[k]} launches in {PREFETCH_STEPS} steps "
                  f"over prefetch={depth} batches, {want[k]} from the "
                  f"config")
        check(launches["rasterize"] >= PREFETCH_STEPS,
              f"K4 launched {launches['rasterize']} times for "
              f"{PREFETCH_STEPS} batches (prefetch={depth})")
        out[depth].append(dict(wall_s=wall, k4=launches["rasterize"],
                               losses=losses))
        log(f"  prefetch={depth}: {PREFETCH_STEPS} steps in {wall:.3f} s "
            f"({wall / PREFETCH_STEPS:.3f} s a step, the fetch included), "
            f"K4 {launches['rasterize']} launches, losses "
            + ", ".join(f"{x:.5g}" for x in losses))
    per_step = {name: [r["wall_s"] / PREFETCH_STEPS for r in out[depth]]
                for name, depth in (("in_loop", 0), ("prefetched", 2))}
    log(f"  s a step over the collate in the loop {per_step['in_loop']}, "
        f"prefetched {per_step['prefetched']}")
    return dict(in_loop=out[0], prefetched=out[2], s_per_step=per_step)


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
        result["prefetch"] = prefetch_overlap(torch, cfg, trainer, items)
        if profile:
            batch = next(batches)
            result["profile"] = profile_request(
                torch, lambda: trainer.step(batch, is_inverse=True))
        del trainer, params, watch
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# Phase 11: the sampling modes
# ---------------------------------------------------------------------------


def counted_run(torch, fn, want, checked, what):
    """fn() with every kernel count set to 0 just before and read just
    after -> (its result, wall s, peak bytes, K1/K2 launches).  The
    launches must equal `want` (`KernelCalls.launches`) and every shape
    must have been checked in phase 2."""
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, seen = read_counters()
    got = {k: launches[k] for k in want}
    check(got == want, f"{what}: launches {got}, the config's {want}")
    for name in want:
        missed = seen[name] - checked[name]
        check(not missed, f"{what}: {name} got calls phase 2 did not check: "
              f"{sorted(missed)[:3]}")
    return out, wall, torch.cuda.max_memory_allocated(), got


def device_busy_ms(torch, fn) -> float:
    """Device time of the kernels of one fn() (torch.profiler)."""
    events, _ = profiled(torch, fn)
    return sum(e.self_device_time_total for e in events
               if not getattr(e, "is_user_annotation", False)) / 1e3


def guided_request(torch, pipe, req, gen, neg_ctx, scale=GUIDANCE):
    """A forward request through `_sample` with classifier-free guidance:
    the maps encoded as `mask2image_3mod_albedo` encodes them (raw material
    latent) -> a function that denoises the image latent at `scale`
    (uncond under `neg_ctx`, or the blank context)."""
    from unirenderer_tpu_torch.pipelines import FORWARD_RENDER
    names = ("normal", "albedo", "spec_light", "diff_light", "env", "mask")
    lat = pipe._latent_shape(req["normal"])
    enc = pipe._randn((len(names) * lat[0],) + lat[1:], gen)
    maps = pipe._encode_maps({n: req[n] for n in names}, enc)
    groups = torch.stack([pipe.material_latent(req["metallic"],
                                               req["roughness"], lat)]
                         + [maps[n] for n in names[:-1]])

    def sample():
        return pipe._sample(FORWARD_RENDER, pipe._randn(lat, gen), groups,
                            maps["mask"], pipe.blank_context(lat[0]),
                            pipe.cfg.sampler.num_steps, scale, neg_ctx)[0]
    return sample


def phase_sampling_modes(torch, F, cfg, checked):
    import dataclasses
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.eval.quality import (
        held_out_scores, small_trained_pipeline,
    )
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    calls = {k: c.launches for k, c in modes_calls(cfg).items()}
    b, res, steps = MODES_BATCH, cfg.vae.sample_size, cfg.sampler.num_steps
    lat = res // cfg.vae.downscale
    pipe, _ = flagship_pipeline(torch, cfg)
    result = {}

    def with_reuse(k):
        return dataclasses.replace(cfg, sampler=dataclasses.replace(
            cfg.sampler, encoder_reuse=k))

    # ---- encoder reuse: the same inputs and noise at k = 1, 2, 3
    req = synthetic_request(torch, F, torch.Generator(
        device="cuda").manual_seed(SEED + 11), b, res)

    def forward():
        return pipe.mask2image_3mod_albedo(
            **req, generator=torch.Generator(device="cuda").manual_seed(
                SEED + 12))
    default = forward()
    images, walls = {}, {k: [] for k in REUSE}
    for k in REUSE:
        pipe.cfg = with_reuse(k)
        images[k], cold, peak, got = counted_run(
            torch, forward, calls[f"reuse_{k}"], checked,
            f"encoder_reuse={k}")
        result[f"reuse_{k}"] = dict(
            cold_wall_s=cold, peak_bytes=peak, launches=got,
            device_busy_ms=device_busy_ms(torch, forward))
    # warm walls in turns (the host's clock moves between requests)
    for _ in range(REUSE_ROUNDS):
        for k in REUSE:
            pipe.cfg = with_reuse(k)
            t = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t)
    for k in REUSE:
        r = result[f"reuse_{k}"]
        r.update(warm_walls_s=walls[k],
                 warm_wall_s=sorted(walls[k])[len(walls[k]) // 2])
        warm, cold, busy = r["warm_wall_s"], r["cold_wall_s"], r[
            "device_busy_ms"]
        peak, got = r["peak_bytes"], r["launches"]
        check(bool(torch.isfinite(images[k]).all()),
              f"encoder_reuse={k}: non-finite image")
        if k == 1:
            check(torch.equal(images[1], default),
                  "encoder_reuse=1 differs from the default request")
        else:
            diff = (images[k] - images[1]).abs()
            r.update(max_abs_diff=diff.max().item(),
                     mean_abs_diff=diff.mean().item())
            check(r["max_abs_diff"] > 0
                  and r["mean_abs_diff"] < REUSE_MEAN_ABS,
                  f"encoder_reuse={k}: mean |diff| {r['mean_abs_diff']:.4g} "
                  f"against the exact image (must be in (0, "
                  f"{REUSE_MEAN_ABS}))")
        log(f"  forward {b} x {steps} steps, encoder_reuse={k}: warm "
            f"{warm:.3f} s (median of "
            f"{' '.join(f'{w:.3f}' for w in walls[k])}; cold {cold:.3f}), "
            f"device busy {busy:.1f} ms, "
            f"peak {peak / 2**30:.2f} GiB, launches {got}"
            + (f", against k=1: max|diff| {r['max_abs_diff']:.4g}, mean "
               f"{r['mean_abs_diff']:.4g}" if k > 1 else
               ", bit-identical to the default request"))
    pipe.cfg = cfg

    # ---- guidance: model at batch 2B, with and without a negative
    # context; the unguided `_sample` of the same inputs beside it
    plain = guided_request(torch, pipe, req, torch.Generator(
        device="cuda").manual_seed(SEED + 13), None, scale=0.0)
    plain()
    unguided = device_busy_ms(torch, plain)
    for negative in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        neg = None
        if negative:
            ctx = pipe.blank_context(b)
            neg = torch.randn(ctx.shape, generator=gen, device="cuda").to(
                ctx.dtype)
        sample = guided_request(torch, pipe, req, gen, neg)
        img_lat, wall, peak, got = counted_run(
            torch, sample, calls["guidance"], checked,
            f"guidance (negative context {negative})")
        image = pipe._vae_decode(img_lat)
        check(bool(torch.isfinite(image).all()) and image.shape == (
            b, res, res, 3), "guided forward: bad image")
        t = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        busy = device_busy_ms(torch, sample)
        log(f"  guided forward (scale {GUIDANCE}, negative context "
            f"{negative}): _sample warm {warm:.3f} s (first call "
            f"{wall:.3f}), device busy {busy:.1f} ms against "
            f"{unguided:.1f} unguided ({busy / unguided:.2f}x), peak "
            f"{peak / 2**30:.2f} GiB, launches {got} (model at batch "
            f"{2 * b})")
        result[f"guidance_negative_{negative}"] = dict(
            wall_s=wall, warm_wall_s=warm, device_busy_ms=busy,
            unguided_device_busy_ms=unguided, peak_bytes=peak, launches=got)

    # ---- joint sampling (the generic branch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    (img_lat, groups), wall, peak, got = counted_run(
        torch, lambda: pipe.joint_sample(batch=b, mask=req["mask"],
                                         generator=gen),
        calls["joint"], checked, "joint_sample")
    check(tuple(img_lat.shape) == (b, lat, lat, 4)
          and tuple(groups.shape) == (6, b, lat, lat, 4)
          and bool(torch.isfinite(img_lat).all())
          and bool(torch.isfinite(groups).all()), "joint_sample: bad latents")
    log(f"  joint_sample {b} x {steps} steps: {wall:.3f} s, peak "
        f"{peak / 2**30:.2f} GiB, launches {got}")
    result["joint"] = dict(wall_s=wall, peak_bytes=peak, launches=got)

    # ---- the inverse branch hoisted and unhoisted, the same noise
    photo = small_inverse_request(torch, F, torch.Generator(
        device="cuda").manual_seed(SEED + 15), b, res)
    outs = {}
    for hoist in (True, False):
        pipe.hoist_invariant = hoist
        outs[hoist], wall, peak, got = counted_run(
            torch, lambda: pipe.real_image2mask_3mod_albedo(
                **photo, ensemble=1, generator=torch.Generator(
                    device="cuda").manual_seed(SEED + 16)),
            calls[f"inverse_hoist_{hoist}"], checked,
            f"inverse, hoist_invariant={hoist}")
        log(f"  inverse {b} x ensemble 1, hoist_invariant={hoist}: "
            f"{wall:.3f} s, peak {peak / 2**30:.2f} GiB, launches {got}")
        result[f"inverse_hoist_{hoist}"] = dict(wall_s=wall,
                                                peak_bytes=peak,
                                                launches=got)
    del pipe.hoist_invariant                  # the class's True again
    worst = 0.0
    for key, ref in outs[True].items():
        got_k = outs[False][key]
        check(bool(torch.isfinite(got_k).all()), f"unhoisted {key} not finite")
        err = (got_k.float() - ref.float()).abs().max().item()
        ratio = err / max(CARD_REL * ref.float().abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"unhoisted inverse {key}: max|diff| {err:.4g} "
              f"above 2^-7 * max|hoisted|")
    log(f"  unhoisted against hoisted: largest max|diff| / (2^-7 max|ref|) "
        f"over the maps {worst:.4g}")
    result["unhoisted_vs_hoisted"] = worst

    # ---- relight: inverse, the new environment's light maps, forward
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    latlong = torch.exp(torch.randn((64, 128, 3), generator=gen,
                                    device="cuda"))
    one = {k: v[:1] for k, v in photo.items()}
    relit, wall, peak, got = counted_run(
        torch, lambda: pipe.relight(**one, new_env=latlong, generator=gen,
                                    ensemble=1, **RELIGHT_ENV),
        calls["relight"], checked, "relight")
    check(tuple(relit.shape) == (1, res, res, 3)
          and bool(torch.isfinite(relit).all()), "relight: bad image")
    log(f"  relight 1 x ensemble 1 (env {RELIGHT_ENV}): {wall:.3f} s, "
        f"peak {peak / 2**30:.2f} GiB, launches {got}")
    result["relight"] = dict(wall_s=wall, peak_bytes=peak, launches=got)
    del pipe
    torch.cuda.empty_cache()

    # ---- the legacy layouts, one model at a time
    for name in LEGACY:
        lcfg = getattr(config, name)()
        legacy = UniRendererPipeline.create(
            lcfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda", dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        attr, wall_i, _, got_i = counted_run(
            torch, lambda: legacy.inverse_rendering(image=photo["image"][:1],
                                                    generator=gen),
            calls[f"{name}_inverse"], checked, f"{name} inverse_rendering")
        g = lcfg.unet.attr_channels // 4
        check(tuple(attr.shape) == (g, 1, lat, lat, 4)
              and bool(torch.isfinite(attr).all()),
              f"{name} inverse_rendering: bad latents")
        image, wall_r, peak, got_r = counted_run(
            torch, lambda: legacy.rendering(attr_latents=attr, generator=gen),
            calls[f"{name}_rendering"], checked, f"{name} rendering")
        check(tuple(image.shape) == (1, res, res, 3)
              and bool(torch.isfinite(image).all()),
              f"{name} rendering: bad image")
        log(f"  {name} ({g} groups): inverse_rendering {wall_i:.3f} s, "
            f"launches {got_i}; rendering {wall_r:.3f} s, launches {got_r}")
        result[name] = dict(inverse_wall_s=wall_i, rendering_wall_s=wall_r,
                            inverse_launches=got_i, rendering_launches=got_r)
        del legacy, attr, image
        torch.cuda.empty_cache()

    # ---- held-out forward PSNR at encoder_reuse=2 against JAX's
    with open(REUSE_REFERENCE) as f:
        ref = json.load(f)["psnr_forward_render"]
    small = small_trained_pipeline("cuda", torch.bfloat16)
    small.cfg = dataclasses.replace(small.cfg, sampler=dataclasses.replace(
        small.cfg.sampler, encoder_reuse=2))
    r = held_out_scores(small, n=32, num_steps=20, noise_seeds=(1000,))
    value = r["psnr_forward_render"]
    log(f"  held-out forward PSNR at encoder_reuse=2: {value:.3f} dB (bf16 "
        f"on the card), the JAX package's {ref['2']:.3f} (exact sampler: "
        f"{ref['1']:.3f}; {REUSE_REFERENCE})")
    check(value >= ref["2"] - PSNR_MARGIN,
          f"held-out forward PSNR at encoder_reuse=2 {value:.3f} dB is more "
          f"than {PSNR_MARGIN} dB below the JAX package's {ref['2']:.3f}")
    result["held_out_reuse_2"] = dict(psnr=value, jax=ref["2"],
                                      jax_exact=ref["1"])
    del small
    torch.cuda.empty_cache()
    return result



# ---------------------------------------------------------------------------
# Phase 12: the rest of training
# ---------------------------------------------------------------------------


def vae_train_calls(cfg):
    """`pipelines.KernelCalls` of one VAE training step at flagship width:
    the encoder and the decoder over VAE_BATCH scenes x 8 maps."""
    from unirenderer_tpu_torch.pipelines import KernelCalls
    n = 8 * VAE_BATCH
    calls = KernelCalls(cfg, cfg.data.resolution)
    calls.vae_encoder(n)
    calls.vae_decoder(n)
    return calls


def unpadded(mesh):
    """A dataset mesh padded to DataConfig's (V, T), back to its own."""
    import numpy as np
    t = mesh["t_idx"]
    n_t = int(np.nonzero(t.any(axis=1))[0].max()) + 1
    n_v = int(t[:n_t].max()) + 1
    out = {k: mesh[k][:n_v] for k in ("v_pos", "v_nrm", "v_tng", "v_tex")}
    out["t_idx"] = t[:n_t]
    return out


def rast_check_once(torch, timer, name, pos, tri, res):
    """K4 against its plain version on one input, which runs once, for the
    check; kernel time from CUDA events over one call after an L2 flush.
    Fails unless bit-equal.  -> (the case, its call signature)."""
    from unirenderer_tpu_torch.ops.rasterize import (
        match_stats, rasterize, rasterize_reference, within_rule,
    )
    got = rasterize(pos, tri, res, res)
    torch.cuda.synchronize()
    want = rasterize_reference(pos, tri, res, res)
    stats = match_stats(got, want)
    del got, want
    ms = timer(lambda: rasterize(pos, tri, res, res))
    bound_ms, bound_by, _ = rast_bound(torch, pos, tri, res, res, False)
    views = tri.shape[0]
    r = dict(kernel="rasterize", case=name,
             shape=[views, pos.shape[1], tri.shape[1], res, res],
             peel=False, ok=within_rule(stats) and stats["bit_equal"],
             **stats, max_abs_err=max(stats["z_err"], stats["uv_err"]),
             ms=ms, plain_ms=None, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None)
    log(f"  K4 at the {name} shape {r['shape']}: bit-equal "
        f"{int(stats['bit_equal'])}, within the rule "
        f"{int(within_rule(stats))}, {ms:.4f} ms (bound {bound_ms:.4f},"
        f" {bound_by})")
    check(r["ok"], f"K4 disagrees with its plain version at {r['shape']}")
    return r, ((views, pos.shape[1], 4), (views, tri.shape[1], 3), res, res,
               False)


def bank_rast_cases(torch, bank, cfg):
    """K4 against its plain version at the raster shapes of the bank steps
    (2 views: the train step; VAE_BATCH: the VAE step), on clip positions
    of scenes drawn from the bank (`rast_check_once`)."""
    from unirenderer_tpu_torch.data.scene_bank import (
        bank_sizes, draw_scenes, scenes_from_draws,
    )
    from unirenderer_tpu_torch.ops.transform import xfm_points
    d = cfg.data
    res = d.resolution * d.ssaa
    gen = torch.Generator().manual_seed(SEED)
    timer = Timer(torch)
    out, signatures = [], set()
    for views in sorted({2, VAE_BATCH}):
        scene = scenes_from_draws(bank, draw_scenes(
            gen, bank_sizes(bank), views, d), d)
        pos = xfm_points(scene["v_pos"], scene["mvps"]).contiguous()
        r, sig = rast_check_once(torch, timer, f"bank {views} views", pos,
                                 scene["t_idx"].contiguous(), res)
        out.append(r)
        signatures.add(sig)
    return out, signatures


def train_launch_check(launches, seen, want, checked, what):
    for k, n in want.items():
        check(launches[k] == n, f"{what}: {k} {launches[k]} launches, "
              f"{n} from the config")
        missed = seen[k] - checked[k]
        check(not missed, f"{what}: {k} got calls no earlier case checked: "
              f"{sorted(missed)[:3]}")


def phase_rest_of_training(torch, cfg, checked):
    """The scene-bank trainer, the step variants, Adafactor, gradient
    accumulation, the snapshot of a checkpoint and VAE training at
    flagship width; resume and validation at small() with the r05
    weights."""
    import dataclasses
    import tempfile
    import numpy as np
    from unirenderer_tpu_torch.core.checkpoint import AsyncSaver
    from unirenderer_tpu_torch.data.objaverse import collate_from_scene
    from unirenderer_tpu_torch.data.scene_bank import (
        bank_bytes, bank_sizes, draw_scenes, scenes_from_draws, stack_bank,
    )
    from unirenderer_tpu_torch.train.train_step import (
        BATCH_KEYS, create_train_state, draw, make_bank_train_step,
        make_grad_fn, make_render_train_step, make_two_phase_train_step,
        train_step_launches,
    )
    from unirenderer_tpu_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    d = cfg.data
    items, _ = flagship_items(torch, cfg, np.random.default_rng(SEED))
    bank_np = stack_bank([unpadded(i["mesh"]) for i in items],
                         [i["mesh"]["kd_tex"] for i in items],
                         [items[0]["env"]])
    del items
    counted = ("groupnorm_silu", "flash_attention",
               "flash_attention_backward", "rasterize")
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        trainer = Trainer(cfg, os.path.join(tmp, "flagship"), device="cuda",
                          scene_bank=bank_np)
        torch.cuda.synchronize()
        bank = trainer.bank
        n_mesh, n_env = bank_sizes(bank)
        log(f"  flagship Trainer with a scene bank built in "
            f"{time.perf_counter() - t:.1f} s; bank {n_mesh} meshes, {n_env} "
            f"env, V {bank['v_pos'].shape[1]}, T {bank['t_idx'].shape[1]} "
            f"(the set's max rounded up to 128), "
            f"{bank_bytes(bank) / 2**20:.1f} MiB on the card")
        rast_cases, rast_checked = bank_rast_cases(torch, bank, cfg)
        checked = dict(checked, rasterize=rast_checked)
        result.update(bank_bytes=bank_bytes(bank),
                      bank_t=int(bank["t_idx"].shape[1]),
                      rasterize_cases=rast_cases)

        # 1. bank steps, the branch forced
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for inverse in (False, True, False, True):
            torch.cuda.synchronize()
            reset_counters()
            t = time.perf_counter()
            metrics = trainer.step(is_inverse=inverse)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches, seen = read_counters()
            want = train_step_launches(cfg, 2, inverse, render=True)
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            kind = "inverse" if inverse else "forward"
            log(f"  bank {kind} step {trainer.state.step}: {wall:.3f} s, "
                f"loss {loss:.5g}, grad norm {norm:.5g}, launches "
                + ", ".join(f"{k} {launches[k]} (config {want[k]})"
                            for k in counted))
            check(math.isfinite(loss) and math.isfinite(norm),
                  f"non-finite loss or grad norm at a bank {kind} step")
            train_launch_check(launches, seen, want, checked,
                               f"bank {kind} step")
            steps.append(dict(inverse=inverse, wall_s=wall, loss=loss,
                              grad_norm=norm,
                              launches={k: launches[k] for k in counted}))
        adamw_peak = torch.cuda.max_memory_allocated()
        log(f"  bank steps warm: forward {steps[2]['wall_s']:.3f} s, "
            f"inverse {steps[3]['wall_s']:.3f} s (cold {steps[0]['wall_s']:.3f}"
            f" / {steps[1]['wall_s']:.3f}); peak memory "
            f"{adamw_peak / 2**30:.2f} GiB (AdamW)")
        prof = profile_request(torch, lambda: trainer.step(is_inverse=True))
        k4_ms = prof["by_class"].get("K4 rasterize", 0.0)
        busy = prof["device_busy_ms"]
        idle = 1 - busy / (1e3 * steps[3]["wall_s"])
        log(f"  warm inverse bank step profiled: device busy {busy:.1f} ms, "
            f"{100 * idle:.1f}% idle against the unprofiled warm wall "
            f"({1e3 * steps[3]['wall_s']:.1f} ms; "
            f"{100 * (1 - busy / prof['wall_ms']):.1f}% of the profiled "
            f"{prof['wall_ms']:.1f} ms); K4 {k4_ms:.3f} ms = "
            f"{100 * k4_ms / busy:.2f}% of device time")
        prof["idle_share_unprofiled"] = idle
        result.update(bank_steps=steps, adamw_peak_bytes=adamw_peak,
                      bank_profile=prof)

        # 2. the snapshot of a checkpoint (AdamW state), write skipped
        torch.cuda.synchronize()
        t = time.perf_counter()
        snap = AsyncSaver.snapshot(trainer.state.params,
                                   trainer.resume_state())
        torch.cuda.synchronize()
        snap_s = time.perf_counter() - t
        snap_bytes = sum(v.numel() * v.element_size()
                         for v in snap[0].values())
        del snap
        torch.cuda.empty_cache()
        log(f"  AsyncSaver snapshot (clone on the card of the params and "
            f"the optimizer state, no write): {snap_s:.3f} s; params "
            f"{snap_bytes / 2**30:.2f} GiB")
        result["snapshot_s"] = snap_s

        # 3. render-in-step and two-phase against the plain step's loss
        args = (cfg, trainer.dual, trainer.vae, trainer.schedule,
                trainer.compute_dtype)
        gen = torch.Generator().manual_seed(SEED + 12)
        sd = draw_scenes(gen, bank_sizes(bank), 2, d)
        draws = draw(gen, 2, (d.resolution // cfg.vae.downscale,) * 2,
                     cfg.diffusion.num_train_timesteps, True).to("cuda")
        scene = scenes_from_draws(bank, sd, d)

        def collate(sc):
            return collate_from_scene(sc, d.resolution, ssaa=d.ssaa)

        with torch.no_grad():
            maps = collate(scene)
        _, m_plain = make_grad_fn(*args)(
            trainer.state.params, {k: maps[k] for k in BATCH_KEYS},
            trainer.ctx, draws)
        del maps
        grad_step, _ = make_two_phase_train_step(*args,
                                                 batch_transform=collate)
        grads, m_two = grad_step(trainer.state.params, trainer.ctx, scene,
                                 draws)
        del grads
        m_render = make_render_train_step(*args)(trainer.state, trainer.ctx,
                                                 scene, draws)
        losses = {k: float(m["loss"]) for k, m in (
            ("plain", m_plain), ("two_phase", m_two), ("render", m_render))}
        rel = {k: abs(v - losses["plain"]) / abs(losses["plain"])
               for k, v in losses.items()}
        log(f"  same draws, inverse branch: plain step loss "
            f"{losses['plain']:.6g}, two-phase {losses['two_phase']:.6g} "
            f"(rel {rel['two_phase']:.3g}), render-in-step "
            f"{losses['render']:.6g} (rel {rel['render']:.3g}); limit "
            f"{TRAIN_VARIANT_REL}")
        check(max(rel.values()) <= TRAIN_VARIANT_REL,
              "two-phase or render-in-step loss differs from the plain step")
        result["variant_losses"] = losses
        del m_plain, m_two, m_render, scene

        # 4. Adafactor (its state replaces AdamW's)
        def with_train(**over):
            return dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, **over))

        trainer.state = None
        torch.cuda.empty_cache()
        af_cfg = with_train(optimizer="adafactor")
        state = create_train_state(af_cfg, trainer.dual)
        step_fn = make_bank_train_step(af_cfg, *args[1:])
        torch.cuda.reset_peak_memory_stats()
        af = []
        for inverse in (False, True):
            reset_counters()
            torch.cuda.synchronize()
            t = time.perf_counter()
            sd = draw_scenes(gen, bank_sizes(bank), 2, d)
            dr = draw(gen, 2, (d.resolution // cfg.vae.downscale,) * 2,
                      cfg.diffusion.num_train_timesteps, inverse)
            m = step_fn(state, trainer.ctx, bank, sd, dr.to("cuda"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches, seen = read_counters()
            train_launch_check(launches, seen,
                               train_step_launches(cfg, 2, inverse, True),
                               checked, "Adafactor step")
            af.append(dict(wall_s=wall, loss=float(m["loss"]),
                           grad_norm=float(m["grad_norm"])))
            check(math.isfinite(af[-1]["loss"]), "Adafactor loss not finite")
        af_peak = torch.cuda.max_memory_allocated()
        af_state = sum(t.numel() * t.element_size()
                       for st in state.optimizer.state.values()
                       for t in st.values() if torch.is_tensor(t))
        log(f"  Adafactor, 2 bank steps: {af[0]['wall_s']:.3f} / "
            f"{af[1]['wall_s']:.3f} s, loss {af[0]['loss']:.5g} / "
            f"{af[1]['loss']:.5g}; peak memory {af_peak / 2**30:.2f} GiB "
            f"against AdamW's {adamw_peak / 2**30:.2f} GiB; optimizer state "
            f"{af_state / 2**30:.3f} GiB")
        result.update(adafactor_steps=af, adafactor_peak_bytes=af_peak,
                      adafactor_state_bytes=af_state)
        del state
        torch.cuda.empty_cache()

        # 5. gradient accumulation, k = 2, over AdamW
        acc_cfg = with_train(gradient_accumulation_steps=2)
        state = create_train_state(acc_cfg, trainer.dual)
        step_fn = make_bank_train_step(acc_cfg, *args[1:])
        params = state.params
        watch = [n for n in (next(k for k in params if k.startswith(m))
                             for m in ("unet.", "controlnet.",
                                       "controldec."))]
        before = {n: params[n].detach().clone() for n in watch}
        moved = []
        for call in range(4):
            sd = draw_scenes(gen, bank_sizes(bank), 2, d)
            dr = draw(gen, 2, (d.resolution // cfg.vae.downscale,) * 2,
                      cfg.diffusion.num_train_timesteps, None)
            step_fn(state, trainer.ctx, bank, sd, dr.to("cuda"))
            changed = [not torch.equal(before[n], params[n]) for n in watch]
            moved.append(all(changed))
            check(all(changed) if call % 2 else not any(changed),
                  f"accumulation k=2: watched parameters changed {changed} "
                  f"at call {call + 1}")
            before = {n: params[n].detach().clone() for n in watch}
        log(f"  accumulation k=2 over 4 calls: parameters moved "
            f"{moved} (calls 2 and 4 only); updates {state.updates}, "
            f"steps {state.step}")
        check(state.updates == 2 and state.step == 4,
              f"accumulation: {state.updates} updates in {state.step} steps")
        result["accumulation_moved"] = moved
        del state, step_fn, params, before, trainer
        torch.cuda.empty_cache()

        # 6. VAE training at flagship widths from the bank
        result["vae"] = vae_training(torch, cfg, bank, checked)
        del bank
        torch.cuda.empty_cache()

        # 7. small(): validation, then resume
        result.update(small_resume_and_validation(torch, tmp))
    elapsed = time.perf_counter() - t_phase
    log(f"  phase 12 took {elapsed:.1f} s")
    result["seconds"] = elapsed
    return result


def vae_training(torch, cfg, bank, checked):
    from unirenderer_tpu_torch.data.scene_bank import bank_sizes, draw_scenes
    from unirenderer_tpu_torch.train.vae_train import (
        build_vae, create_vae_train_state, make_vae_bank_train_step,
        posterior_shape,
    )
    d = cfg.data
    vae = build_vae(cfg, "cuda", SEED)
    state = create_vae_train_state(vae)
    step_fn = make_vae_bank_train_step(cfg, vae, 1e-4,
                                       compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 13)
    want = dict(vae_train_calls(cfg).launches, rasterize=1,
                flash_attention=0)
    n_params = sum(p.numel() for p in state.params.values())
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(3):
        sd = draw_scenes(gen, bank_sizes(bank), VAE_BATCH, d)
        noise = torch.randn(posterior_shape(
            cfg, (8 * VAE_BATCH, d.resolution, d.resolution, 3)),
            generator=gen)
        reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step_fn(state, bank, sd, noise.to("cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, seen = read_counters()
        train_launch_check(launches, seen,
                           {k: v for k, v in want.items()
                            if k != "flash_attention"}, checked, "VAE step")
        check(launches["flash_attention"] == 0,
              "the VAE step launched K2 (its attention is plain PyTorch)")
        rec = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in rec.values()),
              f"VAE step metrics not finite: {rec}")
        steps.append(dict(wall_s=wall, **rec))
        log(f"  VAE step {state.step} ({VAE_BATCH} scene x 8 maps at "
            f"{d.resolution}^2, bf16): {wall:.3f} s, loss "
            f"{rec['vae_loss']:.5g}, PSNR {rec['vae_psnr']:.3f} dB, K1 "
            f"{launches['groupnorm_silu']} (config "
            f"{want['groupnorm_silu']}), K4 {launches['rasterize']}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  VAE training: {n_params / 1e6:.1f} M f32 master params, warm "
        f"step {steps[-1]['wall_s']:.3f} s, peak memory "
        f"{peak / 2**30:.2f} GiB")
    del state, vae, step_fn
    return dict(steps=steps, peak_bytes=peak, params=n_params,
                launches_per_step=want)


def small_resume_and_validation(torch, tmp):
    """small() with the r05 weights on the card (bf16): validation on 4
    held-out objects (seed 99) against the harness's inverse maps at the
    same params and noise seed; then 2 bank steps from the held-out set's
    bank with a checkpoint at step 2, a fresh Trainer resuming from it
    (bit-equal state), one more step from each."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.data.scene_bank import load_scene_bank
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    from unirenderer_tpu_torch.eval.quality import (
        HELD_OUT, InverseTally, _held_out_batches, held_out_paths,
        inverse_batch, small_trained_pipeline,
    )
    from unirenderer_tpu_torch.eval.validation import make_validation_fn
    from unirenderer_tpu_torch.train.compare import (
        small_weights, trainer_with,
    )
    import dataclasses
    out = {}
    root = os.path.join(tmp, "held_out")
    t = time.perf_counter()
    write_dataset(root, device="cuda", log=lambda msg: None, **HELD_OUT)
    meshes, envs = held_out_paths(root)
    cfg = config.small()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_every=2, batch_size_per_device=2))
    bank = load_scene_bank(os.path.join(root, "meshes"),
                           os.path.join(root, "envs"), cfg.data)
    log(f"  held-out set (seed 99) written and loaded as a bank in "
        f"{time.perf_counter() - t:.1f} s: T {bank['t_idx'].shape[1]}")

    weights = small_weights()
    workdir = os.path.join(tmp, "small")
    tr = trainer_with(cfg, weights, "cuda", torch.bfloat16, workdir,
                      scene_bank=bank)
    # validation at the r05 weights
    pipe = small_trained_pipeline("cuda", torch.bfloat16)
    val_batch = next(_held_out_batches(pipe, meshes, envs, 4))
    tally = InverseTally()
    tally.add(val_batch, inverse_batch(pipe, val_batch, 20, 1000, 1))
    ref = tally.result()["psnr_maps"]
    del pipe
    masters = {n: p.detach().clone() for n, p in tr.state.params.items()}
    fn = make_validation_fn(tr, val_batch, os.path.join(tmp, "validation"),
                            num_steps=20, ensemble=1, noise_seed=1000)
    got = fn(tr.state, 0)
    diffs = {k: abs(got[f"psnr_{k}"] - v) for k, v in ref.items()}
    log("  validation (4 held-out objects, 20 steps, noise seed 1000) "
        "against the harness's inverse maps: "
        + ", ".join(f"{k} {got['psnr_' + k]:.4f} vs {v:.4f} dB"
                    for k, v in ref.items())
        + f"; largest difference {max(diffs.values()):.3g} dB")
    check(max(diffs.values()) <= VALIDATION_PSNR_ABS,
          f"validation PSNRs differ from the harness's: {diffs}")
    check(all(torch.equal(p, masters[n])
              for n, p in tr.state.params.items()) and tr.dual.training,
          "validation changed the masters or the module's mode")
    out["validation"] = dict(psnr=got, reference=ref)
    del masters

    # resume
    tr.train(max_steps=2)
    check(tr.ckpt.all_steps() == [2], f"checkpoints {tr.ckpt.all_steps()}")
    fresh = trainer_with(cfg, weights, "cuda", torch.bfloat16, workdir,
                         scene_bank=bank)
    check(fresh.maybe_resume() == 2, "the fresh Trainer did not resume")
    same = [torch.equal(p, q) for p, q in zip(tr.state.params.values(),
                                              fresh.state.params.values())]
    sa = tr.state.optimizer.state_dict()["state"]
    sb = fresh.state.optimizer.state_dict()["state"]
    same_opt = all(torch.equal(sa[i][k], sb[i][k]) for i in sa
                   for k in sa[i])
    same_gen = torch.equal(tr.generator.get_state(),
                           fresh.generator.get_state())
    log(f"  resume at step 2: params bit-equal {all(same)} ({len(same)} "
        f"tensors), optimizer state bit-equal {same_opt}, step "
        f"{fresh.state.step}, generator state equal {same_gen}")
    check(all(same) and same_opt and same_gen and fresh.state.step == 2,
          "the resumed state differs from the saved one")
    la = float(tr.step()["loss"])
    lb = float(fresh.step()["loss"])
    rel = abs(la - lb) / abs(la)
    log(f"  one more step from each: loss {la:.6g} vs {lb:.6g} (rel "
        f"{rel:.3g}, limit {TRAIN_VARIANT_REL}; K2 bwd's dQ atomics are the "
        f"one source of order)")
    check(rel <= TRAIN_VARIANT_REL, "the resumed run's step differs")
    out["resume"] = dict(loss=la, loss_resumed=lb, rel=rel)
    del tr, fresh
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 13: the apps and the rest of eval
# ---------------------------------------------------------------------------


def apps_calls(cfg):
    """name -> `pipelines.KernelCalls` of each of phase 13's requests: the
    app's decompose (flagship, 1 photo x APP_ENSEMBLE) and relight (1 x
    ensemble 1), `run_inverse` (the decompose, then relight's forward pass
    from it) and the medium() decompose."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.pipelines import KernelCalls
    res, steps = cfg.vae.sample_size, cfg.sampler.num_steps
    med = config.medium()
    return {
        "decompose": KernelCalls(cfg, res).real_image2mask_3mod_albedo(
            1, steps, APP_ENSEMBLE),
        "relight": KernelCalls(cfg, res).relight(1, steps),
        "run_inverse": KernelCalls(cfg, res).real_image2mask_3mod_albedo(
            1, steps, APP_ENSEMBLE).mask2image_3mod_albedo(
                1, steps, material_image_encode=True),
        "medium_decompose": KernelCalls(
            med, med.vae.sample_size).real_image2mask_3mod_albedo(
                1, steps, APP_ENSEMBLE),
    }


def _png_b64(arr_u8):
    import base64
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _png_decode(b64s):
    import base64
    import io
    import numpy as np
    from PIL import Image
    with Image.open(io.BytesIO(base64.b64decode(b64s))) as img:
        return np.asarray(img)


def app_photo(torch, cfg):
    """Phase 6's first scene collated alone at 512^2 -> (its image as a
    uint8 photo, a box prompt around its mask with a 16-pixel margin, the
    scene's items)."""
    import numpy as np
    from unirenderer_tpu_torch.data.objaverse import collate_render
    d = cfg.data
    items, _ = flagship_items(torch, cfg, np.random.default_rng(SEED))
    maps = collate_render(items[:1], resolution=d.resolution, ssaa=d.ssaa,
                          device="cuda")
    photo = ((maps["image"][0].clamp(-1, 1) + 1) * 127.5).round().to(
        torch.uint8).cpu().numpy()
    ys, xs = np.nonzero(maps["mask"][0, ..., 0].cpu().numpy() > 0)
    r = d.resolution - 1
    box = (max(int(xs.min()) - 16, 0), max(int(ys.min()) - 16, 0),
           min(int(xs.max()) + 16, r), min(int(ys.max()) + 16, r))
    return photo, ",".join(map(str, box)), items


def serve_app(torch, cfg, pipe, checked, calls, photo, box):
    """The HTTP server in a thread over a flagship AppBackend: the page,
    decompose (twice: the same bits), relight, and a request with no image
    (a JSON 500); each served request's K1/K2 launches from the config,
    its warm wall, the device time of the same backend call (profiler)
    and its peak memory."""
    import http.client
    import threading
    from http.server import HTTPServer
    import numpy as np
    from unirenderer_tpu_torch.eval.app import MAP_NAMES, AppBackend
    from unirenderer_tpu_torch.eval.http_app import make_handler
    backend = AppBackend(pipe, steps=cfg.sampler.num_steps,
                         ensemble=APP_ENSEMBLE)
    srv = HTTPServer(("127.0.0.1", 0), make_handler(backend))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host = f"127.0.0.1:{srv.server_port}"

    def request(method, path, payload=None):
        conn = http.client.HTTPConnection(host, timeout=600)
        body = None if payload is None else json.dumps(payload)
        conn.request(method, path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    def served(path, payload):
        status, data = request("POST", path, payload)
        check(status == 200, f"{path}: HTTP {status}: {data[:300]!r}")
        return json.loads(data)

    out, res = {}, cfg.vae.sample_size
    rng = np.random.default_rng(SEED + 13)
    smooth = rng.standard_normal((4, 8, 3))
    env = np.kron(np.exp(smooth), np.ones((16, 16, 1)))      # 64 x 128
    env_u8 = (np.clip(env / env.max(), 0, 1) ** (1 / 2.2) * 255).astype(
        np.uint8)
    body = {"image": _png_b64(photo), "mask": None, "box": box,
            "point": None}
    try:
        status, page = request("GET", "/")
        check(status == 200 and b"Decompose" in page, "GET / failed")
        for name, path, payload, direct in (
                ("decompose", "/api/decompose", body,
                 lambda: backend.decompose(photo, None, box)),
                ("relight", "/api/relight",
                 dict(body, env=_png_b64(env_u8)),
                 lambda: backend.relight(photo, None, box, env_u8))):
            first, cold, peak, got = counted_run(
                torch, lambda: served(path, payload),
                calls[name].launches, checked, f"app {name}")
            t = time.perf_counter()
            again = served(path, payload)
            warm = time.perf_counter() - t
            names = MAP_NAMES if name == "decompose" else ("relit",)
            check(sorted(first["maps"]) == sorted(names),
                  f"app {name}: maps {sorted(first['maps'])}")
            for k, png in first["maps"].items():
                arr = _png_decode(png)
                check(arr.shape == (res, res, 3) and arr.dtype == np.uint8,
                      f"app {name}: {k} is {arr.shape} {arr.dtype}")
            check(again == first, f"app {name}: a repeat gave other bits")
            busy = device_busy_ms(torch, direct)
            out[name] = dict(cold_wall_s=cold, warm_wall_s=warm,
                             device_busy_ms=busy, peak_bytes=peak,
                             launches=got)
            log(f"  app {name} over HTTP (flagship, {cfg.sampler.num_steps}"
                f" steps, ensemble "
                f"{APP_ENSEMBLE if name == 'decompose' else 1}): cold "
                f"{cold:.3f} s, warm {warm:.3f} s, device busy {busy:.1f} "
                f"ms (the backend call, profiler), peak "
                f"{peak / 2**30:.2f} GiB, launches {got}; a repeat gave "
                f"the same bits")
        status, data = request("POST", "/api/decompose", {"image": None})
        err = json.loads(data).get("error", "")
        check(status == 500 and "no input image" in err,
              f"a request with no image: HTTP {status} {err!r}")
        log(f"  a request with no image: HTTP 500 {err!r}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    return out


def run_inverse_cli(torch, cfg, calls, photo, box, tmp):
    """`python -m unirenderer_tpu_torch.eval.run_inverse` on the card at
    flagship size with --box and a .hdr written by `write_hdr`: exit 0 and
    every folder written at the VAE's resolution."""
    import numpy as np
    from PIL import Image
    from unirenderer_tpu_torch.data.hdr import write_hdr
    from unirenderer_tpu_torch.eval.run_inverse import MAP_FOLDERS
    img_path = os.path.join(tmp, "photo.png")
    Image.fromarray(photo).save(img_path)
    env_path = os.path.join(tmp, "env.hdr")
    rng = np.random.default_rng(SEED + 14)
    write_hdr(env_path, np.exp(rng.standard_normal((64, 128, 3))).astype(
        np.float32))
    out_dir = os.path.join(tmp, "run_inverse")
    cmd = [sys.executable, "-m", "unirenderer_tpu_torch.eval.run_inverse",
           "--image", img_path, "--out", out_dir, "--box", box,
           "--relight-env", env_path, "--steps",
           str(cfg.sampler.num_steps), "--ensemble", str(APP_ENSEMBLE)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"run_inverse exited {proc.returncode}: "
          f"{proc.stderr[-1500:]}")
    shapes = {}
    for name in MAP_FOLDERS + ("relit",):
        path = os.path.join(out_dir, name, "0.png")
        check(os.path.exists(path), f"run_inverse wrote no {name}/0.png")
        with Image.open(path) as img:
            shapes[name] = img.size + (len(img.getbands()),)
        res = cfg.vae.sample_size
        check(shapes[name] == (res, res, 3),
              f"run_inverse {name}/0.png is {shapes[name]}")
    log(f"  run_inverse (flagship, box {box}, relight under a .hdr): exit "
        f"0 in {wall:.1f} s (process start, weights, kernels loaded from "
        f"the build, a decompose x {APP_ENSEMBLE} and a relight), "
        f"{len(shapes)} folders at {cfg.vae.sample_size}^2; its own "
        f"launches per the config: "
        f"{calls['run_inverse'].launches}; stdout: "
        f"{proc.stdout.strip().splitlines()[0]!r}")
    return dict(wall_s=wall, folders=sorted(shapes))


def medium_request(torch, cfg, checked, calls, photo, box):
    """`http_app.build_backend("medium", ...)` on the card: one decompose
    at the flagship's step count, its launches from the config."""
    import numpy as np
    from unirenderer_tpu_torch.eval.http_app import build_backend
    t = time.perf_counter()
    backend = build_backend("medium", None, None, cfg.sampler.num_steps,
                            APP_ENSEMBLE, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    size = backend.size
    # the prompt in the upload's pixels: the backend scales it itself
    maps, cold, peak, got = counted_run(
        torch, lambda: backend.decompose(photo, None, box),
        calls["medium_decompose"].launches, checked, "medium decompose")
    t = time.perf_counter()
    again = backend.decompose(photo, None, box)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    for k, v in maps.items():
        check(v.shape == (size, size, 3) and v.dtype == np.uint8,
              f"medium {k}: {v.shape} {v.dtype}")
        check(np.array_equal(v, again[k]), f"medium {k}: repeat differs")
    n_params = sum(p.numel() for p in backend.pipe.dual.parameters())
    log(f"  medium() decompose ({n_params / 1e6:.1f}M dual-stream params, "
        f"{size}^2, ensemble {APP_ENSEMBLE}): "
        f"built in {build_s:.1f} s, cold {cold:.3f} s, warm {warm:.3f} s, "
        f"peak {peak / 2**30:.2f} GiB, launches {got}")
    del backend
    torch.cuda.empty_cache()
    return dict(cold_wall_s=cold, warm_wall_s=warm, peak_bytes=peak,
                launches=got, dual_params=n_params)


def obj_collate(torch, cfg, items, tmp):
    """Phase 6's first mesh and texture written as an OBJ + MTL + PNG,
    loaded by the native scanner and by the numpy parser (bit-equal), its
    material by `Material.from_mtl`, collated from two cameras: K4 at that
    shape bit-equal to its plain version, one launch in the collate."""
    import numpy as np
    from unirenderer_tpu_torch.data.obj_io import build_native, load_obj
    from unirenderer_tpu_torch.data.objaverse import (
        collate_render, pad_mesh, stack_scene,
    )
    from unirenderer_tpu_torch.ops.transform import xfm_points
    from unirenderer_tpu_torch.render.material import Material
    d = cfg.data
    mesh = unpadded(items[0]["mesh"])
    obj = write_obj(tmp, "scene", mesh, items[0]["mesh"]["kd_tex"])
    t = time.perf_counter()
    build_native()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    native = load_obj(obj, use_native=True)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    plain = load_obj(obj, use_native=False)
    plain_s = time.perf_counter() - t
    for k in ("v_pos", "t_idx", "v_nrm", "v_tex", "v_tng", "kd"):
        check(native[k].dtype == plain[k].dtype
              and np.array_equal(native[k], plain[k]),
              f"load_obj: the native scanner's {k} differs from numpy's")
    material = Material.from_mtl(os.path.join(tmp, "scene.mtl"),
                                 device="cuda")
    check(material.has_texture and tuple(material.kd.shape) == (
        d.texture_res, d.texture_res, 3), "Material.from_mtl: no texture")
    m = pad_mesh({k: native[k] for k in ("v_pos", "t_idx", "v_nrm",
                                         "v_tex", "v_tng")},
                 d.v_pad, d.t_pad)
    m["kd_tex"] = material.kd.cpu().numpy()
    batch = [dict(items[i], mesh=m) for i in range(2)]   # two cameras
    scene = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in stack_scene(batch).items()}
    pos = xfm_points(scene["v_pos"], scene["mvps"]).contiguous()
    case, sig = rast_check_once(torch, Timer(torch), "OBJ collate", pos,
                                scene["t_idx"].contiguous(),
                                d.resolution * d.ssaa)
    reset_counters()
    maps = collate_render(batch, resolution=d.resolution, ssaa=d.ssaa,
                          device="cuda")
    torch.cuda.synchronize()
    launches, seen = read_counters()
    check(launches["rasterize"] == 1,
          f"the OBJ collate launched K4 {launches['rasterize']} times")
    check(seen["rasterize"] == {sig}, f"K4 saw {seen['rasterize']}")
    for k in ("image", "albedo", "normal", "mask"):
        check(bool(torch.isfinite(maps[k]).all()), f"OBJ collate {k}")
    coverage = (maps["mask"][..., 0] > 0).float().mean().item()
    check(0.02 < coverage < 0.98, f"OBJ collate coverage {coverage}")
    log(f"  OBJ (V {len(native['v_pos'])}, T {len(native['t_idx'])}) + MTL "
        f"+ {d.texture_res}^2 map_Kd: scanner built by g++ in {build_s:.2f}"
        f" s (0: built before), load_obj {native_s * 1e3:.1f} ms with the "
        f"native scanner, {plain_s * 1e3:.1f} ms with the numpy parser "
        f"(unification and tangents in both), the same arrays bit for bit; "
        f"the collate launched K4 once, mask coverage {coverage:.3f}")
    return dict(build_s=build_s, native_s=native_s, plain_s=plain_s,
                vertices=len(native["v_pos"]),
                triangles=len(native["t_idx"]), coverage=coverage), case


def score_perceptual(torch, images):
    """LPIPS and FID (seeded random backbones) of the held-out forward
    images on the card in f32 (TF32 off) against the same on the CPU."""
    from unirenderer_tpu_torch.eval.quality import perceptual_scores
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t = time.perf_counter()
        card = perceptual_scores(images, "cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    t = time.perf_counter()
    cpu = perceptual_scores(images, "cpu")
    cpu_s = time.perf_counter() - t
    n = sum(len(g) for g, _ in images)
    out = dict(card=card, cpu=cpu, card_s=card_s, cpu_s=cpu_s, n=n)
    for k in ("lpips_forward_vs_gt", "fid_forward_vs_gt"):
        rel = abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
        out[f"{k}_rel"] = rel
        log(f"  {k} over {n} held-out images: card {card[k]:.6g}, CPU "
            f"{cpu[k]:.6g}, relative difference {rel:.3g} (limit "
            f"{PERCEPTUAL_REL:g})")
        check(rel <= PERCEPTUAL_REL, f"{k}: card and CPU differ by {rel:.3g}")
    check(not card["lpips_calibrated"] and not card["fid_calibrated"],
          "random backbones reported as calibrated")
    log(f"  scoring time: card {card_s:.1f} s, CPU {cpu_s:.1f} s")
    return out


def phase_apps(torch, cfg, checked, held_out_images):
    import gc
    import tempfile
    import PIL
    log(f"  Pillow {PIL.__version__}")
    calls = apps_calls(cfg)
    result = dict(pillow=PIL.__version__)
    photo, box, items = app_photo(torch, cfg)
    with tempfile.TemporaryDirectory(prefix="apps_") as tmp:
        pipe, _ = flagship_pipeline(torch, cfg)
        result["http"] = serve_app(torch, cfg, pipe, checked, calls, photo,
                                   box)
        del pipe
        gc.collect()          # the server's handler class holds the backend
        torch.cuda.empty_cache()
        log(f"  after the server: {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB allocated on the card")
        result["run_inverse"] = run_inverse_cli(torch, cfg, calls, photo,
                                                box, tmp)
        result["medium"] = medium_request(torch, cfg, checked, calls, photo,
                                          box)
        result["obj"], rast = obj_collate(torch, cfg, items, tmp)
    if held_out_images is None:
        from unirenderer_tpu_torch.eval.quality import (
            held_out_scores, small_trained_pipeline,
        )
        small = small_trained_pipeline("cuda", torch.bfloat16)
        r = held_out_scores(small, n=32, num_steps=20, noise_seeds=(1000,),
                            keep_images=True)
        held_out_images = r["runs"][0].pop("images")
        del small
        torch.cuda.empty_cache()
    result["perceptual"] = score_perceptual(torch, held_out_images)
    return result, rast


# ---------------------------------------------------------------------------


KERNELS = {
    "groupnorm_silu": dict(
        route="cuda", source="unirenderer_tpu_torch/csrc/groupnorm.cu",
        replaces="unirenderer_tpu/ops/groupnorm.py:42",
        # the UNet's 64^2 ResnetBlock norm: the most frequent large call
        headline=lambda r: (r["shape"] == [2, 64, 64, 320]
                            and r["eps"] == 1e-5 and r["silu"]
                            and r["param_dtype"] == "bfloat16")),
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
    # the f32 forms (phase 15); launches from the f32 main path: the
    # held-out harness (K1 on the cluster kernel, K2), the train step (K2
    # bwd), a small() request under each route (K2s, K3)
    "groupnorm_silu_f32": dict(
        route="cuda", source="unirenderer_tpu_torch/csrc/groupnorm_f32.cu",
        replaces="unirenderer_tpu/ops/groupnorm.py:42",
        # the held-out harness's most launched K1 call (2320 of 10528):
        # the UNet's 4^2 ResnetBlock norm at batch 4
        headline=lambda r: (r["shape"] == [4, 4, 4, 512]
                            and r["eps"] == 1e-5 and r["silu"]
                            and r["param_dtype"] == "float32")),
    "flash_attention_f32": dict(
        route="cuda",
        source="unirenderer_tpu_torch/csrc/flash_attention_f32.cu",
        replaces="unirenderer_tpu/ops/flash_attention.py:68",
        headline=lambda r: r["shape"] == [[2, 4096, 8, 40]] * 2),
    "flash_attention_backward_f32": dict(
        route="cuda",
        source="unirenderer_tpu_torch/csrc/flash_attention_bwd_f32.cu",
        replaces="unirenderer_tpu/ops/flash_attention.py:68",
        headline=lambda r: r["shape"] == [[2, 4096, 8, 40]] * 2),
    "splash_attention_f32": dict(
        route="cuda",
        source="unirenderer_tpu_torch/csrc/flash_attention_f32.cu",
        replaces="unirenderer_tpu/ops/flash_attention.py:99",
        headline=lambda r: r["shape"] == [[2, 4096, 8, 40]] * 2),
    "attn_kernel_f32": dict(
        route="cuda",
        source="unirenderer_tpu_torch/csrc/flash_attention_f32.cu",
        replaces="unirenderer_tpu/ops/attn_kernel.py:48",
        headline=lambda r: (r["shape"] == [[2, 4096, 8, 40]] * 2
                            and r["options"] == {})),
}


# ---------------------------------------------------------------------------
# Phase 14: DP, FSDP and TP on torch.distributed; the SD-v1.4 weight port;
# activation introspection
# ---------------------------------------------------------------------------

DIST_REL = 1e-3                  # wrapped train step vs unwrapped: loss, norm
# (a)'s variants in order: each AdamW one against the unwrapped AdamW step,
# each Adafactor one against the unwrapped Adafactor step
DIST_VARIANTS = ("unwrapped", "dp", "fsdp", "tp_fsdp", "unwrapped_adafactor",
                 "fsdp_adafactor", "tp_fsdp_adafactor")
DIST_WARM_ROUNDS = 2             # timed forward + inverse steps after them
GLOO_COS = 0.999                 # 2 gloo ranks vs one process: grad cosine
GLOO_TIMEOUT_S = 300             # both gloo processes (they take ~25-40 s)
INTROSPECT_REL = 2.0 ** -7       # the first scope past this, forward order
SD_CLI_STEPS = 2


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def smooth_maps(torch, F, gen, batch, res):
    """The 8 training maps, smooth fields in [-1, 1] on the card."""
    from unirenderer_tpu_torch.train.train_step import BATCH_KEYS
    out = {}
    for k in BATCH_KEYS:
        z = torch.randn((batch, 3, 16, 16), generator=gen, device="cuda")
        z = F.interpolate(z, size=(res, res), mode="bilinear",
                          align_corners=False)
        out[k] = torch.tanh(z).permute(0, 2, 3, 1).contiguous()
    return out


def with_adafactor(cfg):
    import dataclasses
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer="adafactor"))


def masters_on_host(state):
    """The full f32 masters of a TrainState, copied to the host one tensor
    at a time."""
    sh = state.sharding
    return {n: (p.detach() if sh is None else sh.gather(n, p.detach())).to(
        "cpu", copy=True) for n, p in state.params.items()}


def adafactor_stats_on_host(state):
    """{(name, v | v_row | v_col): the statistic on the host} of an
    Adafactor whose masters are whole (world 1)."""
    opt = state.optimizer
    return {(n, k): v.to("cpu", copy=True) for n, p in state.params.items()
            for k, v in opt.state[p].items() if k != "step"}


def max_rel_err(torch, got, want) -> float:
    """The largest over tensors of |got - want| / |want| (norms), on the
    card: a step's few elements whose gradient is within float noise of
    zero move a sign-like update (AdamW's first, Adafactor's unfactored)
    either way, which a per-element maximum would count."""
    errs = []
    for k, w in want.items():
        w, g = w.to("cuda"), got[k].to("cuda")
        errs.append(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w).clamp_min(1e-30))
    return float(torch.stack(errs).max())


def distributed_steps(torch, F, cfg, checked):
    """(a): one process, an NCCL group of one rank; the unwrapped flagship
    step and its DP, FSDP and TP+FSDP wrappings on the same weights,
    batches and draws, forward / inverse / forward / inverse; then the
    unwrapped step, FSDP and TP+FSDP with Adafactor."""
    import torch.distributed as dist
    from unirenderer_tpu_torch.diffusion.schedule import DiffusionSchedule
    from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
    from unirenderer_tpu_torch.models.vae import AutoencoderKL
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.train_step import (
        create_train_state, draw, make_train_step, train_step_launches,
    )
    from unirenderer_tpu_torch.train.trainer import _build
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh1, mesh2 = pm.make_mesh(), pm.make_mesh_2d(1, 1)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        with torch.device("meta"):
            vae = AutoencoderKL(cfg.vae)
        vae = _build(vae, "cuda", torch.bfloat16, gen).eval()
        vae.requires_grad_(False)
        ctx = torch.randn((1, cfg.text.max_length,
                           cfg.unet.cross_attention_dim), generator=gen,
                          device="cuda").to(torch.bfloat16)
        schedule = DiffusionSchedule.create(cfg.diffusion, "cuda")
        res, b = cfg.vae.sample_size, 2
        h = res // cfg.vae.downscale
        # two compared steps, each from the initial weights, then warm
        # steps (timed, from the weights the steps reach)
        kinds = (False, True) + (False, True) * DIST_WARM_ROUNDS
        batches = [smooth_maps(torch, F, gen, b, res) for _ in kinds]
        counted = ("groupnorm_silu", "flash_attention",
                   "flash_attention_backward")
        out = {}
        for variant in DIST_VARIANTS:
            kind = variant.removesuffix("_adafactor")
            adafactor = kind != variant
            vcfg = with_adafactor(cfg) if adafactor else cfg
            if kind == "unwrapped":   # the reference of what follows
                ref = ref_warm = ref_params = ref_stats = None
            t = time.perf_counter()
            with torch.device("meta"):
                dual = DualStreamModel(cfg.unet)
            dual = _build(dual, "cuda", torch.float32, torch.Generator(
                device="cuda").manual_seed(SEED)).train()
            base = make_train_step(vcfg, dual, vae, schedule, torch.bfloat16)
            if kind == "unwrapped":
                step, state = base, create_train_state(vcfg, dual)
            elif kind in ("dp", "fsdp"):
                step, state = pm.make_sharded_train_step(
                    vcfg, dual, base, mesh1, fsdp=kind == "fsdp")
            else:
                step, state = pm.make_tp_train_step(vcfg, dual, base, mesh2,
                                                    fsdp=True)
            sh = state.sharding
            sharded = 0 if sh is None else len(sh.layout)
            # the initial weights, copied to the host (the peak stays the
            # step's own)
            init = {n: p.detach().to("cpu", copy=True) for n, p in (
                state.params if sh is None
                else sh.full_params(state.params)).items()}
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            torch.cuda.reset_peak_memory_stats()
            rows = []
            for i, inverse in enumerate(kinds):
                if i < 2:                 # the compared steps: same weights
                    with torch.no_grad():
                        if sh is None:
                            for n, p in state.params.items():
                                p.copy_(init[n])
                        else:
                            sh.load_full_(state.params, init)
                draws = draw(torch.Generator().manual_seed(SEED + i), b,
                             (h, h), cfg.diffusion.num_train_timesteps,
                             inverse).to("cuda")
                torch.cuda.synchronize()
                reset_counters()
                t = time.perf_counter()
                metrics = step(state, ctx, batches[i], draws)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches, seen = read_counters()
                train_launch_check(launches, seen, {
                    k: train_step_launches(cfg, b, inverse)[k]
                    for k in counted}, checked, f"{variant} step {i + 1}")
                rows.append(dict(inverse=inverse, wall_s=wall,
                                 loss=float(metrics["loss"]),
                                 grad_norm=float(metrics["grad_norm"]),
                                 launches={k: launches[k] for k in counted}))
                if i == 1:              # the masters after the compared steps
                    params = masters_on_host(state)
                    stats = (adafactor_stats_on_host(state) if adafactor
                             else None)
            peak = torch.cuda.max_memory_allocated()
            held = torch.cuda.memory_allocated()   # between steps
            if ref is None:
                ref, ref_params, ref_stats = rows, params, stats
            errs = [max(abs(r["loss"] - q["loss"]) / abs(q["loss"]),
                        abs(r["grad_norm"] - q["grad_norm"]) / q["grad_norm"])
                    for r, q in zip(rows[:2], ref[:2])]
            params_err = max_rel_err(torch, params, ref_params)
            errs.append(params_err)
            stats_err = (max_rel_err(torch, stats, ref_stats) if adafactor
                         else None)
            del params, stats
            warm = {kind: min(r["wall_s"] for r in rows[2:]
                              if r["inverse"] == (kind == "inverse"))
                    for kind in ("forward", "inverse")}
            log(f"  {variant}: {sharded} tensors sharded, built in "
                f"{build_s:.1f} s; from the same weights: forward loss "
                f"{rows[0]['loss']:.6g}, grad norm {rows[0]['grad_norm']:.6g}"
                f", inverse loss {rows[1]['loss']:.6g}, grad norm "
                f"{rows[1]['grad_norm']:.6g}: max rel err vs unwrapped "
                f"{max(errs):.2e} (updated masters {params_err:.2e}"
                + ("" if stats_err is None else
                   f"; Adafactor's statistics {stats_err:.2e}, not gated: "
                   "they follow the bf16 gradients") +
                f"); cold {rows[0]['wall_s']:.3f} / "
                f"{rows[1]['wall_s']:.3f} s, warm (best of "
                f"{DIST_WARM_ROUNDS}) {warm['forward']:.3f} / "
                f"{warm['inverse']:.3f} s (forward / inverse; unwrapped "
                f"{ref_warm['forward'] if ref_warm else warm['forward']:.3f}"
                f" / {ref_warm['inverse'] if ref_warm else warm['inverse']:.3f}"
                f"); peak {peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB held "
                f"between steps")
            if ref_warm is None:
                ref_warm = warm
            check(all(math.isfinite(r["loss"]) for r in rows),
                  f"{variant}: a non-finite loss")
            check(max(errs) <= DIST_REL, f"{variant}: loss, grad norm or "
                  f"updated masters {max(errs):.3g} from the unwrapped "
                  f"step's")
            out[variant] = dict(steps=rows, peak_bytes=peak, held_bytes=held,
                                sharded=sharded,
                                build_s=build_s, max_rel_err=max(errs),
                                params_rel_err=params_err,
                                stats_rel_err=stats_err,
                                warm_forward_s=warm["forward"],
                                warm_inverse_s=warm["inverse"])
            del dual, base, step, state, metrics, init
            torch.cuda.empty_cache()
        gib = {v: out[v]["peak_bytes"] / 2 ** 30 for v in out}
        log(f"  peak memory at world 1: AdamW {gib['unwrapped']:.2f}, "
            f"Adafactor {gib['unwrapped_adafactor']:.2f}, FSDP+AdamW "
            f"{gib['fsdp']:.2f}, FSDP+Adafactor {gib['fsdp_adafactor']:.2f}, "
            f"TP+FSDP+Adafactor {gib['tp_fsdp_adafactor']:.2f} GiB")
        return out
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def gloo_rank(rank: int, port: int, out: str) -> int:
    """(b), one of two processes on the one card: small() r05 weights,
    data-parallel over a gloo group, the global batch of 4 split 2 + 2;
    rank 0 also takes the single-process step's gradients."""
    import tempfile
    import torch
    import torch.distributed as dist
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.compare import (
        small_weights, smooth_batch, trainer_with,
    )
    from unirenderer_tpu_torch.train.train_step import (
        BATCH_KEYS, draw, make_grad_fn,
    )
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    cfg = config.small()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tr = trainer_with(cfg, small_weights(), "cuda", torch.bfloat16, tmp)
        sh = tr.state.sharding
        batch = {k: v.cuda() for k, v in smooth_batch(cfg, 4, SEED).items()}
        h = cfg.vae.sample_size // cfg.vae.downscale
        grad_fn = make_grad_fn(cfg, tr.dual, tr.vae, tr.schedule,
                               tr.compute_dtype)
        for inverse in (False, True):
            draws = draw(torch.Generator().manual_seed(SEED), 4, (h, h),
                         cfg.diffusion.num_train_timesteps, inverse)
            draws = draws.to("cuda")
            if rank == 0:
                g1, m1 = grad_fn(tr.state.params, batch, tr.ctx, draws)
                ref = (torch.cat([g.flatten().double() for g in g1]),
                       float(m1["loss"]))
            sl = pm.host_local_batch_slice(4, tr.mesh)
            local = pm.slice_draws(draws, sl, len(BATCH_KEYS))
            grads, metrics = grad_fn(
                sh.compute_params(tr.state.params, tr.compute_dtype),
                {k: v[sl] for k, v in batch.items()}, tr.ctx, local,
                sh.contrastive_scale)
            grads = sh.reduce_grads(grads)
            loss = float(sh.mean_metrics(metrics)["loss"])
            # the trainer's sharded step on the same global batch and draws
            step_loss = float(tr._step(tr.state, tr.ctx, batch,
                                       draws)["loss"])
            if rank == 0:
                flat = torch.cat([g.flatten().double() for g in grads])
                cos = float(flat @ ref[0] / (flat.norm() * ref[0].norm()))
                res["inverse" if inverse else "forward"] = dict(
                    loss=loss, step_loss=step_loss, loss_ref=ref[1],
                    grad_cos=cos, grad_norm=float(flat.norm()),
                    grad_norm_ref=float(ref[0].norm()))
        res["adafactor"] = gloo_adafactor(torch, cfg, batch, h, tmp)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
    return 0


def gloo_adafactor(torch, cfg, batch, h, tmp):
    """(b) with Adafactor: a Trainer with FSDP over the two gloo ranks
    (small() r05 weights; the big kernels split, their factored statistics
    made whole over the ranks).  Its step's loss against one process's;
    then the sharded optimizer alone, fed rank 0's single-process
    gradients of a forward and an inverse step, against one process's
    Adafactor fed the same: every master and statistic."""
    import torch.distributed as dist
    from torch import nn
    from unirenderer_tpu_torch.parallel import mesh as pm
    from unirenderer_tpu_torch.train.compare import (
        small_weights, trainer_with,
    )
    from unirenderer_tpu_torch.train.train_step import (
        draw, make_grad_fn, make_lr_schedule, make_optimizer,
    )
    rank = dist.get_rank()
    acfg = with_adafactor(cfg)
    tr = trainer_with(acfg, small_weights(), "cuda", torch.bfloat16,
                      os.path.join(tmp, "adafactor"), fsdp=True)
    sh = tr.state.sharding
    init = {n: t.detach().clone()
            for n, t in sh.full_params(tr.state.params).items()}
    grad_fn = make_grad_fn(acfg, tr.dual, tr.vae, tr.schedule,
                           tr.compute_dtype)
    grads = []
    for inverse in (False, True):
        draws = draw(torch.Generator().manual_seed(SEED + 1), 4, (h, h),
                     acfg.diffusion.num_train_timesteps, inverse).to("cuda")
        if rank == 0:                     # one process's step, whole masters
            g, m = grad_fn({n: t.detach().requires_grad_()
                            for n, t in init.items()}, batch, tr.ctx, draws)
            if not inverse:
                loss_ref = float(m["loss"])
        else:
            g = [torch.empty_like(t) for t in init.values()]
        pm.replicate(g)                   # rank 0's gradients on both
        grads.append(dict(zip(init, g)))
        if not inverse:                   # the Trainer's sharded step
            step_loss = float(tr._step(tr.state, tr.ctx, batch,
                                       draws)["loss"])
    # the sharded optimizer and one process's, fed the same gradients
    masters = {n: nn.Parameter(sh.local(n, init[n]).clone()) for n in init}
    opt = sh.optimizer(acfg, masters)
    whole = {n: nn.Parameter(init[n].clone()) for n in init}
    ref_opt = make_optimizer(acfg, whole, sh.perms)
    lr = make_lr_schedule(acfg)
    for i, g in enumerate(grads):
        for n in init:
            masters[n].grad = sh.local(n, g[n])
            whole[n].grad = g[n]
        for o in (opt, ref_opt):
            for group in o.param_groups:
                group["lr"] = lr(i)
            o.step()
    full = sh.full_params(masters)
    stats = sh.full_optimizer_state(opt.state_dict())["state"]
    split = sum(1 for n in init if sh.split(n) is not None)
    out = None
    if rank == 0:
        ref_stats = ref_opt.state_dict()["state"]
        params_err = max(float(
            (full[n] - whole[n]).abs().max()
            / (whole[n] - init[n]).abs().max().clamp_min(1e-30))
            for n in init)
        stats_err = max(float(
            (stats[i][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            for i, st in ref_stats.items() for k, v in st.items()
            if k != "step")
        out = dict(loss=step_loss, loss_ref=loss_ref, split=split,
                   update_rel_err=params_err, stats_rel_err=stats_err)
    return out


def gloo_two_ranks(torch):
    """(b): two processes through gloo on the one card (NCCL will not put
    two ranks on one device)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gloo.json")
        port = free_port()
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo-rank",
             str(r), "--gloo-port", str(port), "--gloo-out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=GLOO_TIMEOUT_S)[0] for p in procs]
        finally:                # a rank left waiting on a dead peer
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for r, (p, text) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"gloo rank {r} exited {p.returncode}:"
                  f"\n{text[-3000:]}")
        with open(out) as f:
            res = json.load(f)
    ada = res.pop("adafactor")
    for branch, r in res.items():
        rel = abs(r["loss"] - r["loss_ref"]) / abs(r["loss_ref"])
        step_rel = abs(r["step_loss"] - r["loss_ref"]) / abs(r["loss_ref"])
        log(f"  2 gloo ranks, small() {branch} step over a global batch of "
            f"4: loss {r['loss']:.6g} (the step's {r['step_loss']:.6g}) vs "
            f"one process {r['loss_ref']:.6g} (rel {max(rel, step_rel):.2e},"
            f" limit {DIST_REL}), gradient cosine {r['grad_cos']:.6f} "
            f"(>= {GLOO_COS}), norms {r['grad_norm']:.5g} / "
            f"{r['grad_norm_ref']:.5g}")
        check(max(rel, step_rel) <= DIST_REL and r["grad_cos"] >= GLOO_COS,
              f"2 gloo ranks disagree with one process ({branch})")
    rel = abs(ada["loss"] - ada["loss_ref"]) / abs(ada["loss_ref"])
    log(f"  2 gloo ranks, small(), Adafactor over FSDP masters "
        f"({ada['split']} tensors split): the Trainer's forward step's loss "
        f"{ada['loss']:.6g} vs one process {ada['loss_ref']:.6g} (rel "
        f"{rel:.2e}); fed the same gradients for 2 steps, the sharded "
        f"optimizer's masters {ada['update_rel_err']:.2e} of the update and "
        f"its statistics {ada['stats_rel_err']:.2e} from one process's "
        f"(limit {DIST_REL})")
    check(ada["split"] > 0 and max(rel, ada["update_rel_err"],
                                   ada["stats_rel_err"]) <= DIST_REL,
          "2 gloo ranks: Adafactor over FSDP masters disagrees with one "
          "process")
    log(f"  2 gloo ranks: {wall:.1f} s for both processes")
    return dict(branches=res, adafactor=ada, wall_s=wall)


def sd_port(torch, cfg):
    """(c): random SD-v1.4-shaped diffusers files (fp16 .bin), ported on the
    card with both inits, then the training CLI's --sd-* path."""
    import tempfile
    from unirenderer_tpu_torch.models import surgery
    from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder
    from unirenderer_tpu_torch.models.dual_stream import ImageUNet
    from unirenderer_tpu_torch.models.vae import AutoencoderKL
    maps = {"unet": (ImageUNet, cfg.unet, surgery.unet_path_map),
            "vae": (AutoencoderKL, cfg.vae, surgery.vae_path_map),
            "text": (CLIPTextEncoder, cfg.text, surgery.clip_path_map)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        paths, sds, nbytes = {}, {}, 0
        t = time.perf_counter()
        for part, (cls, sub, path_map) in maps.items():
            with torch.device("meta"):
                mod = cls(sub)
            sd = {path_map(n): (0.05 * torch.randn(
                p.shape, generator=gen, device="cuda")).half().cpu()
                for n, p in mod.named_parameters()}
            paths[part] = os.path.join(tmp, f"{part}.bin")
            torch.save(sd, paths[part])
            nbytes += os.path.getsize(paths[part])
            sds[part] = sd
        write_s = time.perf_counter() - t
        log(f"  SD-v1.4-shaped fp16 files: "
            + ", ".join(f"{k} {len(v)} keys" for k, v in sds.items())
            + f", {nbytes / 1e9:.2f} GB written in {write_s:.1f} s")
        ported = {}
        for fast in (True, False):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loaded = {k: surgery.load_torch_state_dict(p)
                      for k, p in paths.items()}
            ported[fast] = surgery.port_sd_checkpoint(
                loaded["unet"], loaded["vae"], loaded["text"], cfg,
                device="cuda", fast_init=fast)
            torch.cuda.synchronize()
            out[f"port_s_fast_init_{fast}"] = time.perf_counter() - t
            del loaded
        dual, vae, text = ported[True]
        mismatched = []
        for part, mod in (("unet", dual.unet), ("vae", vae),
                          ("text", text)):
            path_map = maps[part][2]
            for n, p in mod.named_parameters():
                want = sds[part][path_map(n)].to("cuda", torch.float32)
                if not torch.equal(p, want):
                    mismatched.append(f"{part}.{n}")
        check(not mismatched, f"ported tensors differ from the files: "
              f"{mismatched[:3]}")
        u = sds["unet"]
        w_in = u["conv_in.weight"].to("cuda", torch.float32)
        w_out = u["conv_out.weight"].to("cuda", torch.float32)
        b_out = u["conv_out.bias"].to("cuda", torch.float32)
        check(torch.equal(dual.controlnet.conv_in.weight,
                          w_in.repeat(1, 7, 1, 1) * 0.142)
              and torch.equal(dual.controldec.conv_out.weight,
                              w_out.repeat(7, 1, 1, 1) * 0.142)
              and torch.equal(dual.controldec.conv_out.bias,
                              b_out.repeat(7) * 0.142),
              "the inflated convs are not the tiled kernels x 0.142")
        zeros = [n for n, p in dual.named_parameters()
                 if n.split(".")[1].startswith(("zero_", "control_"))]
        check(zeros and all(not dual.get_parameter(n).any() for n in zeros),
              "a zero conv is not zero")
        slow = ported[False]
        differ = [n for a, b in zip((dual, vae, text), slow)
                  for (n, p), (_, q) in zip(a.named_parameters(),
                                            b.named_parameters())
                  if not torch.equal(p, q)]
        check(not differ, f"fast_init=True and False differ: {differ[:3]}")
        n_params = sum(p.numel() for m in (dual, vae, text)
                       for p in m.parameters())
        log(f"  port_sd_checkpoint on the card: {n_params / 1e9:.3f} B f32 "
            f"params, fast_init {out['port_s_fast_init_True']:.1f} s, "
            f"PyTorch's initialisers {out['port_s_fast_init_False']:.1f} s; "
            f"every mapped tensor the file's, the inflated convs tiled x "
            f"0.142, {len(zeros)} zero-conv tensors zero, both inits the "
            f"same bits")
        del ported, dual, vae, text, slow
        torch.cuda.empty_cache()
        work = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "unirenderer_tpu_torch.train",
               "--workdir", work, "--synthetic", "--steps",
               str(SD_CLI_STEPS), "--optimizer", "adafactor",
               "--sd-unet", paths["unet"], "--sd-vae", paths["vae"],
               "--sd-text", paths["text"]]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        out["cli_s"] = time.perf_counter() - t
        check(proc.returncode == 0, f"the --sd-* CLI exited "
              f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        ckpt = os.path.join(work, "checkpoints",
                            f"checkpoint-{SD_CLI_STEPS}", "params.npz")
        with open(os.path.join(work, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        check(os.path.exists(ckpt) and losses
              and all(math.isfinite(v) for v in losses),
              f"the --sd-* CLI: checkpoint {os.path.exists(ckpt)}, losses "
              f"{losses}")
        log(f"  python -m unirenderer_tpu_torch.train --sd-* --synthetic "
            f"--steps {SD_CLI_STEPS} (flagship, Adafactor): exit 0 in "
            f"{out['cli_s']:.1f} s, logged losses {losses}, "
            f"{os.path.getsize(ckpt) / 1e9:.2f} GB params npz")
        out.update(files_bytes=nbytes, write_s=write_s, cli_losses=losses)
    return out


def introspection(torch):
    """(d): one UNet-stream forward of small() (r05 weights) at a seeded
    input, bf16 on the card, bf16 and f32 on the CPU, every submodule's
    output captured."""
    import numpy as np
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.models.introspect import (
        capture_activations, diff_activations,
    )
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    from unirenderer_tpu_torch.train.compare import small_weights
    cfg = config.small()
    dual_flat = small_weights()["dual"]
    g = torch.Generator().manual_seed(SEED + 7)
    u, s, b = cfg.unet, cfg.unet.sample_size, 2
    img = torch.randn((b, s, s, u.in_channels), generator=g)
    attr = torch.randn((b, s, s, u.attr_channels), generator=g)
    ctx = torch.randn((b, cfg.text.max_length, u.cross_attention_dim),
                      generator=g)
    t_img = torch.tensor([999, 400])
    acts, ctrl = {}, None
    for name, device, dtype in (("cpu-f32", "cpu", torch.float32),
                                ("cpu-bf16", "cpu", torch.bfloat16),
                                ("card-bf16", "cuda", torch.bfloat16)):
        pipe = UniRendererPipeline.create(
            cfg, torch.Generator(device=device).manual_seed(SEED),
            device=device, dtype=dtype)
        pipe.load_flax(dual=dual_flat)
        if ctrl is None:        # the attribute encoder's residuals, f32
            with torch.no_grad():
                ctrl = pipe.dual.encode_attr(attr, torch.zeros(
                    b, dtype=torch.long), ctx)
        down, mid = ctrl
        t = time.perf_counter()
        acts[name] = capture_activations(
            pipe.dual.unet, img.to(device), t_img.to(device),
            ctx.to(device, dtype), tuple(d.to(device) for d in down),
            mid.to(device))
        log(f"  captured {len(acts[name])} scopes ({name}) in "
            f"{time.perf_counter() - t:.2f} s")
        del pipe
    keys = [set(a) for a in acts.values()]
    check(keys[0] == keys[1] == keys[2], "the captures' scopes differ")
    check(all(np.isfinite(v).all() for a in acts.values() for v in a.values()
              if hasattr(v, "shape")), "a captured activation is not finite")
    out = {}
    for name, ref, got in (("card_bf16_vs_cpu_bf16", "cpu-bf16",
                            "card-bf16"),
                           ("cpu_bf16_vs_cpu_f32", "cpu-f32", "cpu-bf16")):
        a, bb = acts[ref], acts[got]
        rows = diff_activations(a, bb, top_k=10)
        first = None
        for k in a:                      # forward (completion) order
            if not hasattr(a[k], "shape"):
                continue
            d = float(np.abs(np.asarray(a[k], np.float32)
                             - np.asarray(bb[k], np.float32)).max())
            if d > INTROSPECT_REL * max(float(np.abs(a[k]).max()), 1e-8):
                first = (k, d / max(float(np.abs(a[k]).max()), 1e-8))
                break
        log(f"  {name}: 10 worst scopes (max|d|, rel):")
        for k, d, r in rows:
            print(f"    {k}: {d:.4g} {r:.4g}", flush=True)
        log(f"  {name}: first scope past 2^-7 in forward order: "
            + (f"{first[0]} (rel {first[1]:.4g})" if first else "none"))
        out[name] = dict(worst=rows, first_past=first,
                         out_rel=next(r for k, d, r in diff_activations(
                             a, bb, top_k=len(a)) if k == "__call__#0"))
        log(f"  {name}: the UNet output's rel diff {out[name]['out_rel']:.4g}")
    return out


def phase_distributed(torch, F, cfg, checked):
    out = {}
    for part, fn in (("a", lambda: distributed_steps(torch, F, cfg, checked)),
                     ("b", lambda: gloo_two_ranks(torch)),
                     ("c", lambda: sd_port(torch, cfg)),
                     ("d", lambda: introspection(torch))):
        t = time.perf_counter()
        log(f"  ({part}) " + {
            "a": "NCCL, world 1: the flagship step unwrapped, DP, FSDP, "
                 "TP+FSDP on a (1, 1) mesh; unwrapped, FSDP, TP+FSDP with "
                 "Adafactor",
            "b": "2 ranks on the one card through gloo, small(): DP; FSDP "
                 "with Adafactor",
            "c": "the SD-v1.4 weight port at flagship width",
            "d": "activation introspection, small() r05 weights"}[part])
        out[part] = fn()
        out[part + "_s"] = time.perf_counter() - t
        log(f"  ({part}) done in {out[part + '_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: f32 on the card
# ---------------------------------------------------------------------------

F32_GN_REL = 2.0 ** -16          # K1 f32 vs plain, rel. to max|ref|
F32_ATTN_REL = 2.0 ** -14        # K2 / K2s / K3 f32 vs plain
F32_LSE_ABS = 2.0 ** -16         # K2 f32's log-sum-exp, absolute
F32_BWD_REL = 2.0 ** -12         # K2 bwd f32: dQ, dK, dV and a rerun
F32_MODEL_REL = 1e-4             # small() model eval, card vs CPU, f32
F32_RENDER_REL = 1e-3            # small() 20-step render, same noise
F32_ROUTE_REL = 1e-3             # the splash / unet_flash route's render
F32_TRAIN_LOSS_REL = 1e-4        # small() train step, card vs CPU, f32
F32_TRAIN_GRAD_COS = 0.99999
F32_TRAIN_NORM_REL = 1e-4
VAE_RECON_DB = 0.01              # VAE PSNR, card vs CPU, same draw
VAE_RECON_OBJECTS = 4
F32_RAGGED_GN = (((2, 37, 29, 36), 4, 1e-6, True),
                 ((1, 33, 31, 1920), 32, 1e-6, False))
F32_RAGGED_ATTN = (((2, 1000, 8, 40), (2, 333, 8, 40)),
                   ((1, 77, 3, 24), (1, 200, 3, 24)))
F32_HEADLINE_ATTN = ((2, 4096, 8, 40), (2, 4096, 8, 40))
# the three-pass TF32 tensor-core kernels (csrc/mma_tf32.cuh)
F32_TC_SOURCES = ("flash_attention_f32", "flash_attention_bwd_f32")


def gn_case_f32(torch, F, timer, gen, case, param_dtype="float32"):
    """K1's f32 form at one call signature: error against the plain
    version on the same f32 inputs, a rerun that must give the same bits,
    the launch plan's branch, and the times.  A case on the cluster branch
    is the cluster kernel's (csrc/groupnorm_f32.cu, `groupnorm_silu_f32`);
    one on the cooperative kernel's f32 instance is
    `groupnorm_silu_f32_cooperative`."""
    from unirenderer_tpu_torch.ops import groupnorm as gn
    shape, groups, eps, silu = case
    c = shape[-1]
    pdt = getattr(torch, param_dtype)
    x = torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5
    scale = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
             ).to(pdt)
    bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(pdt)
    fn = gn.fused_groupnorm_silu
    y = fn(x, scale, bias, groups, eps, silu)
    again = fn(x, scale, bias, groups, eps, silu)
    torch.cuda.synchronize()          # a fault here is the kernel's
    ref = gn.groupnorm_silu_reference(x, scale, bias, groups, eps, silu)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = F32_GN_REL * ref.abs().max().item()
    rerun_equal = bool(torch.equal(y, again))
    del ref, y, again
    xc = x.permute(0, 3, 1, 2)
    w32, b32 = scale.float(), bias.float()

    def library():
        out = F.group_norm(xc, groups, w32, b32, eps)
        return F.silu(out) if silu else out

    ms = timer(lambda: fn(x, scale, bias, groups, eps, silu))
    plain_ms = timer(lambda: gn.groupnorm_silu_reference(x, scale, bias,
                                                         groups, eps, silu))
    library_ms = timer(library)
    nbytes = x.numel() * 4
    bound_ms = ((2 * nbytes + 2 * c * scale.element_size())
                / HBM_BYTES_PER_S * 1e3)
    plan = gn.plan(shape, groups, torch.float32, pdt)
    kernel = ("groupnorm_silu_f32" if plan["branch"] == "cluster"
              else "groupnorm_silu_f32_cooperative")
    return dict(kernel=kernel, shape=list(shape),
                groups=groups, eps=eps, silu=silu, param_dtype=param_dtype,
                rerun_bit_identical=rerun_equal, branch=plan["branch"],
                ctas=plan.get("ctas"),
                ok=err <= tol and rerun_equal, max_abs_err=err, tol=tol,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes")


def attn_bound_f32(torch, qs, ks, forward=True):
    """The least time for attention over f32 (q shape, k shape): the
    largest of the bytes (q, k, v read and o written once; the backward
    also o and dO read, dQ, dK, dV written and the log-sum-exp read), the
    f32-accurate products (4 Sq Sk D flops a (batch, head) forward, 10
    backward: the five products) and, forward, one exp a score.  The
    products take the lesser of two times: f32 FMAs on the CUDA cores
    (67 TFLOP/s) and three TF32 passes on the tensor cores (495 / 3
    TFLOP/s, the kernels' route), both returned beside the parts."""
    b, sq, h, d = qs
    sk = ks[1]
    q_n, k_n = b * sq * h * d, b * sk * h * d
    flops = (4.0 if forward else 10.0) * b * h * sq * sk * d
    ops = {"f32_fma": flops / FP32_FLOPS * 1e3,
           "tf32x3": 3 * flops / TF32_FLOPS * 1e3}
    parts = {"operations": min(ops.values())}
    if forward:
        parts.update(bytes=4.0 * (2 * q_n + 2 * k_n) / HBM_BYTES_PER_S * 1e3,
                     exp2=b * h * sq * sk / exp2_rate(torch) * 1e3)
    else:
        parts["bytes"] = ((4.0 * (4 * q_n + 4 * k_n) + 4 * b * h * sq)
                          / HBM_BYTES_PER_S * 1e3)
    return parts, ops


def attn_case_f32(torch, F, timer, gen, case, kernel="flash_attention",
                  **options):
    """The f32 form of K2 (with its log-sum-exp), K2s or K3 (with
    `options`) at (q shape, k shape): error against its plain version on
    the same f32 inputs (its Q pre-scale rounded to f32, as the kernel's
    caller rounds it), a rerun that must give the same bits, and the
    times."""
    from unirenderer_tpu_torch.ops.flash_attention import (
        attention_lse_reference, flash_attention_with_lse,
    )
    fn, reference = _attention_kernels()[kernel]
    ref_options = {k: v for k, v in options.items() if k == "running_max"}
    qs, ks = case
    q = torch.randn(qs, generator=gen, device="cuda")
    k = torch.randn(ks, generator=gen, device="cuda")
    v = torch.randn(ks, generator=gen, device="cuda")
    o = fn(q, k, v, **options)
    again = fn(q, k, v, **options)
    torch.cuda.synchronize()          # a fault here is the kernel's
    ref = reference(q, k, v, **ref_options)
    torch.cuda.synchronize()
    err = (o - ref).abs().max().item()
    tol = F32_ATTN_REL * ref.abs().max().item()
    rerun_equal = bool(torch.equal(o, again))
    del again
    out = dict(kernel=f"{kernel}_f32", shape=[list(qs), list(ks)],
               options=options, max_abs_err=err, tol=tol,
               rerun_bit_identical=rerun_equal)
    ok = err <= tol and rerun_equal
    if kernel == "flash_attention":
        o2, lse = flash_attention_with_lse(q, k, v)
        lse_err = (lse - attention_lse_reference(q, k, v)[1]
                   ).abs().max().item()
        same_o = bool(torch.equal(o, o2))
        out.update(lse_err=lse_err, lse_tol=F32_LSE_ABS,
                   lse_bit_identical_o=same_o)
        ok = ok and lse_err <= F32_LSE_ABS and same_o
        del o2, lse
    del ref, o
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    parts, ops = attn_bound_f32(torch, qs, ks)
    bound_by = max(parts, key=parts.get)
    out.update(ok=ok, ms=timer(lambda: fn(q, k, v, **options)),
               plain_ms=timer(lambda: reference(q, k, v, **ref_options)),
               library_ms=timer(
                   lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               bound_ms=parts[bound_by], bound_by=bound_by,
               bound_parts=parts, op_bounds=ops)
    return out


def attn_bwd_case_f32(torch, F, timer, gen, case):
    """K2 bwd's f32 form at (q shape, k shape): dQ, dK, dV against the
    plain backward on the same f32 inputs and the f32 forward's O and
    log-sum-exp, a second run that must give the same bits (no atomics),
    and the times."""
    from unirenderer_tpu_torch.ops.flash_attention import (
        attention_backward_reference, flash_attention_backward,
        flash_attention_with_lse,
    )
    qs, ks = case
    q = torch.randn(qs, generator=gen, device="cuda")
    k = torch.randn(ks, generator=gen, device="cuda")
    v = torch.randn(ks, generator=gen, device="cuda")
    do = torch.randn(qs, generator=gen, device="cuda")
    o, lse = flash_attention_with_lse(q, k, v)
    got = flash_attention_backward(q, k, v, o, lse, do)
    again = flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = attention_backward_reference(q, k, v, o, lse, do)
    errs = {n: ((g - w).abs().max().item(),
                F32_BWD_REL * w.abs().max().item())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    rerun = max((g - a).abs().max().item() for g, a in zip(got, again))
    del got, again, want
    tol = min(t for _, t in errs.values())
    ok = all(e <= t for e, t in errs.values()) and rerun == 0.0
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
    parts, ops = attn_bound_f32(torch, qs, ks, forward=False)
    bound_by = max(parts, key=parts.get)
    return dict(kernel="flash_attention_backward_f32",
                shape=[list(qs), list(ks)], errs=errs, rerun_diff=rerun,
                ok=ok, max_abs_err=max(e for e, _ in errs.values()), tol=tol,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=parts[bound_by], bound_by=bound_by,
                bound_parts=parts, op_bounds=ops)


def f32_cases():
    """Phase 15 (a)'s cases: every K1 / K2 signature of small()'s paths in
    phase 15 (the harness's forward at batch 4 with the material image
    encoded, its inverse at batch 4 x ensemble 1, a train step at batch 2,
    the VAE eval's batch of 8 through encoder and decoder), the flagship
    headline shapes and ragged ones; the routes at small()'s tileable
    self-attention shapes and the flagship headline."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.ops.flash_attention import tileable
    from unirenderer_tpu_torch.pipelines import (
        KernelCalls, inverse_kernel_cases, kernel_cases,
    )
    from unirenderer_tpu_torch.train.train_step import train_kernel_cases
    cfg = config.small()
    res = cfg.vae.sample_size
    gn_cases, attn_cases = set(), set()
    train_gn, train_attn = train_kernel_cases(cfg, 2, res)
    vae = KernelCalls(cfg, res)
    vae.vae_encoder(8)
    vae.vae_decoder(8)
    for gn, attn in (kernel_cases(cfg, 4, res, True),
                     kernel_cases(cfg, 2, res, False),
                     inverse_kernel_cases(cfg, 4, res, 1),
                     (train_gn, train_attn), vae.signatures):
        gn_cases |= gn
        attn_cases |= attn
    routed = sorted((q, k) for q, k in attn_cases
                    if q == k and tileable(q[1], k[1], q[3]))
    routed.append(F32_HEADLINE_ATTN)
    return dict(
        gn=[(c, "float32") for c in sorted(gn_cases) + list(F32_RAGGED_GN)]
        + [(GN_HEADLINE, "float32"), (GN_HEADLINE, "bfloat16")],
        attn=sorted(attn_cases) + list(F32_RAGGED_ATTN) + [F32_HEADLINE_ATTN],
        routes=[("splash_attention", c, {}) for c in routed]
        + [("attn_kernel", c, f) for c in routed
           for f in ({}, {"running_max": False})]
        + [("attn_kernel", F32_RAGGED_ATTN[1][::-1], {})],
        bwd=sorted(train_attn) + list(F32_RAGGED_ATTN) + [F32_HEADLINE_ATTN],
        checked={"groupnorm_silu": gn_cases, "flash_attention": attn_cases})


def harness_kernel_calls():
    """`pipelines.KernelCalls` of one held-out harness run at small() in
    phase 15 (c): 32 objects in batches of 4, forward (material image
    encoded) and inverse at ensemble 1, 20 steps each."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.pipelines import KernelCalls
    cfg = config.small()
    calls = KernelCalls(cfg, cfg.vae.sample_size)
    for _ in range(32 // 4):
        calls.mask2image_3mod_albedo(4, 20, True)
        calls.real_image2mask_3mod_albedo(4, 20, 1)
    return calls


def f32_kernel_cases(torch, F, cases):
    """(a): every case, its inputs from one seeded generator in order."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    timer = Timer(torch)
    jobs = ([(f"groupnorm_silu f32 {c} params {p}",
              lambda c=c, p=p: gn_case_f32(torch, F, timer, gen, c, p))
             for c, p in cases["gn"]]
            + [(f"flash_attention f32 {c}",
                lambda c=c: attn_case_f32(torch, F, timer, gen, c))
               for c in cases["attn"]]
            + [(f"{n} f32 {c} {o}",
                lambda n=n, c=c, o=o: attn_case_f32(torch, F, timer, gen, c,
                                                    n, **o))
               for n, c, o in cases["routes"]]
            + [(f"flash_attention_backward f32 {c}",
                lambda c=c: attn_bwd_case_f32(torch, F, timer, gen, c))
               for c in cases["bwd"]])
    results = []
    for desc, job in jobs:
        try:
            r = job()
        except Exception:
            log(f"  raised while running {desc}")
            raise
        results.append(r)
        extra = ""
        if "groups" in r:
            extra = (f"g={r['groups']} eps={r['eps']:g} silu={int(r['silu'])}"
                     f" params {r['param_dtype']} rerun bit-identical "
                     f"{int(r['rerun_bit_identical'])} {r['branch']}"
                     + (f" x{r['ctas']} " if r['ctas'] else " "))
        elif "errs" in r:
            extra = (" ".join(f"{n} {e:.3g}/{t:.3g}"
                              for n, (e, t) in r["errs"].items())
                     + f" rerun diff {r['rerun_diff']:.3g} ")
        elif "lse_err" in r:
            extra = (f"lse {r['lse_err']:.3g}/{r['lse_tol']:.3g} o of the "
                     f"lse launch bit-identical "
                     f"{int(r['lse_bit_identical_o'])} ")
        if "rerun_bit_identical" in r and "groups" not in r:
            extra += f"rerun bit-identical {int(r['rerun_bit_identical'])} "
        if r.get("options"):
            extra += f"{r['options']} "
        log(f"  {r['kernel']:28s} {json.dumps(r['shape'])} {extra}"
            f"err={r['max_abs_err']:.3g} tol={r['tol']:.3g} "
            f"{'ok' if case_ok(r) else 'FAIL'}  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f}  library {r['library_ms']:.4f}  "
            f"ratio {r['ms'] / r['library_ms']:.2f}  bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}"
            + "".join(f"; {k} {v:.4f}"
                      for k, v in r.get("bound_parts", {}).items()) + ")"
            + ("".join(f" {k} {v:.4f}" for k, v in r["op_bounds"].items())
               if "op_bounds" in r else ""))
        torch.cuda.empty_cache()
    del timer
    bad = [r for r in results if not case_ok(r)]
    check(not bad, f"{len(bad)} f32 kernel case(s) out of tolerance")
    return results


K1_PROFILE_TIMEOUT_S = 300      # (a)'s fresh process for K1's profiles


def k1_profile_child(out: str) -> int:
    """The fresh process of `f32_cluster_route`: one profiled call of K1
    f32 at each distinct (shape, groups) of small()'s signatures, each in
    a session of its own with spin kernels before and after it (dropped),
    written to `out` as [shape, groups, [(kernel, count), ...]]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unirenderer_tpu_torch.ops.groupnorm import fused_groupnorm_silu
    sigs = sorted({(shape, groups) for shape, groups, _, _
                   in f32_cases()["checked"]["groupnorm_silu"]})
    res = []
    for shape, groups in sigs:
        x = torch.randn(shape, device="cuda")
        w = torch.ones(shape[-1], device="cuda")
        fused_groupnorm_silu(x, w, w, groups, 1e-5, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                torch.cuda._sleep(PAD_CYCLES // 100)
            torch.cuda.synchronize()
            time.sleep(0.05)
            fused_groupnorm_silu(x, w, w, groups, 1e-5, True)
            torch.cuda.synchronize()
            for _ in range(16):
                torch.cuda._sleep(PAD_CYCLES // 100)
            torch.cuda.synchronize()
        res.append([list(shape), groups,
                    [(e.key, e.count) for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0
                     and "spin_kernel" not in e.key]])
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def f32_cluster_route(torch, cases):
    """Every K1 signature of small()'s f32 paths (phase 15 (a)'s, which
    (c) holds the harness's calls to) is planned on the cluster branch,
    and a profiled call of each distinct (shape, groups) runs one device
    kernel, the cluster kernel's: no cooperative launch.  The profiles run
    in a fresh process (`k1_profile_child`): after the earlier phases'
    sessions, sessions in this process came back with some calls' device
    events missing (26 of 51 single-call sessions, and 42 events of 69
    calls in one session, on the H100)."""
    import tempfile
    from unirenderer_tpu_torch.ops.groupnorm import plan
    sigs = sorted(cases["checked"]["groupnorm_silu"])
    off = [s for s in sigs
           if plan(s[0], s[1], torch.float32, torch.float32)["branch"]
           != "cluster"]
    check(not off, f"K1 f32 signatures off the cluster branch: {off[:3]}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "k1_profiles.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--k1-profile-out",
             out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=K1_PROFILE_TIMEOUT_S)
        check(proc.returncode == 0, f"K1 profile process exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}")
        with open(out) as f:
            calls = json.load(f)
    bad = [(shape, groups, kernels) for shape, groups, kernels in calls
           if not (len(kernels) == 1 and kernels[0][1] == 1
                   and "gn_cluster_kernel" in kernels[0][0])]
    log(f"  K1 f32: {len(sigs)} small() signatures on the cluster branch; "
        f"{len(calls) - len(bad)} of {len(calls)} profiled calls (one a "
        f"distinct (shape, groups), in a fresh process) ran one device "
        f"kernel, gn_cluster_kernel")
    check(not bad, f"K1 f32 calls that are not one cluster kernel: "
          f"{bad[:2]}")
    return dict(signatures=len(sigs), profiled_calls=len(calls))


def f32_gn_branches(torch):
    """K1's f32 launch plans at every K1 signature of the small(),
    medium() and flagship forward, inverse and train paths: how many take
    each branch (the cluster kernel, or the cooperative one keeping x in
    shared memory or re-reading it), and which take the cooperative
    kernel."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.ops.groupnorm import plan
    from unirenderer_tpu_torch.pipelines import (
        inverse_kernel_cases, kernel_cases,
    )
    from unirenderer_tpu_torch.train.train_step import train_kernel_cases
    out = {}
    for name in ("small", "medium", "flagship"):
        cfg = getattr(config, name)()
        res = cfg.vae.sample_size
        sigs = (kernel_cases(cfg, 2, res, True)[0]
                | inverse_kernel_cases(cfg, 2, res, cfg.sampler.ensemble)[0]
                | train_kernel_cases(cfg, 2, res)[0])
        branch = {sig: plan(sig[0], sig[1], torch.float32,
                            torch.float32)["branch"] for sig in sigs}
        counts = {b: sum(v == b for v in branch.values())
                  for b in ("cluster", "cached", "re-read")}
        coop = sorted({sig[0] for sig, b in branch.items() if b != "cluster"})
        out[name] = dict(signatures=len(sigs), branches=counts,
                         cooperative=coop)
        log(f"  K1 f32 plans, {name}(): {len(sigs)} signatures, "
            + ", ".join(f"{n} {b}" for b, n in counts.items())
            + "; cooperative: " + (", ".join(str(s) for s in coop[:8])
                                   or "none")
            + (f" and {len(coop) - 8} more" if len(coop) > 8 else ""))
    return out


def f32_small_weights(torch, F, record):
    """(b): the trained small() weights in f32 on the card against f32 on
    the CPU: one forward and one inverse model evaluation, one 20-step
    forward render from the same noise, and the same render under the
    splash and unet_flash routes (K2s / K3 in f32) against the default
    route's."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.pipelines import forward_self_attention_calls
    cfg = config.small()
    card, host, _, _ = small_pipes(torch, torch.float32)
    g = torch.Generator().manual_seed(SEED)
    out = {}
    bf16 = record.get("small_weights", {})
    for what, (got, want) in small_model_evals(torch, cfg, (card, host),
                                               g).items():
        rel = (got - want).abs().max().item() / want.abs().max().item()
        was = bf16.get(f"{what}_model_max_abs_err")
        log(f"  small() {what} model eval, card f32 vs CPU f32: max|diff| / "
            f"max|ref| {rel:.3g} (limit {F32_MODEL_REL:g})"
            + (f"; phase 4's card bf16: max|diff| {was:.4g}"
               if was is not None else ""))
        check(rel <= F32_MODEL_REL, f"small() {what} model in f32 on the "
              f"card disagrees with the CPU")
        out[f"{what}_model_rel_err"] = rel
    b, res = 2, cfg.vae.sample_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    req = {k: v.cpu() for k, v in synthetic_request(torch, F, gen, b,
                                                     res).items()}
    lat = res // cfg.vae.downscale
    noise = dict(enc_noise=torch.randn((6 * b, lat, lat, 4), generator=g),
                 img_noise=torch.randn((b, lat, lat, 4), generator=g))
    renders = {}
    for route in ("auto", "splash", "unet_flash", "host"):
        pipe = host if route == "host" else card
        os.environ["UNIRENDER_ATTN"] = "auto" if route == "host" else route
        reset_counters()
        try:
            renders[route] = pipe.mask2image_3mod_albedo_with_noise(
                **req, **noise).cpu()
        finally:
            os.environ.pop("UNIRENDER_ATTN", None)
        torch.cuda.synchronize()
        launches, _ = read_counters()
        kernel = {"splash": "splash_attention",
                  "unet_flash": "attn_kernel"}.get(route)
        if kernel:
            want = forward_self_attention_calls(cfg, b, res,
                                                cfg.sampler.num_steps)
            check(launches[kernel] == want and want > 0,
                  f"{route} route in f32: {launches[kernel]} launches, "
                  f"the config says {want}")
            out[f"route_{route}_launches"] = launches[kernel]
    ref = renders["host"]
    check(bool(torch.isfinite(renders["auto"]).all()),
          "small() f32 render not finite")
    rel = ((renders["auto"] - ref).abs().max().item()
           / ref.abs().max().item())
    was = bf16.get("render_mean_abs_diff")
    log(f"  small() forward render (20 steps), card f32 vs CPU f32: "
        f"max|diff| / max|ref| {rel:.3g} (limit {F32_RENDER_REL:g})"
        + (f"; phase 4's card bf16: mean |diff| {was:.4g}"
           if was is not None else ""))
    check(rel <= F32_RENDER_REL, "small() f32 render on the card disagrees "
          "with the CPU")
    out["render_rel_err"] = rel
    for route in ("splash", "unet_flash"):
        r = ((renders[route] - renders["auto"]).abs().max().item()
             / renders["auto"].abs().max().item())
        log(f"  the {route} route in f32: {out[f'route_{route}_launches']} "
            f"launches, render within {r:.3g} of the default route's "
            f"(limit {F32_ROUTE_REL:g})")
        check(r <= F32_ROUTE_REL, f"the {route} route in f32 disagrees")
        out[f"route_{route}_rel_err"] = r
    return out


def f32_held_out(torch, record, checked):
    """(c): the held-out harness in f32 on the card, forward and inverse
    at ensemble 1, gated as phase 7; its K1 / K2 launches (the f32 main
    path's) and every call checked in (a)."""
    reset_counters()
    scores, _ = phase_held_out(torch, ensembles=(1,), dtype_name="float32")
    torch.cuda.synchronize()
    launches, seen = read_counters()
    for name in ("groupnorm_silu", "flash_attention"):
        unchecked = seen[name] - checked[name]
        check(not unchecked, f"{name} f32 got calls (a) did not check: "
              f"{sorted(unchecked)[:3]}")
        check(launches[name] > 0, f"{name} never launched in f32")
    bf16 = record.get("held_out", {}).get("ensemble_1")
    if bf16 is not None:
        inv = bf16["inverse"]
        log(f"  phase 7 (bf16 on the card): forward "
            f"{bf16['psnr_forward_render']:.3f} dB; inverse normal "
            f"{inv['psnr_maps']['normal']:.3f}, albedo "
            f"{inv['psnr_maps']['albedo']:.3f} dB, angle "
            f"{inv['normal_angle_mean']:.2f} deg, MR MAE "
            f"{inv['metal_rough_mae']:.4f}")
    f32_launches = {k: _wrappers()[k].launches_f32
                    for k in ("groupnorm_silu", "flash_attention")}
    cluster = _wrappers()["groupnorm_silu"].launches_cluster
    want = harness_kernel_calls()
    log(f"  K1 f32 launches in the harness: {cluster} of the cluster kernel "
        f"of {f32_launches['groupnorm_silu']}; KernelCalls says "
        f"{want.launches['groupnorm_silu']}")
    check(cluster == f32_launches["groupnorm_silu"]
          == want.launches["groupnorm_silu"],
          "K1 f32 in the harness did not all go through the cluster kernel "
          "or does not match KernelCalls")
    return dict(scores=scores, launches=launches, f32_launches=f32_launches,
                cluster_launches=cluster,
                k1_calls=[[list(sig[0]), sig[1], sig[2], sig[3], n]
                          for sig, n in sorted(want.gn.items())])


def f32_train_step(torch, record):
    """(d): one small() train step in f32, card against the CPU, from the
    same weights, batch and draws (`train/compare.py`), each branch."""
    from unirenderer_tpu_torch.train.compare import compare
    reset_counters()
    result = compare([("cuda", torch.float32), ("cpu", torch.float32)])
    launches, _ = read_counters()
    bf16 = record.get("small_training", {})
    for branch, r in result.items():
        log(f"  small() {branch} step, card f32 vs CPU f32: loss "
            f"{r['loss']:.8g} vs {r['loss_ref']:.8g} (rel err "
            f"{r['loss_rel_err']:.3g}, limit {F32_TRAIN_LOSS_REL:g}), "
            f"gradient cosine {r['grad_cos']:.8f} (>= {F32_TRAIN_GRAD_COS}),"
            f" norm ratio {r['norm_ratio']:.7f} (within "
            f"{F32_TRAIN_NORM_REL:g})")
        log("    cosines by group: " + ", ".join(
            f"{k} {v:.7f}" for k, v in sorted(r["groups"].items())))
        if branch in bf16:
            was = bf16[branch]
            log(f"    phase 9 (card bf16 vs CPU f32): loss rel err "
                f"{was['loss_rel_err']:.3g}, cosine {was['grad_cos']:.6f}, "
                f"norm ratio {was['norm_ratio']:.5f}")
        check(r["loss_rel_err"] <= F32_TRAIN_LOSS_REL
              and r["grad_cos"] >= F32_TRAIN_GRAD_COS
              and abs(r["norm_ratio"] - 1) <= F32_TRAIN_NORM_REL,
              f"small() {branch} train step in f32 on the card disagrees "
              f"with the CPU")
    check(launches["flash_attention_backward"] > 0,
          "K2 bwd never launched in the f32 step")
    result["launches"] = launches
    return result


def f32_vae_recon(torch):
    """(e): the held-out VAE reconstruction eval in f32 on the card (n=32,
    vae_small.npz); on the first 4 objects the card's PSNRs against the
    CPU's from the same collated images and posterior draw."""
    import tempfile
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    from unirenderer_tpu_torch.eval import vae_recon as vr
    from unirenderer_tpu_torch.eval.metrics import psnr
    from unirenderer_tpu_torch.eval.quality import HELD_OUT, held_out_paths
    cfg = config.small()
    card, step = vr.vae_pipeline(cfg, VAE_NPZ, "cuda")
    host, _ = vr.vae_pipeline(cfg, VAE_NPZ, "cpu")
    with tempfile.TemporaryDirectory(prefix="held_out_") as root:
        write_dataset(root, device="cuda", log=lambda msg: None, **HELD_OUT)
        meshes, envs = held_out_paths(root)
        t = time.perf_counter()
        rep = vr.reconstruction_psnr(card, meshes, envs, n=32)
        seconds = time.perf_counter() - t
        log(f"  VAE reconstruction, f32 on the card, n=32 ({VAE_NPZ} step "
            f"{step}, {seconds:.1f} s): "
            + ", ".join(f"{m} {v:.3f}" for m, v in rep["psnr"].items())
            + f" dB; mean {rep['psnr_mean']:.3f} dB")
        _, images = next(vr.recon_batches(cfg, meshes, envs,
                                          VAE_RECON_OBJECTS, "cuda"))
    noise = vr.seeded_draws(0, vr.latent_shape(cfg, images["image"]),
                            "cpu")
    diffs = {}
    for m in vr.MODALITIES:
        gt = (images[m].cpu().numpy() + 1) / 2
        card_db, host_db = (psnr((vr.reconstruct(pipe, images[m], noise)
                                  + 1) / 2, gt) for pipe in (card, host))
        diffs[m] = card_db - host_db
    log(f"  {VAE_RECON_OBJECTS} objects, same images and draw, card - CPU: "
        + ", ".join(f"{m} {d:+.2e}" for m, d in diffs.items())
        + f" dB (limit {VAE_RECON_DB})")
    check(max(abs(d) for d in diffs.values()) <= VAE_RECON_DB,
          "VAE reconstruction PSNR on the card disagrees with the CPU")
    rep.update(ckpt_step=step, seconds=seconds, card_minus_cpu_db=diffs)
    return rep


CLI_TIMEOUT_S = 400


def run_clis(cmds, tmp, timeout=CLI_TIMEOUT_S):
    """Run the commands ({name: argv after the interpreter}) side by side,
    output to files -> {name: (stdout, seconds)}; a non-zero exit fails.
    None outlives the call."""
    procs = {}
    t = time.perf_counter()
    try:
        for name, argv in cmds.items():
            with open(os.path.join(tmp, f"{name}.out"), "w") as out_f, \
                    open(os.path.join(tmp, f"{name}.err"), "w") as err_f:
                procs[name] = subprocess.Popen([sys.executable] + argv,
                                               stdout=out_f, stderr=err_f)
        out = {}
        for name, proc in procs.items():
            proc.wait(timeout=timeout)
            seconds = time.perf_counter() - t
            with open(os.path.join(tmp, f"{name}.out")) as f:
                stdout = f.read()
            with open(os.path.join(tmp, f"{name}.err")) as f:
                stderr = f.read()
            check(proc.returncode == 0, f"{' '.join(cmds[name])}: exit "
                  f"{proc.returncode}\n{stderr[-2000:]}")
            out[name] = (stdout, seconds)
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def printed_launches(stdout, tag):
    return json.loads(next(ln for ln in stdout.splitlines()
                           if ln.startswith(f"[{tag}] kernel launches ")
                           ).split("launches ", 1)[1])


def f32_clis(torch, keep=None):
    """(f): the train and VAE CLIs at small() on the card with no type
    given, 2 steps each on synthetic maps, the two processes side by
    side: f32 (their own report), finite losses, and the f32 kernels
    launched (the launch counts they print).  `keep`: where the train
    CLI's checkpoints are copied (phase 16 exports them)."""
    import shutil
    import tempfile
    out = {}
    clis = (("train", "unirenderer_tpu_torch.train", "metrics.jsonl",
             "loss"),
            ("vae", "unirenderer_tpu_torch.train.vae", "vae_metrics.jsonl",
             "vae_loss"))
    with tempfile.TemporaryDirectory(prefix="clis_") as tmp:
        runs = run_clis({name: ["-m", module, "--workdir",
                                os.path.join(tmp, name), "--config",
                                "small", "--synthetic", "--steps", "2"]
                         for name, module, _, _ in clis}, tmp)
        for name, module, metrics, key in clis:
            out[name] = cli_result(name, module, metrics, key, *runs[name],
                                   tmp)
        if keep is not None:
            shutil.copytree(os.path.join(tmp, "train", "checkpoints"), keep)
    return out


def cli_result(name, module, metrics, key, stdout, seconds, tmp):
    """(f)'s checks of one CLI's output."""
    lines = stdout.splitlines()
    dtype = [ln for ln in lines if ln.startswith(f"[{name}] compute")]
    counts = printed_launches(stdout, name)
    with open(os.path.join(tmp, name, metrics)) as f:
        losses = [json.loads(ln) for ln in f]
    finite = all(math.isfinite(r[key]) for r in losses)
    f32 = {k: v for k, v in counts.items()
           if k.endswith("_f32") and v}
    log(f"  python -m {module} --config small --synthetic --steps 2 "
        f"(done at {seconds:.1f} s): "
        f"{dtype[0] if dtype else 'no type'}; losses "
        f"{[round(r[key], 6) for r in losses]}; f32 launches {f32}")
    check(bool(dtype) and "float32" in dtype[0], f"{name} CLI did "
          f"not compute in f32")
    check(bool(losses) and finite, f"{name} CLI losses not finite")
    check(counts["groupnorm_silu_f32"] > 0
          and counts["groupnorm_silu_f32"] == counts["groupnorm_silu"],
          f"{name} CLI did not run K1 in f32")
    if name == "train":
        check(counts["flash_attention_f32"] > 0
              and counts["flash_attention_backward_f32"] > 0,
              "train CLI did not run K2 / K2 bwd in f32")
    return dict(seconds=seconds, losses=losses, launches=counts)


def phase_f32(torch, F, record, keep=None):
    """Phase 15: (a) the f32 kernels against their plain versions and K1's
    f32 plans; (b) small() in f32, card against CPU, and the routes; (c)
    the held-out harness in f32; (d) a train step in f32, card against
    CPU; (e) the VAE reconstruction eval; (f) the CLIs' default type
    (the train CLI's checkpoints copied to `keep`)."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = False    # the plain and library calls
    out = {}
    launches = {}
    cases = f32_cases()
    try:
        for part, what, fn in (
                ("a", f"the f32 kernels against their plain versions: "
                      f"{len(cases['gn'])} K1, {len(cases['attn'])} K2, "
                      f"{len(cases['routes'])} K2s / K3, {len(cases['bwd'])} "
                      f"K2 bwd cases; K1 f32's route and plans",
                 lambda: dict(cases=f32_kernel_cases(torch, F, cases),
                              cluster=f32_cluster_route(torch, cases),
                              plans=f32_gn_branches(torch))),
                ("b", "the trained small() weights in f32, card against "
                      "CPU; the splash and unet_flash routes",
                 lambda: f32_small_weights(torch, F, record)),
                ("c", "the held-out harness in f32 (the f32 main path)",
                 lambda: f32_held_out(torch, record, cases["checked"])),
                ("d", "a small() train step in f32, card against CPU",
                 lambda: f32_train_step(torch, record)),
                ("e", "the held-out VAE reconstruction eval in f32",
                 lambda: f32_vae_recon(torch)),
                ("f", "the train and VAE CLIs at small() with no type given",
                 lambda: f32_clis(torch, keep))):
            t = time.perf_counter()
            log(f"  ({part}) {what}")
            out[part] = fn()
            out[part + "_s"] = time.perf_counter() - t
            log(f"  ({part}) done in {out[part + '_s']:.1f} s")
    finally:
        mm.allow_tf32, dnn.allow_tf32 = flags
    launches["groupnorm_silu_f32"] = out["c"]["cluster_launches"]
    launches["flash_attention_f32"] = out["c"]["f32_launches"][
        "flash_attention"]
    launches["flash_attention_backward_f32"] = out["d"]["launches"][
        "flash_attention_backward"]
    launches["splash_attention_f32"] = out["b"]["route_splash_launches"]
    launches["attn_kernel_f32"] = out["b"]["route_unet_flash_launches"]
    return out, launches


# ---------------------------------------------------------------------------
# Phase 16: the user's data path (preprocessing CLIs, the JAX tool's
# harness interface, weight export)
# ---------------------------------------------------------------------------

USER_MESHES = 4                  # meshes the user prepares
USER_SPHERE_RES = 90             # rings: T 32400, under flagship's t_pad
USER_HDR = (512, 1024)           # latlong h x w: the 1k size of HDRI sets
USER_ENVS = 2
USER_STEPS = 20                  # the flagship harness run's steps
USER_SMALL_STEPS = 4             # the export round trip's
LIGHT2MAP_SMALL = ["--res", "64", "--samples", "64"]
LIGHT2MAP_REL = 1e-5             # card against CPU, per texel, of max|CPU|
LIGHT2MAP_SEAM_TEXELS = 4        # texels a level allowed past it (seams)
LIGHT2MAP_SEAM_REL = 2e-2        # and their bound
CONSTANT_ENV = 0.5
CONSTANT_REL = 1e-5
JAX_REPORT_KEYS = ["n_objects", "steps", "psnr_forward_render", "psnr_maps",
                   "normal_angle", "metal_rough_mae", "checkpoint",
                   "checkpoint_loaded", "checkpoint_step"]


def write_obj(directory, name, mesh, kd01):
    """`mesh` (v_pos, v_tex, v_nrm, t_idx; one index a corner for all
    three) as <name>.obj, its material as <name>.mtl and `kd01` (an albedo
    texture in [0, 1]) as its map_Kd <name>.png.  Returns the OBJ's
    path."""
    import numpy as np
    from PIL import Image
    obj = os.path.join(directory, f"{name}.obj")
    with open(obj, "w") as f:
        f.write(f"mtllib {name}.mtl\n")
        for key, tag in (("v_pos", "v"), ("v_tex", "vt"), ("v_nrm", "vn")):
            f.writelines(f"{tag} " + " ".join(f"{x:.9g}" for x in row)
                         + "\n" for row in np.asarray(mesh[key]).tolist())
        f.write(f"usemtl {name}\n")
        f.writelines("f " + " ".join(f"{i}/{i}/{i}" for i in row) + "\n"
                     for row in (np.asarray(mesh["t_idx"]) + 1).tolist())
    Image.fromarray((np.clip(kd01, 0, 1) * 255).round().astype(np.uint8)) \
        .save(os.path.join(directory, f"{name}.png"))
    with open(os.path.join(directory, f"{name}.mtl"), "w") as f:
        f.write(f"newmtl {name}\nKd 0.8 0.8 0.8\nmap_Kd {name}.png\n")
    return obj


def user_calls(cfg):
    """`pipelines.KernelCalls` of one batch of the JAX tool's harness on
    phase 16's data: USER_MESHES objects, forward with the material image
    encoded and inverse at ensemble 1."""
    from unirenderer_tpu_torch.pipelines import KernelCalls
    return (KernelCalls(cfg, cfg.vae.sample_size)
            .mask2image_3mod_albedo(USER_MESHES, USER_STEPS, True)
            .real_image2mask_3mod_albedo(USER_MESHES, USER_STEPS, 1))


def user_prepare(torch, cfg, tmp):
    """(a): USER_MESHES deformed spheres (data/synthetic.py) as OBJ + MTL +
    PNG and USER_ENVS latlong HDRs, through `data.obj2mesh` and
    `data.light2map` (the JAX tool's defaults) on the card, side by side;
    the outputs against in-process loads; light2map card against CPU at
    --res 64 --samples 64 with a constant HDR beside."""
    import numpy as np
    from unirenderer_tpu_torch.data.hdr import write_hdr
    from unirenderer_tpu_torch.data.obj2mesh import mesh_arrays
    from unirenderer_tpu_torch.data.synthetic import (
        make_env_latlong, make_shape, make_texture,
    )
    from unirenderer_tpu_torch.render.mesh import (
        auto_normals, make_sphere, unit_normalize_mesh,
    )
    rng = np.random.default_rng(SEED + 16)
    src_obj, src_hdr, src_small = (os.path.join(tmp, d) for d in (
        "obj", "hdr", "hdr_small"))
    for d in (src_obj, src_hdr, src_small):
        os.makedirs(d)
    base = make_sphere(USER_SPHERE_RES)
    t_idx = np.asarray(base.t_pos_idx)
    objs = []
    for i in range(USER_MESHES):
        v = unit_normalize_mesh(make_shape(np.asarray(base.v_pos), rng))
        mesh = dict(v_pos=v, v_tex=np.asarray(base.v_tex),
                    v_nrm=auto_normals(v, t_idx), t_idx=t_idx)
        objs.append(write_obj(src_obj, f"m{i}", mesh, make_texture(
            cfg.data.texture_res, rng)))
    for e in range(USER_ENVS):
        ll = make_env_latlong(rng, *USER_HDR)
        write_hdr(os.path.join(src_hdr, f"e{e}.hdr"), ll)
        write_hdr(os.path.join(src_small, f"e{e}.hdr"), ll)
    write_hdr(os.path.join(src_small, "constant.hdr"),
              np.full((64, 128, 3), CONSTANT_ENV, np.float32))
    meshes, envs = os.path.join(tmp, "meshes"), os.path.join(tmp, "envs")
    # the CPU half of the small comparison runs beside the two CLIs
    # (host cores only); the card half after them
    from concurrent.futures import ThreadPoolExecutor

    from unirenderer_tpu_torch.data import light2map
    small = {dev: os.path.join(tmp, f"small_{dev}") for dev in ("cpu",
                                                               "cuda")}
    with ThreadPoolExecutor(1) as ex:
        cpu_run = ex.submit(light2map.main, ["--src", src_small, "--dst",
                                             small["cpu"], "--device",
                                             "cpu"] + LIGHT2MAP_SMALL)
        runs = run_clis({
            "obj2mesh": ["-m", "unirenderer_tpu_torch.data.obj2mesh",
                         "--src", src_obj, "--dst", meshes, "--workers",
                         "8"],
            "light2map": ["-m", "unirenderer_tpu_torch.data.light2map",
                          "--src", src_hdr, "--dst", envs]}, tmp)
        check(cpu_run.result() == 0, "light2map on the CPU failed")
    light2map.main(["--src", src_small, "--dst", small["cuda"], "--device",
                    "cuda"] + LIGHT2MAP_SMALL)
    out = {}
    # meshes: every array of every npz equal to an in-process load
    lines = runs["obj2mesh"][0].splitlines()
    check(f"ok={USER_MESHES} failed=0" in lines[-1], f"obj2mesh: {lines[-1]}")
    for obj in objs:
        want = mesh_arrays(obj)
        with np.load(os.path.join(meshes, os.path.basename(obj)[:-4]
                                  + ".npz")) as got:
            check(sorted(got.files) == sorted(want), f"{obj}: keys")
            for k in want:
                check(got[k].dtype == want[k].dtype
                      and np.array_equal(got[k], want[k]),
                      f"obj2mesh {obj} {k} differs from load_obj")
    out["mesh_triangles"] = len(want["t_idx"])
    out["mesh_vertices"] = len(want["v_pos"])
    # envs: 6 specular levels 512 .. 16 and a diffuse map, finite
    levels = [USER_HDR[0] >> i for i in range(6)]
    for e in range(USER_ENVS):
        d = os.path.join(envs, f"e{e}")
        check(sorted(os.listdir(d)) == ["diffuse.npy"] + [
            f"specular_{i}.npy" for i in range(len(levels))],
            f"light2map e{e}: {sorted(os.listdir(d))}")
        for i, r in enumerate(levels):
            s = np.load(os.path.join(d, f"specular_{i}.npy"))
            check(s.shape == (6, r, r, 3) and s.dtype == np.float32
                  and bool(np.isfinite(s).all()), f"e{e} specular_{i}")
        diff = np.load(os.path.join(d, "diffuse.npy"))
        check(diff.shape == (6, 16, 16, 3) and bool(np.isfinite(diff).all()),
              f"e{e} diffuse")
    stdout = runs["light2map"][0]
    per_env = [float(ln.rsplit(" in ", 1)[1].split()[0])
               for ln in stdout.splitlines()
               if ln.startswith("[light2map] ok ")]
    peak = float(next(ln for ln in stdout.splitlines()
                      if "peak device memory" in ln).split()[-2])
    check(len(per_env) == USER_ENVS, f"light2map: {stdout[-500:]}")
    out.update(obj2mesh_s=runs["obj2mesh"][1], light2map_s=runs[
        "light2map"][1], seconds_per_env=per_env, light2map_peak_gib=peak)
    # the card against the CPU at 64 / 64, and the constant env
    worst = {}
    for name in sorted(os.listdir(small["cpu"])):
        for f in sorted(os.listdir(os.path.join(small["cpu"], name))):
            want = np.load(os.path.join(small["cpu"], name, f))
            got = np.load(os.path.join(small["cuda"], name, f))
            check(got.shape == want.shape, f"{name}/{f}: shapes")
            err = np.abs(got - want).max(-1) / np.abs(want).max()
            over = int((err > LIGHT2MAP_REL).sum())
            worst[f"{name}/{f}"] = (float(err.max()), over)
            check(over <= LIGHT2MAP_SEAM_TEXELS
                  and err.max() <= LIGHT2MAP_SEAM_REL,
                  f"light2map {name}/{f}: card against CPU {err.max():.3g} "
                  f"({over} texels over {LIGHT2MAP_REL:g})")
            if name == "constant":
                dev = float(np.abs(got / got.flat[0] - 1).max())
                check(dev <= CONSTANT_REL, f"constant env {f}: {dev:.3g}")
    out["card_vs_cpu_64"] = worst
    log(f"  (a) obj2mesh --workers 8: {USER_MESHES} meshes (V "
        f"{out['mesh_vertices']}, T {out['mesh_triangles']}) in "
        f"{out['obj2mesh_s']:.1f} s (process), each npz array-equal to "
        f"load_obj; light2map at 512 / 16 / 256: {USER_ENVS} envs from "
        f"{USER_HDR[1]}x{USER_HDR[0]} HDRs in {out['light2map_s']:.1f} s "
        f"(process), seconds per env {[round(s, 3) for s in per_env]}, "
        f"peak device memory {peak:.3f} GiB, 6 specular levels "
        f"{levels[0]}..{levels[-1]} and a diffuse map, finite")
    log(f"  (a) light2map card against CPU at 64 / 64: worst "
        f"{max(v[0] for v in worst.values()):.3g} of max|CPU|, texels over "
        f"{LIGHT2MAP_REL:g}: {max(v[1] for v in worst.values())} a level "
        f"at most; a constant {CONSTANT_ENV} HDR gives constant maps "
        f"(within {CONSTANT_REL:g})")
    return out, meshes, envs


def user_harness(torch, cfg, checked, rast_checked, meshes, envs, tmp):
    """(b): `eval.quality --config flagship` on (a)'s data, random
    weights, one batch through both legs: a process (the JAX report's
    keys, launches against the config, K4 once a collate), then in this
    process the same batch (its K4 call one phase 5 checked) cold and
    warm (walls, peak memory, launches; the scores equal to the
    process's) and profiled (device busy)."""
    from unirenderer_tpu_torch.eval import quality
    from unirenderer_tpu_torch.train.__main__ import data_paths
    report_path = os.path.join(tmp, "flagship_report.json")
    stdout, seconds = run_clis({"quality": [
        "-m", "unirenderer_tpu_torch.eval.quality", "--config", "flagship",
        "--mesh-dir", meshes, "--env-dir", envs, "--n", str(USER_MESHES),
        "--steps", str(USER_STEPS), "--out", report_path]}, tmp)["quality"]
    with open(report_path) as f:
        report = json.load(f)
    check(list(report) == JAX_REPORT_KEYS, f"report keys {list(report)}")
    check(report["checkpoint_loaded"] is False
          and report["checkpoint_step"] is None, "random weights labelled "
          "as a checkpoint")
    numbers = ([report["psnr_forward_render"], report["metal_rough_mae"]]
               + list(report["psnr_maps"].values())
               + list(report["normal_angle"].values()))
    check(all(math.isfinite(x) for x in numbers), f"report {report}")
    want = user_calls(cfg).launches
    counts = printed_launches(stdout, "eval")
    check({k: counts[k] for k in want} == want, f"the CLI's launches "
          f"{counts}, the config's {want}")
    check(counts["rasterize"] == 1, f"K4 launched {counts['rasterize']} "
          f"times for one collate")
    check(counts["groupnorm_silu_f32"] == 0, "flagship scored in f32")
    walls = [ln for ln in stdout.splitlines() if ln.startswith("[eval] batch")]
    log(f"  (b) python -m unirenderer_tpu_torch.eval.quality --config "
        f"flagship --n {USER_MESHES} --steps {USER_STEPS}: {seconds:.1f} s "
        f"(process, cold), {walls[-1][7:]}; launches {counts}; report "
        f"forward PSNR {report['psnr_forward_render']:.3f} dB, normal "
        f"{report['psnr_maps']['normal']:.3f} dB (random weights)")
    # in this process: the same pipeline, batch and noise
    t = time.perf_counter()
    pipe, _ = quality.tool_pipeline("flagship", "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    reset_counters()
    batches = list(quality._held_out_batches(
        pipe, *data_paths(meshes, envs), USER_MESHES))
    torch.cuda.synchronize()
    collate_s = time.perf_counter() - t
    launched, seen = read_counters()
    check(launched["rasterize"] == 1, f"the collate of one batch launched "
          f"K4 {launched['rasterize']} times")
    missed = seen["rasterize"] - rast_checked
    check(not missed, f"the collate's K4 calls phase 5 did not check: "
          f"{sorted(missed)}")
    runs = []
    for _ in range(2):                 # cold in this process, then warm
        scores, wall, peak, got = counted_run(
            torch, lambda: quality.tool_scores(pipe, batches, USER_STEPS),
            want, checked, "the flagship user-data harness")
        runs.append(dict(wall_s=wall, peak_gib=peak / 2**30,
                         seconds=scores["seconds"][0]))
    t = time.perf_counter()
    busy = device_busy_ms(torch, lambda: quality.tool_scores(
        pipe, batches, USER_STEPS))
    profile_s = time.perf_counter() - t
    # the process and this process: the same weights, batch, noise and
    # kernels, so the same numbers to the last bit
    diffs = {k: abs(scores[k] - report[k])
             for k in ("psnr_forward_render", "metal_rough_mae")}
    diffs.update({f"psnr_{k}": abs(v - report["psnr_maps"][k])
                  for k, v in scores["psnr_maps"].items()})
    diffs.update({f"angle_{k}": abs(v - report["normal_angle"][k])
                  for k, v in scores["normal_angle"].items()})
    check(max(diffs.values()) == 0, f"the in-process run's scores differ "
          f"from the process's report: {diffs}")
    del pipe
    torch.cuda.empty_cache()
    log(f"  (b) in this process: cold {runs[0]['wall_s']:.3f} s (forward "
        f"{runs[0]['seconds'][0]:.3f}, inverse {runs[0]['seconds'][1]:.3f})"
        f", warm {runs[1]['wall_s']:.3f} s (forward "
        f"{runs[1]['seconds'][0]:.3f}, inverse {runs[1]['seconds'][1]:.3f}),"
        f" device busy {busy:.1f} ms ({100 * busy / 1e3 / runs[1]['wall_s']:.1f}"
        f" % of the warm wall), peak {runs[1]['peak_gib']:.2f} GiB; every "
        f"score equal to the process's report; weights made in "
        f"{build_s:.1f} s, collate {collate_s:.2f} s, profiled run "
        f"{profile_s:.1f} s")
    return dict(process_s=seconds, report=report, launches=counts,
                runs=runs, device_busy_ms=busy, score_diffs=diffs,
                weights_s=build_s, collate_s=collate_s, profile_s=profile_s)


def user_export(torch, tmp, ckpt_dir):
    """(c): a small() train-CLI checkpoint through `core.export_params`
    (float32 and float16, two processes), then `eval.quality --config
    small` with `--ckpt` the directory and the f32 npz (two processes) on
    4 meshes and 2 envs of data/synthetic.py (seed 99; (a)'s meshes
    exceed small()'s pad sizes): the same report but for its path; the
    f16 npz read by both loaders."""
    import numpy as np
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    from unirenderer_tpu_torch.eval import quality
    data = os.path.join(tmp, "small_set")
    write_dataset(data, n_mesh=USER_MESHES, n_env=USER_ENVS, env_res=32,
                  env_min_res=8, seed=99, device="cuda", log=lambda m: None)
    meshes, envs = os.path.join(data, "meshes"), os.path.join(data, "envs")
    if ckpt_dir is None:               # phase 15 did not run: make one
        work = os.path.join(tmp, "train")
        run_clis({"train": ["-m", "unirenderer_tpu_torch.train",
                            "--workdir", work, "--config", "small",
                            "--synthetic", "--steps", "2"]}, tmp)
        ckpt_dir = os.path.join(work, "checkpoints")
    npz = {d: os.path.join(tmp, f"small_{d}.npz")
           for d in ("float32", "float16")}
    runs = run_clis({f"export_{d}": [
        "-m", "unirenderer_tpu_torch.core.export_params", "--ckpt", ckpt_dir,
        "--out", path, "--dtype", d] for d, path in npz.items()}, tmp)
    reports = {}
    cmds = {}
    for what, ckpt in (("dir", ckpt_dir), ("npz", npz["float32"])):
        reports[what] = os.path.join(tmp, f"small_{what}.json")
        cmds[f"quality_{what}"] = [
            "-m", "unirenderer_tpu_torch.eval.quality", "--config", "small",
            "--mesh-dir", meshes, "--env-dir", envs, "--n",
            str(USER_MESHES), "--steps", str(USER_SMALL_STEPS), "--ckpt",
            ckpt, "--vae-ckpt", VAE_NPZ, "--out", reports[what]]
    runs.update(run_clis(cmds, tmp))
    got = {}
    for what, path in reports.items():
        with open(path) as f:
            got[what] = json.load(f)
    check(got["dir"]["checkpoint_loaded"] and got["dir"]["checkpoint_step"]
          == got["npz"]["checkpoint_step"] == 2, f"steps {got}")
    same = ({k: v for k, v in got["dir"].items() if k != "checkpoint"}
            == {k: v for k, v in got["npz"].items() if k != "checkpoint"})
    check(same, f"--ckpt DIR and --ckpt NPZ differ: {got}")
    f32, step32 = load_params_npz(npz["float32"])
    f16, step16 = load_params_npz(npz["float16"])
    check(step16 == step32 == 2 and sorted(f16) == sorted(f32),
          "float16 export: keys or step")
    for k, v in f32.items():
        check(np.array_equal(f16[k], v.astype(np.float16).astype(v.dtype)
                             if v.dtype.kind == "f" else v),
              f"float16 export: {k} is not the f32 master rounded")
    pipe, step = quality.tool_pipeline("small", "cuda", torch.float32,
                                       ckpt=npz["float16"])
    check(step == 2, f"float16 npz through eval.quality's loader: {step}")
    del pipe
    sizes = {d: os.path.getsize(p) / 1e6 for d, p in npz.items()}
    log(f"  (c) export of the small() train-CLI checkpoint (step 2): f32 "
        f"{sizes['float32']:.0f} MB, f16 {sizes['float16']:.0f} MB "
        f"(processes {runs['export_float32'][1]:.1f} s); eval.quality "
        f"--config small --n {USER_MESHES} --steps {USER_SMALL_STEPS}: "
        f"--ckpt DIR and --ckpt NPZ reports equal (forward PSNR "
        f"{got['dir']['psnr_forward_render']:.4f} dB, processes "
        f"{runs['quality_npz'][1]:.1f} s); the f16 export read by "
        f"load_params_npz (the f32 masters rounded) and by eval.quality's "
        f"loader")
    return dict(sizes_mb=sizes, reports=got, export_s=runs[
        "export_float32"][1], quality_s=runs["quality_npz"][1])


def phase_user_data(torch, cfg, checked, ckpt_dir):
    """Phase 16: (a) preprocessing, (b) the flagship harness on it, (c)
    the export round trip at small()."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory(prefix="user_data_") as tmp:
        for part, fn in (
                ("a", lambda: user_prepare(torch, cfg, tmp)),
                ("b", lambda: user_harness(torch, cfg, checked,
                                           rast_signatures(cfg),
                                           out["a"][1], out["a"][2], tmp)),
                ("c", lambda: user_export(torch, tmp, ckpt_dir))):
            t = time.perf_counter()
            out[part] = fn()
            log(f"  ({part}) done in {time.perf_counter() - t:.1f} s")
    out["a"] = out["a"][0]
    return out


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


def modes_calls(cfg):
    """name -> `pipelines.KernelCalls` of each of phase 11's flagship
    requests: the K1/K2 signatures it gives and the launches the config
    says it makes."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.pipelines import FORWARD_RENDER, KernelCalls
    res, steps, b = cfg.vae.sample_size, cfg.sampler.num_steps, MODES_BATCH
    out = {f"reuse_{k}": KernelCalls(cfg, res).mask2image_3mod_albedo(
        b, steps, encoder_reuse=k) for k in REUSE}
    out["guidance"] = KernelCalls(cfg, res).sample(FORWARD_RENDER, b, steps,
                                                   guidance=True)
    out["joint"] = KernelCalls(cfg, res).joint_sample(b, steps)
    for hoist in (True, False):
        out[f"inverse_hoist_{hoist}"] = KernelCalls(
            cfg, res).real_image2mask_3mod_albedo(b, steps, hoist=hoist)
    for name in LEGACY:
        lcfg = getattr(config, name)()
        out[f"{name}_rendering"] = KernelCalls(lcfg, res).rendering(1, steps)
        out[f"{name}_inverse"] = KernelCalls(lcfg, res).inverse_rendering(
            1, steps)
    out["relight"] = KernelCalls(cfg, res).relight(1, steps)
    return out


def phase2_cases(cfg):
    """Phase 2's cases in the order it runs them, from the kernels' calls
    on the flagship paths: K1 and K2 at every call of phases 3, 6, 8 and
    10 (batch 2), the routes at every tileable self-attention shape, K2 bwd
    at every training attention shape, plus ragged cases; and the call
    signatures each wrapper's main-path calls must come from."""
    from unirenderer_tpu_torch.ops.flash_attention import tileable
    from unirenderer_tpu_torch.pipelines import (
        inverse_kernel_cases, kernel_cases,
    )
    from unirenderer_tpu_torch.train.train_step import train_kernel_cases
    gn_cases, attn_cases = set(), set()
    res = cfg.vae.sample_size
    train_gn, train_attn = train_kernel_cases(cfg, 2, res)      # phase 10
    for gn, attn in (kernel_cases(cfg, 2, res, False),           # phase 3
                     kernel_cases(cfg, 2, res, True),            # phase 6
                     inverse_kernel_cases(cfg, 2, res,           # phase 8
                                          INVERSE_ENSEMBLE),
                     (train_gn, train_attn)):
        gn_cases |= gn
        attn_cases |= attn
    routed = sorted((q, k) for q, k in attn_cases
                    if q == k and tileable(q[1], k[1], q[3]))
    # the two routes at every tileable self-attention shape; K3 under all
    # four flag combinations there (randn inputs: without the running max
    # the scaled logits stay far below exp2's range) and at a ragged shape.
    # The cases that K3 gained with its redesign run after the earlier
    # ones (`later_routes`).
    route_cases = ([("splash_attention", c, {}) for c in routed]
                   + [("attn_kernel", c, {}) for c in routed]
                   + [("attn_kernel", c, {"running_max": False})
                      for c in routed]
                   + [("attn_kernel", c, {"pipelined": False})
                      for c in routed if c[0][0] == 2])
    ragged_k3 = ((1, 200, 3, 24), (1, 77, 3, 24))
    later_routes = ([("attn_kernel", c, {"pipelined": False})
                     for c in routed if c[0][0] != 2]
                    + [("attn_kernel", c,
                        {"pipelined": False, "running_max": False})
                       for c in routed]
                    + [("attn_kernel", ragged_k3, f) for f in (
                        {}, {"running_max": False}, {"pipelined": False},
                        {"pipelined": False, "running_max": False})])
    # phase 11's shapes that no earlier phase gives (guidance's model at
    # batch 4, the batch-1 legacy and relight requests, joint sampling's
    # VAE encoder at batch 2), run after every earlier case
    modes_gn, modes_attn = set(), set()
    for calls in modes_calls(cfg).values():
        gn, attn = calls.signatures
        modes_gn |= gn - gn_cases
        modes_attn |= attn - attn_cases
    # phase 12's VAE training step (K1 only: the mid-block attention is
    # plain PyTorch), after every earlier case
    vae_gn = vae_train_calls(cfg).signatures[0] - gn_cases - modes_gn
    # phase 13's requests (the app at batch 1 x ensemble 5, the medium()
    # preset's 128^2 shapes: K2 at head dims 24, 48, 96), after those
    apps_gn, apps_attn = set(), set()
    for calls in apps_calls(cfg).values():
        gn, attn = calls.signatures
        apps_gn |= gn - gn_cases - modes_gn - vae_gn
        apps_attn |= attn - attn_cases - modes_attn
    # phase 16's harness batch (4 objects, forward and inverse), after
    # every earlier case
    user_gn, user_attn = user_calls(cfg).signatures
    user_gn -= gn_cases | modes_gn | vae_gn | apps_gn
    user_attn -= attn_cases | modes_attn | apps_attn
    ragged_gn = [((2, 37, 29, 320), 32, 1e-5, True),
                 ((1, 33, 31, 1920), 32, 1e-6, False)]
    ragged_attn = [((2, 1000, 8, 40), (2, 333, 8, 40)),
                   ((1, 77, 3, 24), (1, 200, 3, 24))]
    return dict(
        gn_cases=gn_cases, attn_cases=attn_cases, train_attn=train_attn,
        route_cases=route_cases, later_routes=later_routes,
        # K1 with the model's bf16 parameters at every signature and the
        # ragged ones, and with f32 parameters (the trainer's f32 path, the
        # CPU) at the ragged ones and the headline (last)
        gn_jobs=[(c, "bfloat16") for c in sorted(gn_cases) + ragged_gn],
        later_gn=[(c, "float32") for c in ragged_gn + [GN_HEADLINE]],
        attn_jobs=sorted(attn_cases) + ragged_attn,
        bwd_jobs=sorted(train_attn) + ragged_attn,
        modes_gn=[(c, "bfloat16") for c in sorted(modes_gn)],
        modes_attn=sorted(modes_attn),
        vae_gn=[(c, "bfloat16") for c in sorted(vae_gn)],
        apps_gn=[(c, "bfloat16") for c in sorted(apps_gn)],
        apps_attn=sorted(apps_attn),
        user_gn=[(c, "bfloat16") for c in sorted(user_gn)],
        user_attn=sorted(user_attn),
        checked={"groupnorm_silu": (gn_cases | modes_gn | vae_gn | apps_gn
                                    | user_gn),
                 "flash_attention": (attn_cases | modes_attn | apps_attn
                                     | user_attn),
                 "flash_attention_backward": set(train_attn),
                 "splash_attention": set(routed),
                 "attn_kernel": set(routed)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (every case)")
    ap.add_argument("--phases", default=ALL_PHASES)
    ap.add_argument("--profile", action="store_true")
    # one of phase 14 (b)'s two gloo processes (started by the script)
    ap.add_argument("--gloo-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-out", help=argparse.SUPPRESS)
    # phase 15 (a)'s fresh process for K1 f32's profiles
    ap.add_argument("--k1-profile-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.gloo_rank is not None:
        return gloo_rank(args.gloo_rank, args.gloo_port, args.gloo_out)
    if args.k1_profile_out is not None:
        return k1_profile_child(args.k1_profile_out)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 2
    try:
        from unirenderer_tpu_torch.core import config
        from unirenderer_tpu_torch.ops import _build
        import unirenderer_tpu_torch.pipelines  # noqa: F401
        import unirenderer_tpu_torch.train.train_step  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr, flush=True)
        return 3

    record = {}
    import shutil
    import tempfile
    keep_root = tempfile.mkdtemp(prefix="chip_smoke_")   # phases 15 -> 16
    small_ckpt = os.path.join(keep_root, "small_checkpoints")
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
                f"(nvcc {' '.join(_build.NVCC_FLAGS)}; -split-compile=0 "
                f"for {', '.join(_build.SPLIT_COMPILE)})")
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
                if b.name in F32_TC_SOURCES:
                    spills = [line for line in report if re.search(
                        r"[1-9]\d* bytes spill (stores|loads)", line)]
                    log(f"  {b.name}: {len(spills)} spilling instance(s)")
                    check(not spills, f"{b.name} spills: {spills[:2]}")

        cfg = config.flagship()
        cases = phase2_cases(cfg)
        gn_cases, attn_cases = cases["gn_cases"], cases["attn_cases"]
        checked = cases["checked"]
        # ---- 2: kernels against their plain versions
        results = []
        if 2 in phases:
            tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            log(f"phase 2 kernels vs plain versions, bf16, tolerance "
                f"2^-7 * max|ref| (TF32 off for the plain versions): "
                f"{len(gn_cases)} GroupNorm (bf16 parameters; f32 at the "
                f"ragged and headline cases) + {len(attn_cases)} attention "
                f"main-path cases + ragged, "
                f"{len(cases['route_cases']) + len(cases['later_routes'])} "
                f"route cases, {len(cases['train_attn'])} attention "
                f"backward cases + ragged (tolerance 2^-6 * max|ref|), "
                f"{len(cases['modes_gn'])} GroupNorm and "
                f"{len(cases['modes_attn'])} attention cases of phase 11, "
                f"{len(cases['vae_gn'])} GroupNorm cases of phase 12, "
                f"{len(cases['apps_gn'])} GroupNorm and "
                f"{len(cases['apps_attn'])} attention cases of phase 13, "
                f"{len(cases['user_gn'])} GroupNorm and "
                f"{len(cases['user_attn'])} attention cases of phase 16")
            timer = Timer(torch)
            results = phase_kernels(
                torch, F, timer, cases["gn_jobs"], cases["attn_jobs"],
                cases["route_cases"], cases["bwd_jobs"],
                cases["later_routes"], cases["later_gn"], cases["modes_gn"],
                cases["modes_attn"], cases["vae_gn"], cases["apps_gn"],
                cases["apps_attn"], cases["user_gn"], cases["user_attn"])
            del timer
            fresh = k2_fresh_draws(torch)
            log(f"  K2 err / tol at (2,4096,8,40) on {len(fresh)} fresh "
                "draws " + " ".join(f"{x:.3f}" for x in fresh))
            record["k2_fresh_draws"] = fresh
            check(max(fresh) <= 1.0, "K2 out of tolerance on a fresh draw")
            host = wrapper_host_us(torch)
            log("  host time a wrapper call at (2,1024,8,80): "
                + ", ".join(f"{n} {us:.1f} us" for n, us in host.items())
                + " (K3's includes encoding its two tensor maps)")
            record["wrapper_host_us"] = host
            torch.cuda.empty_cache()
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32     # PyTorch defaults
            record["kernel_cases"] = results
            log("phase 2 done")
        launches = {}
        pipe = None
        held_out_images = None
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
            record["held_out"], held_out_images = phase_held_out(torch)
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
        # ---- 11: the sampling modes
        if 11 in phases:
            log("phase 11 sampling modes: flagship, encoder reuse, guidance, "
                "joint sampling, the unhoisted inverse, relight, the legacy "
                "layouts; small() held-out PSNR at encoder_reuse=2")
            t = time.perf_counter()
            record["sampling_modes"] = phase_sampling_modes(torch, F, cfg,
                                                            checked)
            log(f"phase 11 done in {time.perf_counter() - t:.1f} s")
        # ---- 12: the rest of training
        if 12 in phases:
            log("phase 12 the rest of training: flagship scene-bank steps, "
                "render-in-step, two-phase, Adafactor, accumulation, VAE "
                "training; small() validation and resume")
            rest = phase_rest_of_training(torch, cfg, checked)
            results += rest["rasterize_cases"]
            record["rest_of_training"] = rest
            log("phase 12 done")
        # ---- 13: the apps and the rest of eval
        if 13 in phases:
            log("phase 13 the apps and the rest of eval: the HTTP app "
                "(flagship decompose and relight), run_inverse, the medium() "
                "preset, an OBJ through the collate, LPIPS and FID")
            t = time.perf_counter()
            record["apps"], rast = phase_apps(torch, cfg, checked,
                                              held_out_images)
            results.append(rast)
            log(f"phase 13 done in {time.perf_counter() - t:.1f} s")
        # ---- 14: DP / FSDP / TP, the SD weight port, introspection
        if 14 in phases:
            log("phase 14 parallel/mesh.py on the card (NCCL, world 1; 2 "
                "gloo ranks), the SD-v1.4 weight port, introspection")
            t = time.perf_counter()
            record["distributed"] = phase_distributed(torch, F, cfg,
                                                      checked)
            log(f"phase 14 done in {time.perf_counter() - t:.1f} s")
        # ---- 15: f32 on the card
        if 15 in phases:
            log("phase 15 f32 on the card: the f32 kernels, small() card "
                "against CPU, the held-out harness, a train step, the VAE "
                "eval, the CLIs")
            t = time.perf_counter()
            record["f32"], f32_launches = phase_f32(torch, F, record,
                                                    small_ckpt)
            results += record["f32"]["a"]["cases"]
            launches.update(f32_launches)
            log(f"phase 15 done in {time.perf_counter() - t:.1f} s")
        # ---- 16: the user's data path
        if 16 in phases:
            log("phase 16 the user's data path: obj2mesh and light2map on "
                "the card, eval.quality with the JAX tool's flags at "
                "flagship, the export round trip at small()")
            t = time.perf_counter()
            record["user_data"] = phase_user_data(
                torch, cfg, checked,
                small_ckpt if os.path.isdir(small_ckpt) else None)
            log(f"phase 16 done in {time.perf_counter() - t:.1f} s")
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(keep_root, ignore_errors=True)
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
