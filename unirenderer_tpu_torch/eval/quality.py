"""The held-out quality harness (counterpart of `tools/eval_quality.py`):
render the held-out maps with the render collate, forward-render them with
the pipeline and score PSNR against the rendered image; with `--inverse`,
also inverse-render the rendered image and score the maps it gives back
(per-map PSNR, the normal angle, the masked metallic/roughness error).

    python -m unirenderer_tpu_torch.eval.quality [--device cuda]
        [--dtype float32] [--n 32] [--steps 20] [--noise-seeds 1000]
        [--inverse] [--ensemble 1] [--lpips] [--fid]
        [--lpips-weights VGG16_FEATURES.pt LPIPS_VGG.pt]
        [--inception-weights INCEPTION_V3.pt]

writes the seed-99 held-out set of `tools/make_data_r05.sh` (32 meshes, 8
envs; ~2 MB) to a temporary directory with `data/synthetic.py`, loads the
trained small() weights (`artifacts/r05/dual_small.npz`,
`artifacts/r04/vae_small.npz`) and the text encoder the JAX harness scores
with (`artifacts/r05/text_small.npz`, written by
`tools/export_text_params_r05.py`), and prints one JSON line with the
scores per noise seed.  `--lpips` / `--fid` add LPIPS and FID of the
forward images against the rendered ones (`perceptual_scores`, f32 on the
device); without weight files the backbones are seeded random ones and
the report says `lpips_calibrated` / `fid_calibrated` false.  The harness
computes in f32 by default on either device, as tools/eval_quality.py
scores small(): on the card the f32 kernels, with cuDNN and cuBLAS
without TF32; `--dtype bfloat16` runs the bf16 kernels.

With any of tools/eval_quality.py's own flags the CLI is that tool: the
user's preprocessed data (or sphere scenes) and checkpoints, both legs,
one JSON report with its keys:

    python -m unirenderer_tpu_torch.eval.quality --mesh-dir data/meshes \
        --env-dir data/envs [--out quality_report.json] [--ckpt DIR|NPZ]
        [--vae-ckpt DIR|NPZ] [--n 16] [--steps 20] [--ensemble 1]
        [--config tiny|small|medium|flagship] [--tiny] [--synthetic]
        [--dump-images DIR] [--dump-max-batches 2] [--lpips] [--fid]

`--mesh-dir` / `--env-dir` are what `data.obj2mesh` / `data.light2map`
write: n items of `ObjaverseDataTest` (seed 1234) in batches of 4;
`--synthetic` sphere scenes in batches of 2 instead.  Batch i draws both
legs' noise from generators seeded 1000 + i.  `--ckpt` is a checkpoint
directory (`python -m unirenderer_tpu_torch.train`'s `checkpoints`) or an
npz (`core.export_params`); one that holds no checkpoint aborts, and no
`--ckpt` scores seeded random weights, labelled a harness check.  The
compute type is bf16 at flagship and f32 otherwise (`--dtype` overrides).
The text encoder is the JAX harness's draw at small()
(`artifacts/r05/text_small.npz`) and the port's own seeded draw at the
other configs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from unirenderer_tpu_torch.data.objaverse import (
    ObjaverseDataTest, collate_render,
)
from unirenderer_tpu_torch.eval import metrics as M
from unirenderer_tpu_torch.eval.metrics import NormalMetric, masked_mean, psnr

BATCH = 4
ITEM_SEED = 1234          # ObjaverseDataTest's item sampler
# the held-out set of tools/make_data_r05.sh (the generator's defaults
# for the rest: 64 env samples, sphere 32, 64^2 textures)
HELD_OUT = dict(n_mesh=32, n_env=8, env_res=32, env_min_res=8, seed=99)
DUAL_NPZ = "artifacts/r05/dual_small.npz"
VAE_NPZ = "artifacts/r04/vae_small.npz"
TEXT_NPZ = "artifacts/r05/text_small.npz"
INVERSE_MAPS = ("normal", "albedo", "spec_light", "diff_light")


def held_out_paths(root: str):
    """(sorted mesh .npz paths, sorted env dirs) of a dataset written by
    `data/synthetic.py`."""
    meshes = sorted(glob.glob(os.path.join(root, "meshes", "*.npz")))
    envs = sorted(d for d in glob.glob(os.path.join(root, "envs", "*"))
                  if os.path.isdir(d))
    if not meshes or not envs:
        raise FileNotFoundError(f"no meshes or envs under {root}")
    return meshes, envs


def _held_out_batches(pipe, mesh_paths: List[str], env_dirs: List[str],
                      n: int):
    """`n` held-out items (ObjaverseDataTest with seed 1234) collated in
    batches of 4 at the VAE's resolution on the pipeline's device."""
    res = pipe.cfg.vae.sample_size
    ds = ObjaverseDataTest(pipe.cfg.data, mesh_paths, env_dirs,
                           seed=ITEM_SEED)
    items = [ds[i % len(ds)] for i in range(n)]
    for start in range(0, n, BATCH):
        yield collate_render(items[start:start + BATCH], resolution=res,
                             device=pipe.device)


def _numpy(x) -> np.ndarray:
    return x.float().cpu().numpy()


def _generator(pipe, seed: int) -> torch.Generator:
    return torch.Generator(device=pipe.device).manual_seed(seed)


def forward_batch(pipe, batch, num_steps: int, seed: int):
    """One batch's forward render from its rendered maps, with
    `material_image_encode=True`, noise from a generator seeded `seed`."""
    return pipe.mask2image_3mod_albedo(
        normal=batch["normal"], albedo=batch["albedo"],
        spec_light=batch["spec_light"], diff_light=batch["diff_light"],
        env=batch["env"], mask=batch["mask"], metallic=batch["metallic"],
        roughness=batch["roughness"], generator=_generator(pipe, seed),
        num_steps=num_steps, material_image_encode=True)


def inverse_batch(pipe, batch, num_steps: int, seed: int, ensemble: int):
    """One batch's inverse render of its rendered image and mask
    (`ensemble` members), noise from a generator seeded `seed`."""
    return pipe.real_image2mask_3mod_albedo(
        image=batch["image"], mask=batch["mask"],
        generator=_generator(pipe, seed), num_steps=num_steps,
        ensemble=ensemble)


def perceptual_scores(images, device="cuda", lpips: bool = True,
                      fid: bool = True, lpips_weights=None,
                      inception_weights=None) -> Dict:
    """LPIPS and FID of forward images against ground truth (the
    `--lpips` / `--fid` legs of `tools/eval_quality.py`), f32 on
    `device`.  `images`: per batch (gt, fwd) (B, H, W, 3) in [0, 1].
    LPIPS is the mean over images of LPIPS(gt * 2 - 1, fwd * 2 - 1); FID
    (only with 8 images or more) is over all of them, 4 a call through
    InceptionV3.  Without weight files (`lpips_weights`: the VGG16
    features and the lpips heads; `inception_weights`) the backbones are
    the seeded random ones and `*_calibrated` is false."""
    from unirenderer_tpu_torch.eval import inception as inc
    from unirenderer_tpu_torch.eval import lpips as lp
    out = {}
    gts = [g for g, _ in images]
    fwds = [f for _, f in images]
    if lpips:
        model = (lp.lpips_from_files(*lpips_weights, device=device)
                 if lpips_weights else lp.random_lpips(device=device))
        fn, _ = lp.make_lpips_fn(model)
        out["lpips_forward_vs_gt"] = float(np.concatenate(
            [fn(g * 2 - 1, f * 2 - 1) for g, f in images]).mean())
        out["lpips_calibrated"] = bool(lpips_weights)
    if fid and sum(len(g) for g in gts) >= 8:
        model = (inc.inception_from_file(inception_weights, device=device)
                 if inception_weights else inc.random_inception(
                     device=device))
        feat = inc.make_feature_fn(model, batch=4)
        out["fid_forward_vs_gt"] = M.fid(np.concatenate(gts),
                                         np.concatenate(fwds), feat)
        out["fid_calibrated"] = bool(inception_weights)
    return out


class InverseTally:
    """The inverse leg's scores over batches: per-map PSNR of normal,
    albedo, spec_light and diff_light (mean over batches), the normal
    angle inside the mask over all pixels (`NormalMetric`), and the mean
    over batches of the masked metallic/roughness MAE."""

    def __init__(self):
        self.maps = {k: [] for k in INVERSE_MAPS}
        self.normal = NormalMetric()
        self.mr_mae = []

    def add(self, batch, inv) -> None:
        for k in INVERSE_MAPS:
            self.maps[k].append(psnr((_numpy(inv[k]) + 1) / 2,
                                     (_numpy(batch[k]) + 1) / 2))
        mask01 = (_numpy(batch["mask"])[..., 0] + 1) / 2 > 0.5
        self.normal.update(_numpy(inv["normal"]), _numpy(batch["normal"]),
                           mask01)
        m_pred = masked_mean(_numpy(inv["metallic"]), mask01)
        r_pred = masked_mean(_numpy(inv["roughness"]), mask01)
        self.mr_mae.append(float(
            np.abs(m_pred - _numpy(batch["metallic"])).mean()
            + np.abs(r_pred - _numpy(batch["roughness"])).mean()) / 2)

    def result(self) -> Dict:
        return dict(psnr_maps={k: float(np.mean(v))
                               for k, v in self.maps.items()},
                    normal_angle=self.normal.summary(),
                    metal_rough_mae=float(np.mean(self.mr_mae)))


def small_trained_pipeline(device="cuda", dtype=torch.bfloat16,
                           root: str = "."):
    """The small() pipeline with the repo's trained weights and the text
    encoder the JAX harness scores with (the r05 weights carry none: the
    JAX harness draws it from `UniRendererPipeline.create(small(),
    key(0), f32)`, and `tools/export_text_params_r05.py` wrote it out)."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    pipe = UniRendererPipeline.create(
        config.small(), torch.Generator(device=device).manual_seed(0),
        device=device, dtype=dtype)
    dual, _ = load_params_npz(os.path.join(root, DUAL_NPZ))
    vae, _ = load_params_npz(os.path.join(root, VAE_NPZ))
    text, _ = load_params_npz(os.path.join(root, TEXT_NPZ))
    pipe.load_flax(dual=dual, vae=vae, text=text)
    return pipe


def held_out_scores(pipe, n: int = 32, num_steps: int = 20,
                    noise_seeds: Sequence[int] = (1000,),
                    inverse: bool = False, ensemble: int = 1,
                    log=None, keep_images: bool = False) -> Dict:
    """Write the held-out set to a temporary directory (env prefilter on the
    pipeline's device), then `tool_scores` of its `n` items once per noise
    seed (batch i's noise seeded `seed + i`), the inverse leg with
    `inverse`.  "runs" holds each seed's `tool_scores`; the top level the
    means over seeds."""
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    with tempfile.TemporaryDirectory(prefix="held_out_") as root:
        t = time.perf_counter()
        write_dataset(root, device=pipe.device,
                      log=log or (lambda msg: None), **HELD_OUT)
        gen_s = time.perf_counter() - t
        meshes, envs = held_out_paths(root)
        runs = [dict(tool_scores(
            pipe, _held_out_batches(pipe, meshes, envs, n), num_steps,
            ensemble, inverse=inverse, seed_base=seed,
            keep_images=keep_images, log=log), n_objects=n,
            steps=num_steps, noise_seed=seed) for seed in noise_seeds]
    vals = [r["psnr_forward_render"] for r in runs]
    out = dict(psnr_forward_render=float(np.mean(vals)), per_seed=vals,
               runs=runs, generate_seconds=gen_s, held_out=HELD_OUT)
    if inverse:
        out["inverse"] = dict(
            psnr_maps={k: float(np.mean([r["psnr_maps"][k] for r in runs]))
                       for k in INVERSE_MAPS},
            normal_angle_mean=float(np.mean(
                [r["normal_angle"]["mean"] for r in runs])),
            metal_rough_mae=float(np.mean(
                [r["metal_rough_mae"] for r in runs])),
            ensemble=ensemble)
    return out


# ---------------------------------------------------------------------------
# tools/eval_quality.py's interface: the user's data and checkpoints
# ---------------------------------------------------------------------------

TOOL_FLAGS = ("mesh_dir", "env_dir", "synthetic", "ckpt", "vae_ckpt",
              "config", "tiny", "out", "dump_images", "dump_max_batches")
TOOL_N = 16               # the JAX tool's defaults
TOOL_NOISE_SEED = 1000
TOOL_DUMP_MAX = 2
SYNTHETIC_BATCH = 2
GRID_COLUMNS = ("image", "normal", "albedo", "spec_light", "diff_light")


def synthetic_batches(cfg, n: int, device="cuda") -> List[Dict]:
    """`n` sphere scenes (a 12-ring UV sphere, one constant albedo, a
    constant white env; metallic / roughness from the material grid and
    cameras drawn by `random.Random(0)`, as tools/eval_quality.py's
    `_synthetic_batches`) collated in batches of 2 at the VAE's
    resolution: no dataset needed."""
    import random

    from unirenderer_tpu_torch.data.objaverse import material_grid
    from unirenderer_tpu_torch.render.mesh import make_sphere
    sphere = make_sphere(12)
    kd = np.asarray([0.6, 0.5, 0.4], np.float32)
    mesh = {"v_pos": np.asarray(sphere.v_pos),
            "t_idx": np.asarray(sphere.t_pos_idx),
            "v_nrm": np.asarray(sphere.v_nrm),
            "v_tex": np.asarray(sphere.v_tex),
            "v_tng": np.asarray(sphere.v_tng), "kd": kd,
            "kd_tex": np.broadcast_to(kd, (cfg.data.texture_res,
                                           cfg.data.texture_res, 3)).copy()}
    env = {"specular_0": np.ones((6, 8, 8, 3), np.float32),
           "specular_1": np.ones((6, 4, 4, 3), np.float32),
           "diffuse": np.ones((6, 4, 4, 3), np.float32)}
    rng = random.Random(0)
    grid = material_grid(cfg.data.material_grid)
    items = []
    for _ in range(n):
        m, r = rng.choice(grid)
        items.append(dict(mesh=mesh, env=env, metallic=m, roughness=r,
                          azimuth=rng.uniform(0, 360),
                          elevation=rng.uniform(60, 120),
                          distance=cfg.data.camera_distance))
    return [collate_render(items[i:i + SYNTHETIC_BATCH],
                           resolution=cfg.vae.sample_size, device=device)
            for i in range(0, n, SYNTHETIC_BATCH)]


def checkpoint_params(path: str, flag: str):
    """({flax path: array}, step) of a params npz or of the newest readable
    checkpoint in a `CheckpointManager` directory.  A path that holds no
    checkpoint exits: random weights must not be scored under a trained
    label."""
    from unirenderer_tpu_torch.core.checkpoint import (
        CheckpointManager, load_params_npz,
    )
    if path.endswith(".npz"):
        return load_params_npz(path)
    flat = None
    if os.path.isdir(path):
        cm = CheckpointManager(path)
        flat = cm.restore_params()
    if flat is None:
        raise SystemExit(
            f"[eval] FATAL: {flag} {path} has no restorable checkpoint; "
            f"refusing to eval random weights under a trained label (pass "
            f"no {flag} for a harness check)")
    return flat, cm.restored_step()


def tool_pipeline(name: str, device, dtype, ckpt: Optional[str] = None,
                  vae_ckpt: Optional[str] = None, text=None):
    """(pipeline, checkpoint step) of config `name`: seeded random weights
    (generator seeded 0 on `device`), the dual-stream params from `ckpt`
    and the VAE's from `vae_ckpt` where given (`checkpoint_params`), and
    the text encoder `text` ({flax path: array}); by default the JAX
    harness's draw at small() (`TEXT_NPZ`) and the seeded draw at the
    other configs."""
    from unirenderer_tpu_torch.core import config
    from unirenderer_tpu_torch.core.checkpoint import load_params_npz
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline
    dual, step = checkpoint_params(ckpt, "--ckpt") if ckpt else (None, None)
    vae = checkpoint_params(vae_ckpt, "--vae-ckpt")[0] if vae_ckpt else None
    if text is None and name == "small":
        text, _ = load_params_npz(TEXT_NPZ)
    pipe = UniRendererPipeline.create(
        getattr(config, name)(),
        torch.Generator(device=device).manual_seed(0), device=device,
        dtype=dtype)
    pipe.load_flax(dual=dual, vae=vae, text=text)
    return pipe, step


def dump_grid(out_dir: str, bi: int, batch, fwd, inv) -> str:
    """One PNG of batch `bi` (tools/eval_quality.py's `_dump_grid`): per
    object a ground-truth row (image, normal, albedo, spec_light,
    diff_light) above the prediction row (forward render, then the
    inverse-rendered maps), 2-pixel white gaps.  Returns its path."""
    from PIL import Image

    def to_u8(x):  # [-1, 1] (B, H, W, 3) -> uint8
        return (np.clip((_numpy(x) + 1) / 2, 0, 1) * 255).astype(np.uint8)

    gt_rows = [to_u8(batch[k]) for k in GRID_COLUMNS]
    pred_rows = [to_u8(fwd)] + [to_u8(inv[k]) for k in GRID_COLUMNS[1:]]
    b, h, w = gt_rows[0].shape[:3]
    pad = 2
    grid = np.full((b * 2 * (h + pad) + pad,
                    len(GRID_COLUMNS) * (w + pad) + pad, 3), 255, np.uint8)
    for oi in range(b):
        for ci in range(len(GRID_COLUMNS)):
            y0 = pad + 2 * oi * (h + pad)
            x0 = pad + ci * (w + pad)
            grid[y0:y0 + h, x0:x0 + w] = gt_rows[ci][oi]
            grid[y0 + h + pad:y0 + 2 * h + pad, x0:x0 + w] = \
                pred_rows[ci][oi]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"eval_grid_b{bi}.png")
    Image.fromarray(grid).save(path)
    return path


def tool_scores(pipe, batches: Iterable[Dict], num_steps: int = 20,
                ensemble: int = 1, inverse: bool = True,
                seed_base: int = TOOL_NOISE_SEED,
                dump_images: Optional[str] = None,
                dump_max_batches: int = TOOL_DUMP_MAX,
                keep_images: bool = False, log=None) -> Dict:
    """tools/eval_quality.py's loop: each batch forward-rendered from its
    maps (`material_image_encode`) and, with `inverse`, its image
    inverse-rendered, both legs' noise from generators seeded `seed_base`
    + batch index; the forward PSNR (unclipped) per batch and its mean,
    and `InverseTally`'s scores.  "seconds" holds each batch's (forward,
    inverse or None) wall, each ending in a copy to the host; with
    `keep_images`, "images" per batch (gt, clip(fwd)) in [0, 1]
    (`perceptual_scores`' input); with `dump_images`, the first
    `dump_max_batches` batches' grids (`dump_grid`, needs `inverse`)."""
    psnr_fwd, images, seconds = [], [], []
    tally = InverseTally()
    for bi, batch in enumerate(batches):
        seed = seed_base + bi
        t = time.perf_counter()
        fwd = forward_batch(pipe, batch, num_steps, seed)
        gt01 = (_numpy(batch["image"]) + 1) / 2
        psnr_fwd.append(psnr((_numpy(fwd) + 1) / 2, gt01))
        t_fwd = time.perf_counter() - t
        if keep_images:
            images.append((gt01, (np.clip(_numpy(fwd), -1, 1) + 1) / 2))
        msg = f"batch {bi}: psnr_fwd={psnr_fwd[-1]:.2f}"
        if not inverse:
            seconds.append((t_fwd, None))
            if log is not None:
                log(f"{msg} (forward {t_fwd:.3f} s)")
            continue
        t = time.perf_counter()
        inv = inverse_batch(pipe, batch, num_steps, seed, ensemble)
        tally.add(batch, inv)
        seconds.append((t_fwd, time.perf_counter() - t))
        if dump_images and bi < dump_max_batches:
            path = dump_grid(dump_images, bi, batch, fwd, inv)
            if log is not None:
                log(f"wrote {path} (rows: GT over prediction; cols: "
                    f"{', '.join(GRID_COLUMNS)})")
        if log is not None:
            log(f"{msg} inverse psnr normal={tally.maps['normal'][-1]:.2f} "
                f"albedo={tally.maps['albedo'][-1]:.2f} "
                f"mr_mae={tally.mr_mae[-1]:.3f} (forward {t_fwd:.3f} s, "
                f"inverse {seconds[-1][1]:.3f} s)")
    out = dict(psnr_forward_render=float(np.mean(psnr_fwd)),
               per_batch=psnr_fwd, seconds=seconds)
    if inverse:
        out.update(tally.result(), ensemble=ensemble)
    if keep_images:
        out["images"] = images
    return out


def tool_main(args, text=None) -> Dict:
    """tools/eval_quality.py on the port: the report it writes to
    `args.out` (and returns)."""
    from unirenderer_tpu_torch.utils.runtime import (
        disable_tf32, kernel_launches, setup_runtime,
    )
    if not args.synthetic and not (args.mesh_dir and args.env_dir):
        raise SystemExit("[eval] need --mesh-dir and --env-dir "
                         "(preprocessed meshes + envs), or --synthetic")
    device = setup_runtime(args.device)
    name = "tiny" if args.tiny else (args.config or "flagship")
    dtype = args.dtype or ("bfloat16" if name == "flagship" else "float32")
    if dtype == "float32":
        disable_tf32()
    n = TOOL_N if args.n is None else args.n
    pipe, step = tool_pipeline(name, device, getattr(torch, dtype),
                               args.ckpt, args.vae_ckpt, text)
    print(f"[eval] {name} in {dtype} on {device}; "
          + (f"checkpoint step {step} from {args.ckpt}" if args.ckpt
             else "random weights (harness check)"), flush=True)
    if args.synthetic:
        batches = synthetic_batches(pipe.cfg, n, device)
    else:
        from unirenderer_tpu_torch.train.__main__ import data_paths
        meshes, envs = data_paths(args.mesh_dir, args.env_dir)
        if not (meshes and envs):
            raise SystemExit("[eval] need preprocessed meshes + envs")
        batches = _held_out_batches(pipe, meshes, envs, n)
    scores = tool_scores(pipe, batches, args.steps,
                         1 if args.ensemble is None else args.ensemble,
                         dump_images=args.dump_images,
                         dump_max_batches=(TOOL_DUMP_MAX if
                                           args.dump_max_batches is None
                                           else args.dump_max_batches),
                         keep_images=args.lpips or args.fid,
                         log=lambda msg: print(f"[eval] {msg}", flush=True))
    report = {
        "n_objects": n,
        "steps": args.steps,
        "psnr_forward_render": scores["psnr_forward_render"],
        "psnr_maps": scores["psnr_maps"],
        "normal_angle": scores["normal_angle"],
        "metal_rough_mae": scores["metal_rough_mae"],
        "checkpoint": args.ckpt or "random-weights (harness check)",
        "checkpoint_loaded": bool(args.ckpt),
        "checkpoint_step": step,
    }
    if args.lpips or args.fid:
        report.update(perceptual_scores(
            scores["images"], device, lpips=args.lpips, fid=args.fid,
            lpips_weights=args.lpips_weights,
            inception_weights=args.inception_weights))
    out = args.out or "quality_report.json"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"[eval] kernel launches {json.dumps(kernel_launches())}",
          flush=True)
    return report


def main(argv=None, text=None):
    """With tools/eval_quality.py's flags, returns its report.  `text`:
    the text encoder's params for that run (as `tool_pipeline` takes
    them), in place of its default draw."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="compute type; default float32, as "
                         "tools/eval_quality.py scores small() (with its "
                         "flags: bfloat16 at flagship)")
    ap.add_argument("--n", type=int, default=None,
                    help="objects (default 32; with the JAX tool's flags "
                         "16)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--noise-seeds", default=None,
                    help="default 1000 (not with the JAX tool's flags: "
                         "batch i's noise is seeded 1000 + i)")
    ap.add_argument("--inverse", action="store_true",
                    help="also score the inverse leg (always with the JAX "
                         "tool's flags)")
    ap.add_argument("--ensemble", type=int, default=None,
                    help="inverse ensemble members (small(): 1; with the "
                         "JAX tool's flags 1)")
    ap.add_argument("--lpips", action="store_true",
                    help="also LPIPS(forward, rendered), per noise seed")
    ap.add_argument("--fid", action="store_true",
                    help="also FID(forward, rendered), per noise seed "
                         "(needs n >= 8)")
    ap.add_argument("--lpips-weights", nargs=2,
                    metavar=("VGG16_FEATURES.pt", "LPIPS_VGG.pt"),
                    help="torchvision VGG16 features and lpips heads "
                         "state_dicts; a random backbone otherwise")
    ap.add_argument("--inception-weights",
                    help="torchvision inception_v3 state_dict; a random "
                         "backbone otherwise")
    tool = ap.add_argument_group(
        "tools/eval_quality.py's flags (any of them: its run, both legs)")
    tool.add_argument("--mesh-dir", help="meshes from data.obj2mesh")
    tool.add_argument("--env-dir", help="envs from data.light2map")
    tool.add_argument("--synthetic", action="store_true",
                      help="synthetic sphere scenes (no data needed)")
    tool.add_argument("--ckpt", help="checkpoint directory or params npz")
    tool.add_argument("--vae-ckpt", help="VAE checkpoint directory "
                                         "(train.vae's) or params npz")
    tool.add_argument("--config", choices=("tiny", "small", "medium",
                                           "flagship"),
                      help="default flagship")
    tool.add_argument("--tiny", action="store_true",
                      help="alias for --config tiny")
    tool.add_argument("--out", help="the JSON report (default "
                                    "quality_report.json)")
    tool.add_argument("--dump-images",
                      help="directory for one PNG grid per batch: per "
                           "object a GT row (image, normal, albedo, spec, "
                           "diff) above the prediction row")
    tool.add_argument("--dump-max-batches", type=int, default=None,
                      help=f"default {TOOL_DUMP_MAX}")
    args = ap.parse_args(argv)
    if any(getattr(args, f) not in (None, False) for f in TOOL_FLAGS):
        if args.noise_seeds is not None:
            ap.error("--noise-seeds: with the JAX tool's flags batch i's "
                     "noise is seeded 1000 + i")
        return tool_main(args, text)
    from unirenderer_tpu_torch.utils.runtime import (
        disable_tf32, setup_runtime,
    )
    args.device = str(setup_runtime(args.device))
    args.dtype = args.dtype or "float32"
    if args.dtype == "float32":
        disable_tf32()
    pipe = small_trained_pipeline(args.device, getattr(torch, args.dtype))
    ensemble = (pipe.cfg.sampler.ensemble if args.ensemble is None
                else args.ensemble)
    out = held_out_scores(pipe, 32 if args.n is None else args.n, args.steps,
                          [int(s) for s in
                           (args.noise_seeds or "1000").split(",")],
                          inverse=args.inverse, ensemble=ensemble,
                          log=lambda msg: print(msg, flush=True),
                          keep_images=args.lpips or args.fid)
    for run in out["runs"]:
        images = run.pop("images", None)
        if images is not None:
            run.update(perceptual_scores(
                images, args.device, lpips=args.lpips, fid=args.fid,
                lpips_weights=args.lpips_weights,
                inception_weights=args.inception_weights))
    out.update(device=args.device, dtype=args.dtype, torch=torch.__version__)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
