"""Agreement of one training step between two settings (device, compute
type), from the same weights, batch and draws: the relative loss error,
the cosine of the flattened gradients and the ratio of their norms.

`compare([("cuda", torch.bfloat16), ("cpu", torch.float32)])` holds the
card (bf16, the kernels) against f32 on the CPU at `small()` with the
trained r05 weights, both branches of the dual timestep draw
(`chip_smoke.py` phase 9); `[("cuda", torch.float32), ("cpu",
torch.float32)]` the card's f32 kernels (cuDNN and cuBLAS without TF32)
against the same (phase 15); `[("cpu", torch.bfloat16), ("cpu",
torch.float32)]` measures the bf16 gap alone, with the plain versions.
`compare_bank` does the same for scene-bank steps: scenes drawn from a
bank and collated on each setting's device (K4 on the card), with the
share of the collated maps' values that agree to 1e-3 and the gradient
cosine of each group of parameters (stream x attention / norm / other).
A setting `device:dtype[:option...]` (`parse_setting`) may run K1 or
K2 (forward and backward) as their plain versions on the card, or turn
off cuBLAS's reduced-precision bf16 sums, cuDNN or TF32, to find where
the card departs from f32; the last setting is the reference:

    python -m unirenderer_tpu_torch.train.compare --bank held_out \
        --seeds 21,22 [--settings cuda:bfloat16,cpu:bfloat16,cpu:float32]
    python -m unirenderer_tpu_torch.train.compare \
        --settings cuda:float32,cpu:float32
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from unirenderer_tpu_torch.core import config
from unirenderer_tpu_torch.core.checkpoint import load_params_npz
from unirenderer_tpu_torch.eval.quality import DUAL_NPZ, TEXT_NPZ, VAE_NPZ
from unirenderer_tpu_torch.train.train_step import (
    BATCH_KEYS, Draws, draw, make_grad_fn,
)
from unirenderer_tpu_torch.train.trainer import Trainer


def small_weights(root: str = ".") -> Dict[str, Mapping[str, np.ndarray]]:
    """The trained small() weights the repo carries (dual, vae, text)."""
    return {k: load_params_npz(os.path.join(root, p))[0] for k, p in
            (("dual", DUAL_NPZ), ("vae", VAE_NPZ), ("text", TEXT_NPZ))}


def trainer_with(cfg, weights, device, dtype: torch.dtype, workdir,
                 **trainer_kwargs) -> Trainer:
    """A Trainer computing in `dtype`, with every weight loaded strictly
    (None: the Trainer's seeded random ones; `trainer_kwargs`: e.g. a
    scene bank)."""
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype=str(dtype).removeprefix("torch.")))
    tr = Trainer(cfg, workdir, device=device, **trainer_kwargs)
    if weights is not None:
        tr.install_dual(weights["dual"])
        tr.install_vae(weights["vae"])
        tr.install_text(weights["text"])
    return tr


def step_grads(tr: Trainer, batch: Mapping[str, torch.Tensor],
               draws: Draws) -> Tuple[torch.Tensor, float]:
    """(all gradients flattened, f64 on the host; the loss) of one step."""
    grad_fn = make_grad_fn(tr.cfg, tr.dual, tr.vae, tr.schedule,
                           tr.compute_dtype)
    b = {k: v.to(tr.device) for k, v in batch.items()}
    grads, metrics = grad_fn(tr.state.params, b, tr.ctx,
                             draws.to(tr.device))
    flat = torch.cat([g.flatten().double().cpu() for g in grads])
    return flat, float(metrics["loss"])


def agreement(a: Tuple[torch.Tensor, float],
              b: Tuple[torch.Tensor, float]) -> Dict[str, float]:
    """a against b (the reference): relative loss error, gradient cosine,
    gradient norm ratio."""
    (ga, la), (gb, lb) = a, b
    na, nb = float(ga.norm()), float(gb.norm())
    return dict(loss_rel_err=abs(la - lb) / abs(lb),
                grad_cos=float(ga @ gb) / (na * nb), norm_ratio=na / nb,
                loss=la, loss_ref=lb, grad_norm=na, grad_norm_ref=nb)


def smooth_batch(cfg, batch: int, seed: int) -> Dict[str, torch.Tensor]:
    """Smooth maps in [-1, 1] (bilinear upsampling of a 8x8 field) and a
    disc mask, from numpy, on the host."""
    rng = np.random.default_rng(seed)
    hw = cfg.vae.sample_size
    out = {}
    for k in BATCH_KEYS:
        z = torch.from_numpy(rng.standard_normal((batch, 3, 8, 8))
                             .astype(np.float32))
        z = torch.nn.functional.interpolate(z, size=(hw, hw),
                                            mode="bilinear",
                                            align_corners=False)
        out[k] = torch.tanh(z).permute(0, 2, 3, 1).contiguous()
    yy, xx = np.meshgrid(np.linspace(-1, 1, hw), np.linspace(-1, 1, hw),
                         indexing="ij")
    disc = np.where(xx ** 2 + yy ** 2 < 0.6, 1.0, -1.0).astype(np.float32)
    out["mask"] = torch.from_numpy(disc)[None, :, :, None].expand(
        batch, hw, hw, 3).contiguous()
    return out


def compare(settings: Sequence[Tuple[str, torch.dtype]], batch: int = 2,
            seed: int = 1234) -> Dict[str, Dict[str, float]]:
    """small() with the r05 weights: for each branch, one step's gradients
    under settings[0] against settings[1] (the reference): `agreement`,
    and under "groups" the cosine of each group of parameters (stream x
    attention / norm / other, `group_cosines`)."""
    cfg = config.small()
    weights = small_weights()
    data = smooth_batch(cfg, batch, seed)
    lat = cfg.vae.sample_size // cfg.vae.downscale
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainers = [trainer_with(cfg, weights, dev, dt, tmp)
                    for dev, dt in settings]
        for inverse in (True, False):
            draws = draw(torch.Generator().manual_seed(seed), batch,
                         (lat, lat), cfg.diffusion.num_train_timesteps,
                         inverse)
            res = [step_grads(tr, data, draws) for tr in trainers]
            r = agreement(*res)
            r["groups"] = group_cosines(
                res[0][0], res[1][0], param_groups(trainers[0].state.params))
            out["inverse" if inverse else "forward"] = r
    return out


PLAIN_KERNELS = ("groupnorm", "attention")


def parse_setting(text: str) -> Tuple[str, torch.dtype, Tuple[str, ...]]:
    """'device:dtype[:option...]' -> (device, dtype, options); options:
    plain-groupnorm, plain-attention, exact-sums, no-cudnn, no-tf32."""
    dev, dt, *opts = text.split(":")
    known = {f"plain-{k}" for k in PLAIN_KERNELS} | {
        "exact-sums", "no-cudnn", "no-tf32"}
    if set(opts) - known:
        raise ValueError(f"unknown options {sorted(set(opts) - known)} in "
                         f"{text!r}")
    return dev, getattr(torch, dt), tuple(opts)


@contextlib.contextmanager
def card_variant(options: Sequence[str]) -> Iterator[None]:
    """Within: the kernels named `plain-<kernel>` in `options` run their
    plain versions on CUDA tensors too (K1; K2 and K2 bwd); with
    `exact-sums` cuBLAS sums bf16 products in f32 only; `no-cudnn` runs
    convolutions without cuDNN, `no-tf32` f32 products without TF32.
    For measuring how far each moves a step from f32; training never
    runs this."""
    from unirenderer_tpu_torch.ops import flash_attention as fa
    from unirenderer_tpu_torch.ops import groupnorm as gn
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (gn._launch, fa._launch, fa._launch_backward,
             mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32,
             dnn.enabled, dnn.allow_tf32)
    if "plain-groupnorm" in options:
        gn._launch = gn.groupnorm_silu_reference
    if "plain-attention" in options:
        fa._launch = lambda q, k, v, with_lse=False: (
            fa.attention_lse_reference(q, k, v) if with_lse
            else fa.attention_reference(q, k, v))
        fa._launch_backward = fa.attention_backward_reference
    if "exact-sums" in options:
        mm.allow_bf16_reduced_precision_reduction = False
    if "no-cudnn" in options:
        dnn.enabled = False
    if "no-tf32" in options:
        mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        yield
    finally:
        (gn._launch, fa._launch, fa._launch_backward,
         mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32,
         dnn.enabled, dnn.allow_tf32) = saved


def param_groups(params: Mapping[str, torch.Tensor]
                 ) -> Dict[str, List[Tuple[int, int]]]:
    """{'<stream>/<attn|norm|other>': [(start, end) of each parameter in
    the flattened gradient]}: attention blocks' parameters (norms
    included) are 'attn', the other normalisations' 'norm'."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    at = 0
    for name, p in params.items():
        kind = ("attn" if ".attn_" in name
                else "norm" if "norm" in name else "other")
        out.setdefault(f"{name.split('.')[0]}/{kind}", []).append(
            (at, at + p.numel()))
        at += p.numel()
    return out


def group_cosines(ga: torch.Tensor, gb: torch.Tensor,
                  groups: Mapping[str, List[Tuple[int, int]]]
                  ) -> Dict[str, float]:
    """Cosine of ga and gb over each group's parameters."""
    out = {}
    for key, spans in groups.items():
        a = torch.cat([ga[i:j] for i, j in spans])
        b = torch.cat([gb[i:j] for i, j in spans])
        out[key] = float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
    return out


def compare_bank(settings: Sequence[str], bank: Mapping[str, np.ndarray],
                 seeds: Sequence[int] = (21,), batch: int = 2
                 ) -> Dict[str, Dict]:
    """small() with the r05 weights, scene-bank steps: for each branch and
    seed, the scenes' draws and the step's draws from one generator seeded
    `seed`, the scenes built and collated on each setting's device, and
    one step's gradients under each setting (`parse_setting`) against the
    last one (the reference).  Keys '<setting>/<branch>/<seed>'; besides
    `agreement`, `groups` (`group_cosines`) and `collate_within_1e-3`: the
    smallest share, over the 8 maps, of values of the setting's collate
    within 1e-3 of the reference's."""
    from unirenderer_tpu_torch.data.objaverse import collate_from_scene
    from unirenderer_tpu_torch.data.scene_bank import (
        bank_sizes, bank_to_device, draw_scenes, scenes_from_draws,
    )
    cfg = config.small()
    d = cfg.data
    lat = d.resolution // cfg.vae.downscale
    weights = small_weights()
    parsed = [parse_setting(s) for s in settings]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainers = {}
        for dev, dt, _ in parsed:
            if (dev, dt) not in trainers:
                tr = trainer_with(cfg, weights, dev, dt, tmp)
                trainers[dev, dt] = (tr, bank_to_device(bank, tr.device))
        groups = param_groups(next(iter(trainers.values()))[0]
                              .state.params)
        for inverse in (True, False):
            for seed in seeds:
                gen = torch.Generator().manual_seed(seed)
                sd = draw_scenes(gen, bank_sizes(bank), batch, d)
                draws = draw(gen, batch, (lat, lat),
                             cfg.diffusion.num_train_timesteps, inverse)
                res = []
                for dev, dt, opts in parsed[::-1]:
                    tr, b = trainers[dev, dt]
                    with card_variant(opts):
                        with torch.no_grad():
                            maps = {k: v.float().cpu() for k, v in
                                    collate_from_scene(
                                        scenes_from_draws(b, sd, d),
                                        d.resolution, d.ssaa).items()}
                        res.append((maps, step_grads(tr, maps, draws)))
                (ref_maps, ref), *rest = res
                for text, (maps, got) in zip(settings[-2::-1], rest):
                    r = agreement(got, ref)
                    r["groups"] = group_cosines(got[0], ref[0], groups)
                    r["collate_within_1e-3"] = min(
                        float(((maps[k] - ref_maps[k]).abs() <= 1e-3)
                              .float().mean()) for k in BATCH_KEYS)
                    branch = "inverse" if inverse else "forward"
                    out[f"{text}/{branch}/{seed}"] = r
    return out


def main(argv=None) -> None:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=compare_bank.__doc__
                                 .split("\n")[0])
    ap.add_argument("--bank", choices=("synthetic", "held_out"),
                    default="synthetic",
                    help="`synthetic_bank(small().data)`, or the seed-99 "
                         "held-out set written on the first setting's "
                         "device")
    ap.add_argument("--seeds", default="21")
    ap.add_argument("--settings", default="cuda:bfloat16,cpu:float32",
                    help="comma-separated `parse_setting`s (device:dtype, "
                         "e.g. cuda:float32 for the card's f32 kernels); "
                         "the last is the reference")
    args = ap.parse_args(argv)
    settings = args.settings.split(",")
    from unirenderer_tpu_torch.data import scene_bank
    cfg = config.small()
    with tempfile.TemporaryDirectory() as root:
        if args.bank == "synthetic":
            bank = scene_bank.synthetic_bank(cfg.data)
        else:
            from unirenderer_tpu_torch.data.synthetic import write_dataset
            from unirenderer_tpu_torch.eval.quality import HELD_OUT
            write_dataset(root, device=parse_setting(settings[0])[0],
                          log=lambda msg: None, **HELD_OUT)
            bank = scene_bank.load_scene_bank(
                os.path.join(root, "meshes"), os.path.join(root, "envs"),
                cfg.data)
        seeds = [int(x) for x in args.seeds.split(",")]
        for key, r in compare_bank(settings, bank, seeds).items():
            print(json.dumps(dict(bank=args.bank, step=key, **r)),
                  flush=True)


if __name__ == "__main__":
    main()
