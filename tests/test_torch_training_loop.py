"""The port's training loop pieces around the step, at `tiny()` on the
CPU: validation, the input pipeline, the anomaly guard, the phase timer
and metric logger, and the entry points' default device.

  * `make_validation_fn` at the trainer's current (trained) parameters
    gives each map's PSNR equal to that of the port's own inverse
    pipeline run with the same weights, noise seed and steps; afterwards
    the masters are bit-unchanged and the model is back in train mode;
    the maps are written as PNGs;
  * `host_shard_indices` equals JAX's; `cached_batch_source` yields the
    pool in JAX's order for the same seed, reuses a cache directory and
    raises on a pool of another batch or resolution (JAX's messages);
  * `ThreadedPrefetcher` keeps the order, raises the worker's error in
    the consumer after the batches before it, and `close` stops the
    worker; `rendered_batches` with a prefetch thread gives the same
    batches as without;
  * `AnomalyGuard` follows JAX's (healthy / non-finite / raise at
    `patience` in a row, reset by a finite loss);
  * `Trainer(scene_bank=...)` and `train_vae` without device="cpu" raise
    the no-card error (nothing falls back to the CPU);
  * `train.compare`'s settings parse, its parameter groups cover every
    parameter once, its group cosines see a change in one group only,
    and `card_variant` puts the kernels' launchers back on exit.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from unirenderer_tpu.core.debug import AnomalyGuard as JaxGuard
from unirenderer_tpu.data import input_pipeline as jip
from unirenderer_tpu_torch.core import config as tcfg
from unirenderer_tpu_torch.core.convert import flax_from_module
from unirenderer_tpu_torch.core.debug import AnomalyGuard
from unirenderer_tpu_torch.core.tracing import MetricLogger, PhaseTimer
from unirenderer_tpu_torch.data import input_pipeline as tip
from unirenderer_tpu_torch.data.scene_bank import synthetic_bank
from unirenderer_tpu_torch.eval.metrics import psnr
from unirenderer_tpu_torch.eval.validation import make_validation_fn
from unirenderer_tpu_torch.pipelines import UniRendererPipeline
from unirenderer_tpu_torch.train.trainer import (
    Trainer, rendered_batches, synthetic_batches,
)

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_validation_scores_the_current_parameters(tmp_path):
    cfg = tcfg.tiny(4)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, learning_rate=1e-3))
    tr = Trainer(cfg, str(tmp_path), "cpu")
    tr.train(synthetic_batches(cfg, 2, device="cpu"), max_steps=2)
    val = next(synthetic_batches(cfg, 2, seed=999, device="cpu"))
    fn = make_validation_fn(tr, val, str(tmp_path / "validation"),
                            num_steps=2, noise_seed=5, logger=tr.logger)
    masters = {n: p.detach().clone() for n, p in tr.state.params.items()}
    got = fn(tr.state, 2)
    for n, p in tr.state.params.items():
        assert torch.equal(p, masters[n]), n
    assert tr.dual.training

    pipe = UniRendererPipeline.create(cfg, torch.Generator(), device="cpu",
                                      dtype=torch.float32)
    pipe.load_flax(dual=flax_from_module(tr.dual),
                   vae=flax_from_module(tr.vae),
                   text=flax_from_module(tr.text))
    out = pipe.real_image2mask_3mod_albedo(
        image=val["image"], mask=val["mask"],
        generator=torch.Generator().manual_seed(5), num_steps=2)
    assert set(got) == {f"psnr_{k}" for k in ("normal", "albedo",
                                              "spec_light", "diff_light",
                                              "env")}
    for name, value in got.items():
        k = name.removeprefix("psnr_")
        want = psnr((out[k].numpy() + 1) / 2, (val[k].numpy() + 1) / 2)
        assert abs(value - want) <= 1e-9, (name, value, want)
        assert (tmp_path / "validation" / "step-2" / f"{k}.png").exists()
    logged = [json.loads(line) for line in open(tr.metrics_path)]
    assert logged[-1]["step"] == 2 and "psnr_normal" in logged[-1]


@pytest.mark.parametrize("n,count,seed,shuffle", [
    (10, 1, 0, True), (11, 3, 5, True), (7, 2, 1, False)])
def test_host_shard_indices_match_jax(n, count, seed, shuffle):
    for index in range(count):
        assert tip.host_shard_indices(n, index, count, seed, shuffle) == \
            jip.host_shard_indices(n, index, count, seed, shuffle)


def _pool(n, b=2, res=4):
    rng = np.random.default_rng(0)
    return [{"image": rng.standard_normal((b, res, res, 3)).astype(
        np.float32), "mask": np.full((b, res, res, 3), i, np.float32)}
        for i in range(n)]


def test_cached_batch_source_follows_jax(tmp_path):
    pool = _pool(5)
    want = jip.cached_batch_source(iter(pool), 4, seed=3)
    got = tip.cached_batch_source(iter(pool), 4, seed=3)
    for _ in range(12):
        w, g = next(want), next(got)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    # a cache directory is written once and reused (no batches needed)
    first = tip.cached_batch_source(
        iter([{k: torch.from_numpy(v) for k, v in b.items()}
              for b in pool]), 3, cache_dir=str(tmp_path), seed=1,
        expect_batch=2, expect_resolution=4)
    a = [next(first)["mask"][0, 0, 0, 0] for _ in range(8)]
    again = tip.cached_batch_source(iter(()), 3, cache_dir=str(tmp_path),
                                    seed=1)
    assert a == [next(again)["mask"][0, 0, 0, 0] for _ in range(8)]
    assert json.load(open(tmp_path / "meta.json"))["n_batches"] == 3
    for kw, msg in ((dict(expect_batch=4), "batch 2"),
                    (dict(expect_resolution=8), "resolution 4")):
        with pytest.raises(ValueError, match=msg):
            next(tip.cached_batch_source(iter(()), 3,
                                         cache_dir=str(tmp_path), **kw))
        with pytest.raises(ValueError, match=msg):
            next(jip.cached_batch_source(iter(()), 3,
                                         cache_dir=str(tmp_path), **kw))


def test_prefetcher_order_errors_and_close():
    assert list(tip.ThreadedPrefetcher(lambda i: i * i, num_batches=6)) == \
        [i * i for i in range(6)]

    def failing(i):
        if i == 3:
            raise KeyError("batch 3")
        return i

    seen = []
    with pytest.raises(KeyError, match="batch 3"):
        for x in tip.ThreadedPrefetcher(failing, depth=1):
            seen.append(x)
    assert seen == [0, 1, 2]
    made = []
    pf = tip.ThreadedPrefetcher(lambda i: made.append(i) or i, depth=2)
    it = iter(pf)
    assert [next(it), next(it)] == [0, 1]
    pf.close()
    assert not pf._thread.is_alive()
    n = len(made)
    time.sleep(0.1)
    assert len(made) == n and n <= 5


def test_input_pipeline_shards_and_collates():
    data = list(range(10))
    pipe = tip.input_pipeline(data, 3, collate=sum, seed=2,
                              process_index=1, process_count=2,
                              num_batches=3)
    idx = tip.host_shard_indices(10, 1, 2, 2)
    want = [sum(idx[(b * 3 + j) % 5] for j in range(3)) for b in range(3)]
    assert list(pipe) == want


def test_rendered_batches_prefetched_are_the_same(tmp_path):
    from unirenderer_tpu_torch.data.objaverse import ObjaverseData
    from unirenderer_tpu_torch.data.synthetic import write_dataset
    from unirenderer_tpu_torch.eval.quality import held_out_paths
    write_dataset(str(tmp_path), n_mesh=3, n_env=1, env_res=16,
                  env_min_res=4, env_samples=8, sphere_res=6, tex_res=16,
                  device="cpu", log=lambda msg: None)
    meshes, envs = held_out_paths(str(tmp_path))
    cfg = tcfg.tiny().data

    def batches(prefetch):
        ds = ObjaverseData(cfg, meshes, envs, seed=1)
        gen = rendered_batches(ds, 2, 8, 1, device="cpu", seed=4,
                               prefetch=prefetch)
        out = [next(gen) for _ in range(3)]
        gen.close()
        return out

    threads = threading.active_count()
    for a, b in zip(batches(0), batches(2)):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert not a["image"].requires_grad
    assert threading.active_count() == threads


def test_anomaly_guard_follows_jax():
    seq = [1.0, float("nan"), float("inf"), 2.0, float("nan"),
           float("nan")]
    for guard in (AnomalyGuard(patience=3), JaxGuard(patience=3)):
        assert [guard.check({"loss": x}, i) for i, x in enumerate(seq)] == \
            [True, False, False, True, False, False]
        assert guard.total == 4
        with pytest.raises(FloatingPointError, match="3 consecutive"):
            guard.check({"loss": torch.tensor(float("nan"))}, 6)


def test_phase_timer_and_metric_logger(tmp_path):
    timer = PhaseTimer("cpu")
    for _ in range(3):
        with timer.phase("a", sync=True):
            pass
    timer.dump(str(tmp_path / "phases.jsonl"))
    rec = json.loads(open(tmp_path / "phases.jsonl").read())
    assert rec["a"]["count"] == 3
    log = MetricLogger(str(tmp_path / "m.jsonl"))
    out = log.log(4, {"loss": torch.tensor(0.5), "name": "x"})
    log.close()
    assert out["loss"] == 0.5 and out["name"] == "x"
    assert json.loads(open(tmp_path / "m.jsonl").read())["step"] == 4


def test_training_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from unirenderer_tpu_torch.train.vae import main as vae_main
    from unirenderer_tpu_torch.train.vae_train import train_vae
    cfg = tcfg.tiny()
    bank = synthetic_bank(cfg.data)
    no_card = dict(expected_exception=RuntimeError, match="no CUDA card")
    with pytest.raises(**no_card):
        Trainer(cfg, str(tmp_path / "t"), scene_bank=bank)
    with pytest.raises(**no_card):
        train_vae(cfg, None, str(tmp_path / "v"), 1, scene_bank=bank)
    with pytest.raises(**no_card):
        vae_main(["--workdir", str(tmp_path / "c"), "--tiny", "--synthetic",
                  "--steps", "1"])


def test_step_comparison_groups_and_settings():
    from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
    from unirenderer_tpu_torch.ops import flash_attention as fa
    from unirenderer_tpu_torch.ops import groupnorm as gn
    from unirenderer_tpu_torch.train import compare
    assert compare.parse_setting("cuda:bfloat16:plain-attention") == (
        "cuda", torch.bfloat16, ("plain-attention",))
    with pytest.raises(ValueError, match="unknown options"):
        compare.parse_setting("cuda:bfloat16:plain-vae")
    with torch.device("meta"):
        params = dict(DualStreamModel(tcfg.tiny().unet).named_parameters())
    groups = compare.param_groups(params)
    spans = sorted(sp for v in groups.values() for sp in v)
    assert len(spans) == len(params) and spans[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == sum(p.numel() for p in params.values())
    assert {"unet/attn", "unet/norm", "unet/other"} <= set(groups)
    g = torch.randn(spans[-1][1], generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    h = g.clone()
    for i, j in groups["unet/attn"]:
        h[i:j] += torch.randn(j - i, dtype=torch.float64)
    cos = compare.group_cosines(h, g, groups)
    assert cos["unet/attn"] < 0.9
    assert all(abs(c - 1) < 1e-12 for k, c in cos.items() if k != "unet/attn")
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def launchers():
        return (gn._launch, fa._launch, fa._launch_backward,
                mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32,
                dnn.enabled, dnn.allow_tf32)

    saved = launchers()
    q, k, v = (torch.randn(1, 128, 2, 8) for _ in range(3))
    with compare.card_variant(("plain-groupnorm", "plain-attention",
                               "exact-sums", "no-cudnn", "no-tf32")):
        assert gn._launch is gn.groupnorm_silu_reference
        assert torch.equal(fa._launch(q, k, v),
                           fa.attention_reference(q, k, v))
        assert not (mm.allow_bf16_reduced_precision_reduction
                    or mm.allow_tf32 or dnn.enabled or dnn.allow_tf32)
    assert launchers() == saved
