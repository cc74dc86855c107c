"""The port's two training CLIs on the CPU at `tiny()`:

  * `python -m unirenderer_tpu_torch.train --tiny --synthetic --steps 3
    --device cpu` trains and checkpoints; a second run with `--steps 5`
    resumes from step 3 (logging its first step, 4) and checkpoints 5;
  * `python -m unirenderer_tpu_torch.train.vae --tiny --synthetic` trains
    3 steps, and a second run resumes to 4;
  * the scene-bank path of the training CLI over a directory of meshes
    and envs, with Adafactor, validation every 2 steps and the frozen VAE
    from the VAE run's checkpoints;
  * the flag exclusions of tools/train.py;
  * the training CLI and `parallel/world_steps.py` under torchrun on 2
    gloo ranks;
  * the training CLI with `--fsdp --optimizer adafactor` under torchrun
    (one gloo process): it checkpoints the Adafactor state and a second
    run resumes from it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from unirenderer_tpu_torch.core.checkpoint import load_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


def run(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_trains_and_resumes(tmp_path):
    args = ("unirenderer_tpu_torch.train", "--workdir", str(tmp_path),
            "--tiny", "--synthetic")
    run(*args, "--steps", "3")
    out = run(*args, "--steps", "5")
    assert "resumed from step 3" in out
    assert [r["step"] for r in records(tmp_path / "metrics.jsonl")] == [1, 4]
    ckpts = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["checkpoint-3", "checkpoint-5"]
    flat, step = load_params_npz(str(ckpts / "checkpoint-5" / "params.npz"))
    assert step == 5 and all(k.startswith("params/") for k in flat)
    assert len(records(tmp_path / "phases.jsonl")) == 2


def test_vae_cli_then_bank_training_with_its_vae(tmp_path):
    vae_dir = tmp_path / "vae"
    args = ("unirenderer_tpu_torch.train.vae", "--workdir", str(vae_dir),
            "--tiny", "--synthetic", "--batch", "2")
    assert "ended at step 3/3 (reached max_steps=3)" in run(*args,
                                                           "--steps", "3")
    out = run(*args, "--steps", "4")
    assert "resumed from step 3" in out
    assert sorted(os.listdir(vae_dir / "vae_checkpoints")) == [
        "checkpoint-3", "checkpoint-4"]
    assert [r["step"] for r in records(vae_dir / "vae_metrics.jsonl")] == [1]

    from unirenderer_tpu_torch.data.synthetic import write_dataset
    data = tmp_path / "data"
    write_dataset(str(data), n_mesh=2, n_env=1, env_res=16, env_min_res=4,
                  env_samples=8, sphere_res=6, tex_res=16, device="cpu",
                  log=lambda msg: None)
    work = tmp_path / "bank"
    out = run("unirenderer_tpu_torch.train", "--workdir", str(work),
              "--tiny", "--mesh-dir", str(data / "meshes"), "--env-dir",
              str(data / "envs"), "--scene-bank", "--optimizer", "adafactor",
              "--validation", "--validation-every", "2", "--steps", "2",
              "--vae-ckpt", str(vae_dir / "vae_checkpoints"))
    assert "scene bank: 2 meshes, 1 envs" in out
    assert "frozen VAE from" in out and "step 4" in out
    recs = records(work / "metrics.jsonl")
    assert recs[0]["step"] == 1 and "loss" in recs[0]
    assert recs[-1]["step"] == 2 and "psnr_normal" in recs[-1]
    assert (work / "validation" / "step-2" / "normal.png").exists()
    assert os.listdir(work / "checkpoints") == ["checkpoint-2"]


@pytest.mark.parametrize("flags", [
    ["--scene-bank", "--synthetic"], ["--render-in-step", "--synthetic"],
    ["--scene-bank", "--render-in-step", "--mesh-dir", "m", "--env-dir",
     "e"], []])
def test_train_cli_flag_exclusions(tmp_path, flags, capsys):
    from unirenderer_tpu_torch.train.__main__ import main
    with pytest.raises(SystemExit) as e:
        main(["--workdir", str(tmp_path), "--tiny", "--device", "cpu"]
             + flags)
    assert e.value.code == 2
    assert "--" in capsys.readouterr().err


def test_train_cli_under_torchrun_two_ranks(tmp_path):
    """`torchrun --nproc_per_node 2 -m unirenderer_tpu_torch.train --fsdp`
    on the CPU (gloo): each rank keeps its own pool of its rows under
    --cache-dir, rank 0 alone logs, validates and checkpoints."""
    work, cache = tmp_path / "run", tmp_path / "cache"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", "unirenderer_tpu_torch.train",
         "--workdir", str(work), "--tiny", "--synthetic", "--fsdp",
         "--steps", "2", "--cache-batches", "2", "--cache-dir", str(cache),
         "--validation", "--validation-every", "2", "--checkpoint-every",
         "2", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(os.listdir(cache)) == ["rank0-of-2", "rank1-of-2"]
    for r in range(2):
        shard = np.load(cache / f"rank{r}-of-2" / "b00000.npz")
        assert shard["image"].shape[0] == 2      # its rows of a batch of 4
    with open(work / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]   # rank 0's step and PSNRs
    assert any(k.startswith("psnr_") for k in recs[1])
    assert sorted(os.listdir(work / "validation")) == ["step-2"]
    assert os.listdir(work / "checkpoints") == ["checkpoint-2"]


def _torchrun(nproc, *args):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(nproc), "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", *args, "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_cli_fsdp_adafactor_under_torchrun_resumes(tmp_path):
    """`torchrun -m unirenderer_tpu_torch.train --fsdp --optimizer
    adafactor` writes a checkpoint with Adafactor's statistics (full
    tensors), and a second run resumes from it."""
    args = ("unirenderer_tpu_torch.train", "--workdir", str(tmp_path),
            "--tiny", "--synthetic", "--fsdp", "--optimizer", "adafactor")
    _torchrun(1, *args, "--steps", "2")
    out = _torchrun(1, *args, "--steps", "3")
    assert "resumed from step 2" in out
    ckpts = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["checkpoint-2", "checkpoint-3"]
    state = torch.load(ckpts / "checkpoint-3" / "state.pt",
                       weights_only=False)
    assert state["step"] == 3
    kinds = {k for s in state["optimizer"]["state"].values() for k in s}
    assert kinds == {"step", "v", "v_row", "v_col"}
    assert all(s["step"] == 3 for s in state["optimizer"]["state"].values())
    assert [r["step"] for r in records(tmp_path / "metrics.jsonl")] == [1, 3]


def test_world_steps_under_torchrun_two_ranks(tmp_path):
    """`parallel/world_steps.py` on 2 gloo ranks at tiny(), f32: DP,
    FSDP, TP and TP+FSDP (1 x 2) each within 1e-5 of one process's loss
    and of DP's gradient norm (the script's own gate, for bf16 on the
    card, is 1e-3), its JSON written by rank 0."""
    out_json = tmp_path / "world2.json"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", "unirenderer_tpu_torch.parallel.world_steps",
         "--config", "tiny", "--device", "cpu", "--warm", "0", "--out",
         str(out_json)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(out_json) as f:
        res = json.load(f)
    assert res["ok"] and res["world"] == 2 and res["global_batch"] == 4
    assert set(res["variants"]) == {"dp", "fsdp", "tp", "tp_fsdp"}
    assert res["variants"]["tp"]["tp_linears"] > 0
    for v in res["variants"].values():
        assert v["loss_rel_vs_one_process"] <= 1e-5, v
        assert v["grad_norm_rel_vs_dp"] <= 1e-5, v


def test_world_steps_adafactor_under_torchrun_two_ranks(tmp_path):
    """`parallel/world_steps.py --optimizer adafactor` on 2 gloo ranks at
    tiny(), f32: every variant within 1e-5 of one process's loss and of
    DP's gradient norm, and warm steps taken through the sharded
    Adafactor."""
    out_json = tmp_path / "world2.json"
    _torchrun(2, "unirenderer_tpu_torch.parallel.world_steps", "--config",
              "tiny", "--warm", "1", "--optimizer", "adafactor", "--out",
              str(out_json))
    with open(out_json) as f:
        res = json.load(f)
    assert res["ok"] and res["optimizer"] == "adafactor"
    assert set(res["variants"]) == {"dp", "fsdp", "tp", "tp_fsdp"}
    for v in res["variants"].values():
        assert v["loss_rel_vs_one_process"] <= 1e-5, v
        assert v["grad_norm_rel_vs_dp"] <= 1e-5, v
        assert len(v["steps"]) == 4 and all(
            np.isfinite(s["loss"]) for s in v["steps"])
