"""The port's two training CLIs on the CPU at `tiny()`:

  * `python -m unirenderer_tpu_torch.train --tiny --synthetic --steps 3
    --device cpu` trains and checkpoints; a second run with `--steps 5`
    resumes from step 3 (logging its first step, 4) and checkpoints 5;
  * `python -m unirenderer_tpu_torch.train.vae --tiny --synthetic` trains
    3 steps, and a second run resumes to 4;
  * the scene-bank path of the training CLI over a directory of meshes
    and envs, with Adafactor, validation every 2 steps and the frozen VAE
    from the VAE run's checkpoints;
  * the flag exclusions of tools/train.py.
"""

import json
import os
import subprocess
import sys

import pytest

from unirenderer_tpu_torch.core.checkpoint import load_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


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
