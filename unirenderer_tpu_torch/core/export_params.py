"""Export portable params-only weights from a checkpoint directory of the
port (counterpart of `tools/export_params.py`): the newest readable
`checkpoint-<step>/params.npz` under --ckpt (`core/checkpoint.
CheckpointManager`, the layout `python -m unirenderer_tpu_torch.train`
and `.train.vae` write) -> one compressed npz in the JAX writer's format,
float leaves as --dtype, the step under `__step__`.  Both packages'
`load_params_npz` read it, `python -m unirenderer_tpu_torch.eval.quality
--ckpt` / `--vae-ckpt` and the train CLIs' `--init-params` /
`--vae-ckpt` take it.

    python -m unirenderer_tpu_torch.core.export_params \\
        --ckpt runs/exp1/checkpoints --out dual.npz [--dtype float16]

A directory with no readable checkpoint exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys

from unirenderer_tpu_torch.core.checkpoint import (
    CheckpointManager, save_params_npz,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unirenderer_tpu_torch.core.export_params",
        description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory (CheckpointManager layout)")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--dtype", default="float16",
                    choices=("float16", "float32"))
    args = ap.parse_args(argv)

    if not os.path.isdir(args.ckpt):
        raise SystemExit(f"FATAL: no checkpoint directory {args.ckpt}")
    cm = CheckpointManager(args.ckpt)
    params = cm.restore_params()
    if params is None:
        raise SystemExit(f"FATAL: no restorable checkpoint under {args.ckpt}")
    step = cm.restored_step()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_params_npz(args.out, params, step=step, dtype=args.dtype)
    size = os.path.getsize(args.out) / 1e6
    print(f"exported step {step} -> {args.out} ({size:.0f} MB, "
          f"{args.dtype})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
