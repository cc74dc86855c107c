#!/usr/bin/env python
"""Export the text encoder the held-out harness scores with.

The trained r05 weights (`artifacts/r05/dual_small.npz`) carry no CLIP
text encoder.  `tools/eval_quality.py` therefore scores with the random
one that `UniRendererPipeline.create(small(), jax.random.key(0),
jnp.float32)` draws (the third key of `split(key(0), 3)`), and its
blank-prompt context shapes every render.  This script writes exactly
those text parameters, in f32, in the flat `/`-joined layout of
`core/checkpoint.save_params_npz`, so that the PyTorch port's harness
(`unirenderer_tpu_torch/eval/quality.py`) loads the same encoder:

    python tools/export_text_params_r05.py [--out artifacts/r05/text_small.npz]

JAX runs on the CPU only (~10 s; the file is ~4.8 MB).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="artifacts/r05/text_small.npz")
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from unirenderer_tpu.core import config
    from unirenderer_tpu.core.checkpoint import save_params_npz
    from unirenderer_tpu.pipelines import UniRendererPipeline

    pipe = UniRendererPipeline.create(config.small(), jax.random.key(0),
                                      jnp.float32)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_params_npz(args.out, jax.device_get(pipe.text_params),
                    dtype="float32")
    n = len(jax.tree.leaves(pipe.text_params))
    print(f"wrote {args.out}: {n} arrays, "
          f"{os.path.getsize(args.out) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
