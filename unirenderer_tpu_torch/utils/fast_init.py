"""Structure-only parameter construction (counterpart of
`unirenderer_tpu/utils/fast_init.py` `shape_init`).

The module is built on the meta device (shapes only, no init compute),
moved to the target device uninitialised (`to_empty`), and every
parameter is filled from one `np.random.default_rng(seed)` walked in the
leaf order of the module's flax parameter tree, exactly as the JAX
`shape_init` fills that tree: `normal` is N(0, 1), `scaled_normal`
divides it by sqrt(prod(flax shape[:-1])) for tensors of rank >= 2, and
`cast` is applied on the host before the copy to the device.  A port
module and a JAX tree filled from the same seed therefore hold the same
numbers (`core/convert.flax_permutations` gives each tensor's flax
layout).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from unirenderer_tpu_torch.core.convert import flax_permutations
from unirenderer_tpu_torch.utils.runtime import resolve_device

FILLS = ("scaled_normal", "normal", "zeros")


def _flax_leaf_order(module: nn.Module):
    """[(parameter name, flax path tuple, permutation or None)] in the
    order `jax.tree.leaves` walks the module's flax parameter tree (its
    dict keys sorted at every level)."""
    perms = flax_permutations(module)
    mods = dict(module.named_modules())
    rows = []
    for name, perm in perms.items():
        owner, _, leaf = name.rpartition(".")
        if leaf == "weight":
            mod = mods[owner]
            leaf = ("embedding" if isinstance(mod, nn.Embedding)
                    else "kernel" if perm is not None else "scale")
        path = tuple(owner.split(".")) + (leaf,) if owner else (leaf,)
        rows.append((name, path, perm))
    rows.sort(key=lambda r: r[1])
    return rows


def shape_init(module_fn: Callable[[], nn.Module], fill: str = "scaled_normal",
               seed: int = 0, device=None, cast: Optional[torch.dtype] = None
               ) -> nn.Module:
    """`module_fn()` built on the meta device and materialised on `device`
    (default the card; asking for it without one raises) with its
    parameters filled as described above; `cast`: the floating type the
    module is built in (each value is rounded on the host)."""
    if fill not in FILLS:
        raise ValueError(f"fill {fill!r}: one of {', '.join(FILLS)}")
    with torch.device("meta"):
        module = module_fn()
    if cast is not None:
        module.to(dtype=cast)
    module.to_empty(device=resolve_device(device or "cuda"))
    if fill == "zeros":             # the same values, made on the device
        with torch.no_grad():
            for p in module.parameters():
                p.zero_()
        return module
    rng = np.random.default_rng(seed)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, _, perm in _flax_leaf_order(module):
            p = params[name]
            shape = tuple(p.shape) if perm is None else tuple(
                p.shape[d] for d in perm)          # the flax layout
            a = rng.standard_normal(shape).astype(np.float32)
            if fill == "scaled_normal" and a.ndim >= 2:
                a = a / np.sqrt(max(int(np.prod(shape[:-1])), 1))
            a = a.astype(np.float32)               # the flax leaf's type
            t = torch.from_numpy(np.ascontiguousarray(a))
            if perm is not None:                   # back to torch's layout
                t = t.permute(tuple(np.argsort(perm)))
            p.copy_(t.to(p.dtype))
    return module
