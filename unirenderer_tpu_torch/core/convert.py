"""Flax parameters <-> the port's state dicts.

The port's modules carry the flax module names, so a flax path maps to a
state-dict key by joining with `.` and renaming the leaf:

    conv kernel  (kh, kw, I, O) -> weight (O, I, kh, kw)
    dense kernel (I, O)         -> weight (O, I)
    GroupNorm / LayerNorm scale -> weight
    Embed embedding             -> weight

(the inverse of the layout rules in `unirenderer_tpu/models/surgery.py`).
Loading is strict: every parameter of the module is filled and every key
of the file is used; nothing is skipped.  `flax_from_module` is the other
direction (a trained module -> flax params for the JAX package).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _strip_collection(key: str) -> str:
    return key[len("params/"):] if key.startswith("params/") else key


def state_dict_from_flax(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """{flax path joined with '/': array} -> {state-dict key: tensor}.
    A leading `params/` collection name is dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        *mods, leaf = _strip_collection(key).split("/")
        a = np.asarray(arr)
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{key}: kernel of rank {a.ndim}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return out


def load_flax(module: nn.Module, flat: Mapping[str, np.ndarray]) -> int:
    """Fill `module` from flax params, strictly (shapes and key sets must
    match).  Returns the number of tensors loaded: every key of `flat`."""
    sd = state_dict_from_flax(flat)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    if missing or unused:
        raise KeyError(f"flax -> torch key mismatch: {len(missing)} missing "
                       f"{missing[:5]}, {len(unused)} unused {unused[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
    return len(sd)


def _flax_leaf(mod: nn.Module, name: str, t: torch.Tensor):
    """(flax leaf name, array in the flax layout) of one parameter: a
    copy, never a view of the tensor's memory (an f32 tensor on the CPU
    would otherwise share it, and an update in place would change it)."""
    a = t.detach().to("cpu", torch.float32, copy=True).numpy()
    if name != "weight":
        return name, a
    if isinstance(mod, nn.Embedding):
        return "embedding", a
    if a.ndim == 4:
        return "kernel", a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return "kernel", a.T
    if a.ndim == 1:                     # GroupNorm / LayerNorm scale
        return "scale", a
    raise ValueError(f"{type(mod).__name__}.weight of rank {a.ndim}")


def flax_from_module(module: nn.Module,
                     tensors: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, np.ndarray]:
    """The module's parameters as {flax path joined with '/': f32 array},
    under `params` (the inverse of `state_dict_from_flax`); with
    `tensors` ({parameter name: tensor}) their values in place of the
    module's own."""
    out: Dict[str, np.ndarray] = {}
    for mod_name, mod in module.named_modules():
        for name, t in mod.named_parameters(recurse=False):
            if tensors is not None:
                t = tensors[f"{mod_name}.{name}" if mod_name else name]
            leaf, a = _flax_leaf(mod, name, t)
            path = ["params"] + (mod_name.split(".") if mod_name else [])
            out["/".join(path + [leaf])] = np.ascontiguousarray(a)
    return out


def flax_permutations(module: nn.Module) -> Dict[str, Optional[Tuple[int, ...]]]:
    """{parameter name: the permutation of its dimensions that gives its
    flax layout (`t.permute(perm)`), or None where the layouts agree}:
    conv weights (O, I, kh, kw) -> (kh, kw, I, O), linear weights
    (O, I) -> (I, O); embeddings, norm scales and biases keep theirs."""
    out: Dict[str, Optional[Tuple[int, ...]]] = {}
    for mod_name, mod in module.named_modules():
        for name, t in mod.named_parameters(recurse=False):
            perm = None
            if name == "weight" and not isinstance(mod, nn.Embedding):
                perm = {4: (2, 3, 1, 0), 2: (1, 0)}.get(t.dim())
            out[f"{mod_name}.{name}" if mod_name else name] = perm
    return out
