"""Per-block activation capture and diffing (counterpart of
`unirenderer_tpu/models/introspect.py`): weight-port fidelity debugging,
where a GroupNorm-eps or head-layout mismatch shows as activation drift
long before it shows in samples.

    acts = capture_activations(model, *inputs)
    rows = diff_activations(acts_a, acts_b)     # max |delta| per scope

Captures are keyed as flax's `capture_intermediates` keys them: the
module path joined with `/`, then `__call__`; a module called more than
once gets `/0`, `/1`, ... per call, and a tuple output `/0`, `/1`, ...
per element (as the JAX `capture_activations` flattens them).  Values
are float32 numpy arrays in the JAX layout (activations are NHWC
throughout the port), so a capture of the port and one of the JAX
package on the same weights diff directly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(out, path: Tuple[str, ...], flat: Dict[str, Any]) -> None:
    if isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            _flatten(v, path + (str(i),) if len(out) > 1 else path, flat)
    elif isinstance(out, torch.Tensor):
        flat["/".join(path)] = out.detach().float().cpu().numpy()
    else:
        flat["/".join(path)] = out


def capture_activations(module: nn.Module, *args, **kwargs
                        ) -> Dict[str, Any]:
    """Run `module(*args, **kwargs)` with a forward hook on every
    submodule (the module itself included) -> {scope path: output}."""
    calls: Dict[str, List[Any]] = {}
    handles = []
    for name, mod in module.named_modules():
        def hook(_mod, _inp, out, name=name):
            calls.setdefault(name, []).append(out)
        handles.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    flat: Dict[str, Any] = {}
    for name, outs in calls.items():
        path = (tuple(name.split(".")) if name else ()) + ("__call__",)
        _flatten(tuple(outs), path, flat)
    return flat


def _leaf_arrays(x) -> list:
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _leaf_arrays(v)]
    if isinstance(x, dict):
        return [a for k in sorted(x) for a in _leaf_arrays(x[k])]
    return [x] if hasattr(x, "shape") else []


def diff_activations(a: Dict[str, Any], b: Dict[str, Any],
                     top_k: int = 20) -> List[Tuple[str, float, float]]:
    """(scope#leaf, max |a - b|, that over max |a|) for every scope both
    captures hold, worst first -> the first `top_k` rows."""
    rows = []
    for key in sorted(set(a) & set(b)):
        la, lb = _leaf_arrays(a[key]), _leaf_arrays(b[key])
        for i, (xa, xb) in enumerate(zip(la, lb)):
            if xa.shape != xb.shape:
                rows.append((key + f"#{i}", float("inf"), float("inf")))
                continue
            xa = np.asarray(xa, np.float32)
            xb = np.asarray(xb, np.float32)
            d = np.abs(xa - xb)
            rel = d.max() / max(np.abs(xa).max(), 1e-8)
            rows.append((key + f"#{i}", float(d.max()), float(rel)))
    rows.sort(key=lambda r: -r[1])
    return rows[:top_k]


def assert_activations_close(a: Dict[str, Any], b: Dict[str, Any],
                             atol: float = 1e-4) -> None:
    """Raise AssertionError naming the (at most 5) worst scopes whose max
    |a - b| passes `atol`."""
    rows = diff_activations(a, b, top_k=5)
    bad = [r for r in rows if r[1] > atol]
    if bad:
        msg = "\n".join(f"  {k}: max|d|={d:.3e} rel={r:.3e}"
                        for k, d, r in bad)
        raise AssertionError(f"activation drift above {atol}:\n{msg}")
