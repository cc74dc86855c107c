"""Numerical-anomaly detection (counterpart of
`unirenderer_tpu/core/debug.py`): `checkify_finite`, which finds the
first operation inside a function that makes a NaN or an Inf, and
`AnomalyGuard`, the training loops' cheap guard on the logged loss."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _FiniteCheck(TorchDispatchMode):
    """Runs every aten operation and raises FloatingPointError at the
    first whose floating output holds a NaN or an Inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (
                    t.is_floating_point() or t.is_complex()) and \
                    not bool(torch.isfinite(t).all()):
                kind = "NaN" if bool(torch.isnan(t).any()) else "Inf"
                raise FloatingPointError(
                    f"{func} made a {kind} (output of shape "
                    f"{tuple(t.shape)}, {t.dtype})")
        return out


def checkify_finite(fn: Callable) -> Callable:
    """fn' that raises FloatingPointError, naming the operation, on a NaN
    or an Inf made anywhere inside fn, not only in its outputs (JAX's
    `checkify` with `float_checks`).  Every operation's outputs are read
    back to the host: debug use only."""

    def wrapper(*args, **kwargs):
        with _FiniteCheck():
            return fn(*args, **kwargs)

    return wrapper


class AnomalyGuard:
    """Streaming non-finite-loss detector with a budget of consecutive
    failures: `check` returns False on a non-finite loss and raises
    FloatingPointError at the `patience`-th in a row."""

    def __init__(self, patience: int = 3):
        self.patience = patience
        self.consecutive = 0
        self.total = 0

    def check(self, metrics: Dict[str, Any], step: int) -> bool:
        loss = float(metrics.get("loss", 0.0))
        if math.isfinite(loss):
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.total += 1
        if self.consecutive >= self.patience:
            raise FloatingPointError(
                f"non-finite loss for {self.consecutive} consecutive steps "
                f"(step {step}); aborting training")
        return False
