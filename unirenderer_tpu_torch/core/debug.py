"""Non-finite loss detection for the training loops (counterpart of
`unirenderer_tpu/core/debug.py` `AnomalyGuard`)."""

from __future__ import annotations

import math
from typing import Any, Dict


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
