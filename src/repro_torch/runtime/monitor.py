"""Straggler detection: per-step wall-time EWMA with a flag threshold.

The trainer records each step's wall time (its loss synchronized); a step
slower than ``factor`` times the EWMA of the steps before it is flagged and
left out of the EWMA.
"""
from __future__ import annotations

from typing import List


class StepMonitor:
    def __init__(self, factor: float = 3.0, alpha: float = 0.1,
                 warmup: int = 3):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ewma = 0.0
        self.count = 0
        self.flagged: List[int] = []

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            # prime the EWMA; never flag during warmup (first-call steps)
            self.ewma = dt if self.ewma == 0.0 else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
            return False
        is_slow = dt > self.factor * self.ewma
        if is_slow:
            self.flagged.append(self.count)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_slow
