"""Timing meters (counterpart of ``tpuseg/metrics/meters.py``).

Reference: EMA fps counter (plot_pyqt.py:329-339).
"""

from __future__ import annotations

import time


class FpsMeter:
    """Exponential-moving-average fps counter (plot_pyqt.py:329-339)."""

    def __init__(self, alpha_scale: float = 10.0):
        self.last = None
        self.fps = None
        self.alpha_scale = alpha_scale

    def tick(self, now: float | None = None) -> float | None:
        now = time.time() if now is None else now
        if self.last is not None:
            dt = max(now - self.last, 1e-9)
            inst = 1.0 / dt
            if self.fps is None:
                self.fps = inst
            else:
                s = min(self.alpha_scale * dt, 1.0)
                self.fps = self.fps * (1 - s) + inst * s
        self.last = now
        return self.fps
