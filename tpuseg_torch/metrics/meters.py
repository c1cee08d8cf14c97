"""Timing / averaging meters (counterpart of ``tpuseg/metrics/meters.py``).

Reference: AverageMeter (utils.py:249-264), EMA fps counter
(plot_pyqt.py:329-339).
"""

from __future__ import annotations

import time


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    """One tab-separated line of batch counter and meters
    (``ProgressMeter`` of the stock ImageNet example)."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.batch_fmtstr = self._fmtstr(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))

    @staticmethod
    def _fmtstr(num_batches: int) -> str:
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


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
