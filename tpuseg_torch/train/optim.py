"""Optimizer + LR schedules (counterpart of ``tpuseg/train/optim.py``).

Mirrors the reference training recipe: SGD(momentum=0.9, weight_decay=1e-4)
with MultiStepLR (semantic_seg.py:963-966,1002; milestone tables at
semantic_seg.py:852-874 and resume-relative at :992-1000), plus the
ImageNet step decay of rmbsnn_main.adjust_learning_rate (:600-639).

``make_sgd`` is ``tpuseg``'s optax chain on tensors: weight decay is added
to the gradient *before* the momentum trace, and the update is
``-lr(count) * trace`` with ``count`` the number of updates made before
this one (0 on the first step, as ``optax.scale_by_schedule`` passes it).
Its state mirrors the chain's, one dict per link in the chain's order (the
decay link holds nothing, the trace link ``{"trace": {name: tensor}}``, a
schedule link ``{"count": int32 tensor}``), so a checkpoint keys it as
``tpuseg`` does.  Schedules compute in float32, as optax's do.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]

# epochs -> milestones (semantic_seg.py:852-874)
_MILESTONE_TABLE = {
    400: [60, 120, 180, 240, 300, 350],
    500: [60, 120, 180, 240, 300, 350, 400, 450],
    250: [50, 100, 150, 200],
    300: [50, 100, 150, 200, 250],
    200: [40, 80, 120, 160],
    150: [40, 80, 120],
}


def milestones_for_epochs(epochs: int, start_epoch: int = 0) -> list[int]:
    # resume-relative milestones apply ONLY for the 100/150-epoch recipes
    # (semantic_seg.py:992-1000); other epoch counts keep their table.
    if start_epoch and epochs == 100:
        return [start_epoch + 25, start_epoch + 50, start_epoch + 75]
    if start_epoch and epochs == 150:
        return [start_epoch + 40, start_epoch + 80, start_epoch + 120]
    if epochs in _MILESTONE_TABLE:
        return _MILESTONE_TABLE[epochs]
    # generic 1/2, 3/4 fallback (rmbsnn_main.py:606-608)
    return [epochs // 2, (3 * epochs) // 4]


def multistep_schedule(
    base_lr: float, milestones: list[int], gamma: float, steps_per_epoch: int
) -> Schedule:
    """MultiStepLR in terms of optimizer steps: ``optax``'s piecewise
    constant schedule (a milestone repeated counts once)."""
    boundaries = {m * steps_per_epoch: gamma for m in milestones}

    def sched(count: int) -> float:
        v = np.float32(base_lr)
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                v = np.float32(scale) * v
        return float(v)

    return sched


def poly_schedule(base_lr: float, total_steps: int, power: float = 0.9) -> Schedule:
    """Polynomial decay ``lr * (1 - step/total)^power`` — the `--lr-mode poly`
    recipe of the upstream DRN trainer (the reference parses the flag at
    semantic_seg.py:696 but, like its upstream, defaults to step; we honor
    both choices)."""

    def sched(count: int) -> float:
        frac = np.float32(1.0) - np.float32(min(count, total_steps)) / np.float32(total_steps)
        return float(np.float32(base_lr) * frac ** np.float32(power))

    return sched


def step30_schedule(base_lr: float, steps_per_epoch: int) -> Schedule:
    """lr * 0.1^(epoch//30) — the ImageNet-100-epoch rule
    (rmbsnn_main.py:603-604)."""

    def sched(count: int) -> float:
        epoch = count // steps_per_epoch
        return float(np.float32(base_lr) * np.float32(0.1) ** np.float32(epoch // 30))

    return sched


class Sgd:
    """torch.optim.SGD's arithmetic as ``tpuseg``'s optax chain
    (``add_decayed_weights`` -> ``trace`` -> ``scale_by_learning_rate``),
    on flat ``{name: tensor}`` dicts.  ``init``/``update`` are functional:
    they return new tensors and leave their arguments as they are."""

    def __init__(self, schedule_or_lr, momentum: float = 0.9, weight_decay: float = 1e-4):
        self.lr = schedule_or_lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.links = ((("decay",) if weight_decay else ()) + (("trace",) if momentum else ())
                      + ("scale",))

    def init(self, params: dict) -> tuple:
        state = []
        for link in self.links:
            if link == "trace":
                state.append({"trace": {k: torch.zeros_like(v) for k, v in params.items()}})
            elif link == "scale" and callable(self.lr):
                state.append({"count": torch.zeros((), dtype=torch.int32)})
            else:
                state.append({})
        return tuple(state)

    def update(self, grads: dict, state: tuple, params: dict) -> tuple[dict, tuple]:
        """``(updates, new_state)`` for ``grads`` at ``params``."""
        new_state = []
        for link, part in zip(self.links, state):
            if link == "decay":
                grads = {k: g + self.weight_decay * params[k] for k, g in grads.items()}
                new_state.append(part)
            elif link == "trace":
                grads = {k: g + self.momentum * part["trace"][k] for k, g in grads.items()}
                new_state.append({"trace": grads})
            elif callable(self.lr):
                count = int(part["count"])
                step = -self.lr(count)
                grads = {k: step * g for k, g in grads.items()}
                new_state.append({"count": torch.tensor(count + 1, dtype=torch.int32)})
            else:
                grads = {k: -self.lr * g for k, g in grads.items()}
                new_state.append(part)
        return grads, tuple(new_state)


def make_sgd(schedule_or_lr, momentum: float = 0.9, weight_decay: float = 1e-4) -> Sgd:
    """torch.optim.SGD-equivalent transformation chain."""
    return Sgd(schedule_or_lr, momentum, weight_decay)
