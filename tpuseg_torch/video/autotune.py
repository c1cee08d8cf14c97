"""Temporal-serving tuning helpers (counterpart of ``tpuseg/video/autotune.py``).

Only ``drift_threshold`` is ported: ``bench.py``'s budgeted mode sets its
threshold with it.  The agreement-targeted autotuner (``autotune_budget``,
its ladder) waits for the rest of temporal serving (ROADMAP A19).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def drift_threshold(frames: Sequence[np.ndarray]) -> tuple[float, float]:
    """Drift scale of THIS content: host-side mean |delta| between
    consecutive frames (the 0..255 pixel-delta units of the device scan) ->
    (threshold between the sensor-noise floor and the motion signal, mean
    |delta|).  ``tpuseg``'s numpy, so both values are bit-equal."""
    deltas = np.stack(
        [
            np.abs(
                frames[i + 1].astype(np.int16) - frames[i].astype(np.int16)
            ).mean()
            for i in range(len(frames) - 1)
        ]
    )
    thresh = float(
        np.percentile(deltas, 25) * 0.5 + np.percentile(deltas, 75) * 0.5
    )
    return thresh, float(deltas.mean())
