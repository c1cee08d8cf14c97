"""Cityscapes palette (counterpart of ``tpuseg/data/cityscapes.py``).

The 19-class palette + void that every reference entry script duplicates
(semantic_seg.py:52-78), byte-identical to ``tpuseg``'s.
"""

from __future__ import annotations

import numpy as np

CITYSCAPE_PALETTE = np.asarray(
    [
        [128, 64, 128],
        [244, 35, 232],
        [70, 70, 70],
        [102, 102, 156],
        [190, 153, 153],
        [153, 153, 153],
        [250, 170, 30],
        [220, 220, 0],
        [107, 142, 35],
        [152, 251, 152],
        [70, 130, 180],
        [220, 20, 60],
        [255, 0, 0],
        [0, 0, 142],
        [0, 0, 70],
        [0, 60, 100],
        [0, 80, 100],
        [0, 0, 230],
        [119, 11, 32],
        [0, 0, 0],
    ],
    dtype=np.uint8,
)
