"""Cityscapes segmentation dataset lists and palettes (counterpart of
``tpuseg/data/cityscapes.py``).

Behavioral reference: the reference's cityscapes_dataset.py — ``SegList``
reads ``{phase}_images.txt`` / ``{phase}_labels.txt`` under ``list_dir``
(:80-89); ``SegListMS`` adds bicubic multi-scale copies (:92-129).  The
19-class palette + void and the triplet palette are the constants every
reference entry script duplicates (semantic_seg.py:52-78), byte-identical
to ``tpuseg``'s.  PIL is imported where an image is opened.
"""

from __future__ import annotations

import json
import os
from os.path import join

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

TRIPLET_PALETTE = np.asarray(
    [
        [0, 0, 0, 255],
        [217, 83, 79, 255],
        [91, 192, 222, 255],
    ],
    dtype=np.uint8,
)


def load_info(data_dir: str) -> dict:
    """Normalization stats (info.json: mean/std in [0,1])."""
    with open(join(data_dir, "info.json")) as fh:
        return json.load(fh)


class SegList:
    """List-file-driven segmentation dataset.

    ``__getitem__`` returns the transformed tuple; in test phase the image
    file name is appended (cityscapes_dataset.py:60-69).
    """

    def __init__(self, data_dir, phase, transforms, list_dir=None, out_name=False):
        self.list_dir = list_dir or data_dir
        self.data_dir = data_dir
        self.phase = phase
        self.transforms = transforms
        self.out_name = out_name or phase == "test"
        self.image_list = self._read_list(f"{phase}_images.txt")
        label_path = join(self.list_dir, f"{phase}_labels.txt")
        self.label_list = (
            self._read_list(f"{phase}_labels.txt") if os.path.exists(label_path) else None
        )
        if self.label_list is not None:
            assert len(self.image_list) == len(self.label_list)

    def _read_list(self, name):
        with open(join(self.list_dir, name)) as fh:
            return [line.strip() for line in fh if line.strip()]

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, index):
        from PIL import Image

        data = [Image.open(join(self.data_dir, self.image_list[index]))]
        if self.label_list is not None:
            data.append(Image.open(join(self.data_dir, self.label_list[index])))
        else:
            data.append(None)
        out = list(self.transforms(*data))
        if out[-1] is None:
            out = out[:-1]
        if self.out_name:
            out.append(self.image_list[index])
        return tuple(out)


class SegListMS(SegList):
    """Multi-scale variant: adds bicubic copies at each scale for test_ms
    (cityscapes_dataset.py:92-129)."""

    def __init__(self, data_dir, phase, transforms, scales, list_dir=None):
        super().__init__(data_dir, phase, transforms, list_dir, out_name=True)
        self.scales = scales

    def __getitem__(self, index):
        from PIL import Image

        img = Image.open(join(self.data_dir, self.image_list[index]))
        w, h = img.size
        data = [img]
        if self.label_list is not None:
            data.append(Image.open(join(self.data_dir, self.label_list[index])))
        else:
            data.append(None)
        out = list(self.transforms(*data))
        if out[-1] is None:
            out = out[:-1]
        ms_images = [
            self.transforms(img.resize((round(w * s), round(h * s)), Image.BICUBIC))[0]
            for s in self.scales
        ]
        out.append(self.image_list[index])
        out.append(ms_images)
        return tuple(out)


def colorize(pred: np.ndarray, palette: np.ndarray = CITYSCAPE_PALETTE) -> np.ndarray:
    """Class-id map -> RGB (the ``palettes[pred]`` gather every demo does)."""
    return palette[pred]
