"""Segmentation / classification metrics (counterpart of the numpy half of
``tpuseg/metrics/seg.py``).

Bit-compatible with the reference definitions:
- ``fast_hist`` / ``per_class_iu``: semantic_seg.py:293-300 (np.bincount
  confusion matrix; labels outside [0, n) are ignored — this is how the
  255 ignore-index is dropped from mIoU)
- pixel accuracy ignoring 255: utils.py:267-277
- top-k accuracy: rmbsnn_main.py:641-655
"""

from __future__ import annotations

import numpy as np


def fast_hist(pred: np.ndarray, label: np.ndarray, n: int) -> np.ndarray:
    """Confusion matrix via bincount (numpy host path)."""
    k = (label >= 0) & (label < n)
    return np.bincount(
        n * label[k].astype(int) + pred[k], minlength=n**2
    ).reshape(n, n)


def per_class_iu(hist: np.ndarray) -> np.ndarray:
    hist = np.asarray(hist, dtype=np.float64)
    return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


def miou_from_hist(hist) -> float:
    ious = per_class_iu(np.asarray(hist))
    return float(np.nanmean(ious) * 100)


def pixel_accuracy(pred, label, ignore: int = 255) -> float:
    """Pixel accuracy over non-ignored labels (utils.py:267-277)."""
    pred = np.asarray(pred)
    label = np.asarray(label)
    valid = label != ignore
    correct = (pred == label) & valid
    total = valid.sum()
    return float(correct.sum()) / float(total) * 100.0 if total else 0.0


def top_k_accuracy(logits, labels, topk=(1,)) -> list[float]:
    """Top-k accuracy in percent (rmbsnn_main.py:641-655)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels).reshape(-1)
    maxk = max(topk)
    order = np.argsort(-logits, axis=-1)[:, :maxk]
    correct = order == labels[:, None]
    res = []
    for k in topk:
        res.append(float(correct[:, :k].any(axis=1).mean()) * 100.0)
    return res
