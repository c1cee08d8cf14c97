"""Unstructured magnitude pruning (counterpart of
``tpuseg/train/unstructured.py``).

Behavioral reference: semseg_unstructured.py:769-777 — per-conv-layer L1
(magnitude) unstructured pruning at a global sparsity fraction, equivalent to
``torch.nn.utils.prune.l1_unstructured(module, 'weight', amount=sparsity)``:
zero the ``floor(sparsity * size)`` smallest-|w| entries of each layer.
Also covers semseg_baseline.py:752's ``random_unstructured`` mode.

The masks are drawn on the HWIO view of each weight (``tpuseg``'s storage
order, which fixes what a random draw of flat indices picks) and returned
as OIHW float32 tensors.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from tpuseg_torch.models.weights import hwio_to_oihw_tensor, oihw_to_hwio_np


def _conv_layers(params, layers):
    if layers is None:
        layers = [k for k, v in params.items() if v.dim() == 4 and k != "up.weight"]
    return layers


def magnitude_unstructured_masks(
    params: Mapping[str, torch.Tensor],
    sparsity: float,
    layers: Iterable[str] | None = None,
) -> dict[str, torch.Tensor]:
    """L1-unstructured masks for conv layers.

    ``layers=None`` targets every 4-D weight except the frozen upsampler —
    matching the reference's "every Conv2d module" sweep.
    """
    masks = {}
    for k in _conv_layers(params, layers):
        w = oihw_to_hwio_np(params[k])
        n_prune = int(sparsity * w.size)
        mask = np.ones(w.size, dtype=np.float32)
        if n_prune > 0:
            idx = np.argpartition(np.abs(w).ravel(), n_prune - 1)[:n_prune]
            mask[idx] = 0.0
        masks[k] = hwio_to_oihw_tensor(mask.reshape(w.shape), torch.float32)
    return masks


def random_unstructured_masks(
    params: Mapping[str, torch.Tensor],
    sparsity: float,
    rng: np.random.Generator,
    layers: Iterable[str] | None = None,
) -> dict[str, torch.Tensor]:
    masks = {}
    for k in _conv_layers(params, layers):
        w = oihw_to_hwio_np(params[k])
        n_prune = int(sparsity * w.size)
        mask = np.ones(w.size, dtype=np.float32)
        if n_prune > 0:
            mask[rng.choice(w.size, n_prune, replace=False)] = 0.0
        masks[k] = hwio_to_oihw_tensor(mask.reshape(w.shape), torch.float32)
    return masks


def measure_global_sparsity(
    params: Mapping[str, torch.Tensor], masks: Mapping[str, torch.Tensor] | None = None
) -> tuple[int, int, float]:
    """(num_zeros, num_elements, sparsity) over conv weights
    (semseg_unstructured.py:108-136)."""
    zeros = 0
    total = 0
    for k, v in params.items():
        if v.dim() != 4 or k == "up.weight":
            continue
        if masks and k in masks:
            v = v * masks[k].to(v.device, v.dtype)
        zeros += int(v.numel() - torch.count_nonzero(v))
        total += v.numel()
    return zeros, total, zeros / total if total else 0.0
