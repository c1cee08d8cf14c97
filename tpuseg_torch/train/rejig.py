"""Sparsity-aware re-initialization ("rejig"), counterpart of
``tpuseg/train/rejig.py``.

Behavioral reference: semantic_seg.py:1032-1056 / rmbsnn_main.py:360-385 —
for static masks, re-draw the surviving weights with a sparsity-corrected He
std: ``n = nnz // mask.shape[1]`` in the (OFM, IFM, kh, kw) view, conv
weights ~ N(0, sqrt(2/n)), FC weights ~ N(0, 0.01).  The port's weights are
already in that view (OIHW), so the draws land where ``tpuseg``'s do.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch


def sparsity_aware_reinit(
    params: Mapping[str, torch.Tensor],
    masks: Mapping[str, torch.Tensor],
    rng: np.random.Generator,
) -> dict[str, torch.Tensor]:
    """Return params with every masked layer re-drawn at its surviving
    positions (numpy draws; float32 CPU tensors out, OIHW)."""
    out = dict(params)
    for layer, mask in masks.items():
        tensor = np.asarray(params[layer].detach().cpu(), dtype=np.float32)
        m = np.asarray(mask.detach().cpu()) if isinstance(mask, torch.Tensor) else np.asarray(mask)
        nnz = int(np.count_nonzero(m))
        n = nnz // m.shape[1] if m.shape[1] else nnz
        fresh = np.zeros_like(tensor)
        if tensor.ndim == 2:
            vals = rng.normal(0.0, 0.01, size=nnz)
        else:
            vals = rng.normal(0.0, math.sqrt(2.0 / max(n, 1)), size=nnz)
        fresh[np.nonzero(m)] = vals
        out[layer] = torch.from_numpy(fresh.astype(np.float32))
    return out
