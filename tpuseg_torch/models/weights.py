"""Weight layout conversion between ``tpuseg`` and the port.

Both packages keep a flat ``{torch-style name: array}`` dict with identical
names (so ``optimal_configs/*.json`` keys apply to either).  The only
difference is the conv layout: ``tpuseg`` stores 4-D conv weights HWIO, the
port OIHW.  Every other array (biases, BN parameters and statistics, the
2-D upsample kernel, Linear weights in torch ``(out, in)`` layout) is the
same in both.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def from_jax_params(
    params_np: Mapping, state_np: Mapping | None = None
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """``tpuseg`` numpy params/state -> the port's CPU float tensors
    (4-D conv weights HWIO -> OIHW, everything else as is)."""
    params = {}
    for k, v in params_np.items():
        a = np.asarray(v)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        params[k] = torch.from_numpy(np.ascontiguousarray(a))
    state = {
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        for k, v in (state_np or {}).items()
    }
    return params, state


def to_jax_params(
    params: Mapping, state: Mapping | None = None
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Inverse of ``from_jax_params``: port tensors -> ``tpuseg`` numpy
    arrays (4-D conv weights OIHW -> HWIO)."""
    params_np = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        params_np[k] = np.ascontiguousarray(a)
    state_np = {k: v.detach().cpu().numpy() for k, v in (state or {}).items()}
    return params_np, state_np


def oihw_to_hwio_np(a) -> np.ndarray:
    """One OIHW weight or mask (tensor or array) -> float32 HWIO numpy,
    ``tpuseg``'s layout, in which the sparse planners run its numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().float().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32).transpose(2, 3, 1, 0))


def hwio_to_oihw_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """HWIO numpy -> contiguous OIHW tensor in ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1))).to(dtype)
