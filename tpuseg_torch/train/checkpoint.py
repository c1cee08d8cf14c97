"""Checkpoint save/resume (counterpart of ``tpuseg/train/checkpoint.py``).

Same contract as the reference (save_checkpoint envelope with epoch / arch /
state / best metric / optimizer, semantic_seg.py:286-290, resume at
:973-990), with the masks checkpointed for a deterministic resume.

Format: ``tpuseg``'s single .npz, key for key: ``params/<name>``,
``bn_state/<name>``, ``masks/<name>``, ``opt/<link>/.trace/<name>`` and
``opt/<link>/.count`` (the optax chain's paths; ``train.optim.Sgd`` keeps
its state in the same links) and a JSON ``__meta__``.  Conv weights, masks
and their momentum traces are HWIO on disk, as ``tpuseg`` stores them, so a
checkpoint written by either package resumes in the other.  The write is
atomic (tmp + rename).  The orbax envelope (``.orbax`` paths) is not
ported.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Mapping

import numpy as np
import torch

from tpuseg_torch.models.weights import from_jax_params


def _to_disk(v) -> np.ndarray:
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def _from_disk(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=like.device, dtype=like.dtype)


def _no_orbax(path: str) -> None:
    if path.endswith(".orbax"):
        raise NotImplementedError(f"{path}: the orbax checkpoint envelope is not ported "
                                  "(ROADMAP A21); use an .npz path")


def _flatten_opt(opt_state) -> dict[str, np.ndarray]:
    flat = {}
    for i, link in enumerate(opt_state):
        for field, v in link.items():
            if isinstance(v, Mapping):
                for name, t in v.items():
                    flat[f"{i}/.{field}/{name}"] = _to_disk(t)
            else:
                flat[f"{i}/.{field}"] = _to_disk(v)
    return flat


def save_checkpoint(
    path: str,
    params: Mapping[str, Any],
    bn_state: Mapping[str, Any],
    *,
    opt_state: Any = None,
    masks: Mapping[str, Any] | None = None,
    meta: Mapping[str, Any] | None = None,
    is_best: bool = False,
) -> None:
    _no_orbax(path)
    arrays: dict[str, np.ndarray] = {}
    arrays.update({f"params/{k}": _to_disk(v) for k, v in params.items()})
    arrays.update({f"bn_state/{k}": _to_disk(v) for k, v in bn_state.items()})
    if masks:
        arrays.update({f"masks/{k}": _to_disk(v) for k, v in masks.items()})
    if opt_state is not None:
        arrays.update({f"opt/{k}": v for k, v in _flatten_opt(opt_state).items()})
    arrays["__meta__"] = np.frombuffer(json.dumps(dict(meta or {})).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    if is_best:
        # best-copy alongside, like checkpoint_best.pth.tar (semantic_seg.py:290)
        shutil.copyfile(path, os.path.join(os.path.dirname(path) or ".", "checkpoint_best.npz"))


def load_checkpoint(path: str):
    """Returns (params, bn_state, masks, opt_arrays, meta): params, BN state
    and masks as the port's CPU tensors (conv weights and masks OIHW);
    ``opt_arrays`` the flat ``{link path: array}`` dict as on disk — restore
    it into a live optimizer state with ``restore_opt_state``."""
    _no_orbax(path)
    params, bn_state, masks, opt_arrays = {}, {}, {}, {}
    meta: dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as blob:
        for key in blob.files:
            if key == "__meta__":
                meta = json.loads(bytes(blob[key]).decode())
            elif key.startswith("params/"):
                params[key[len("params/"):]] = blob[key]
            elif key.startswith("bn_state/"):
                bn_state[key[len("bn_state/"):]] = blob[key]
            elif key.startswith("masks/"):
                masks[key[len("masks/"):]] = blob[key]
            elif key.startswith("opt/"):
                opt_arrays[key[len("opt/"):]] = blob[key]
    params, bn_state = from_jax_params(params, bn_state)
    masks, _ = from_jax_params(masks)
    return params, bn_state, masks, opt_arrays, meta


def restore_opt_state(template_opt_state, opt_arrays: Mapping[str, np.ndarray]):
    """Fill a freshly initialized optimizer state from saved flat arrays
    (entries missing from ``opt_arrays`` keep the template's)."""
    out = []
    for i, link in enumerate(template_opt_state):
        new = {}
        for field, v in link.items():
            if isinstance(v, Mapping):
                new[field] = {
                    name: (_from_disk(opt_arrays[f"{i}/.{field}/{name}"], t)
                           if f"{i}/.{field}/{name}" in opt_arrays else t)
                    for name, t in v.items()}
            else:
                key = f"{i}/.{field}"
                new[field] = _from_disk(opt_arrays[key], v) if key in opt_arrays else v
        out.append(new)
    return tuple(out)
