"""Masker base: JSON config parsing, mask pytrees, functional apply.

Behavioral reference: the reference's pruners/Pruner.py:6-27.  Differences by
design (TPU-first):

- ``apply_masks`` is a *pure function* ``(params, masks) -> params`` executed
  inside the jitted train step after the optimizer update (the reference
  mutates ``model.state_dict()`` in-place after every ``optimizer.step()``,
  semantic_seg.py:213-214).
- masks are generated with an explicit ``np.random.Generator`` and are part
  of the checkpoint (the reference regenerates masks each run, which is
  nondeterministic for random-construction modes — SURVEY.md §5).
- maskers receive/emit arrays in tpuseg's storage layout (HWIO for convs)
  but internally compute in the reference's (OFM, IFM, kh, kw) view so the
  shipped configs' block geometry means the same thing.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np

_REGISTRY: dict[str, type] = {}


def register_masker(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.pruner_type = name
        return cls

    return deco


def hwio_to_oihw(arr: np.ndarray) -> np.ndarray:
    return np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr


def oihw_to_hwio(arr: np.ndarray) -> np.ndarray:
    return np.transpose(arr, (2, 3, 1, 0)) if arr.ndim == 4 else arr


class Masker:
    """Base masker.  Subclasses implement ``parse_layer_config`` and
    ``generate_mask(tensor_oihw, layer_config, rng) -> 0/1 ndarray``."""

    pruner_type = "base"

    def __init__(self, config: str | Mapping[str, Any], seed: int | None = 0):
        if isinstance(config, (str, bytes)):
            with open(config) as fh:
                data = json.load(fh)
        else:
            data = dict(config)
        self.config = data
        self.seed = seed
        self.layer_configs: dict[str, Any] = {}
        for ls_config in data["configs"]:
            parsed = self.parse_layer_config(ls_config)
            for layer in ls_config["layer_set"]:
                self.layer_configs[layer] = parsed

    # -- subclass API ------------------------------------------------------
    def parse_layer_config(self, ls_config: Mapping[str, Any]) -> Any:
        raise NotImplementedError

    def generate_mask(
        self, tensor: np.ndarray, cfg: Any, rng: np.random.Generator, is_static: bool
    ) -> np.ndarray:
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def generate_masks(
        self,
        params: Mapping[str, Any],
        is_static: bool = False,
        verbose: bool = False,
    ) -> dict[str, np.ndarray]:
        """Build 0/1 masks for every configured layer.

        ``params`` values may be numpy arrays in storage layout; returned
        masks are float32 in the same storage layout.
        """
        rng = np.random.default_rng(self.seed)
        masks: dict[str, np.ndarray] = {}
        for layer, cfg in self.layer_configs.items():
            if layer not in params and layer.startswith("module."):
                # several shipped optimal_configs target DataParallel-
                # wrapped state_dict names ("module.layer...") — the
                # reference's models carry that prefix at generate time
                # (semantic_seg.py:809-815); strip it like the checkpoint
                # importer does
                layer = layer[len("module."):]
            if layer not in params:
                raise KeyError(
                    f"mask config targets unknown layer {layer!r}; "
                    f"known keys include {sorted(params)[:4]}..."
                )
            tensor = hwio_to_oihw(np.asarray(params[layer], dtype=np.float32))
            if verbose:
                print(f"Generating mask for layer {layer}")
            mask = self.generate_mask(tensor, cfg, rng, is_static)
            masks[layer] = oihw_to_hwio(mask.astype(np.float32))
        return masks


def create_masker(
    config: str | Mapping[str, Any], seed: int | None = 0
) -> Masker:
    """Dispatch on the config's ``pruner_type`` field
    (cf. semantic_seg.py:830-846)."""
    if isinstance(config, (str, bytes)):
        with open(config) as fh:
            data = json.load(fh)
    else:
        data = config
    ptype = data["pruner_type"]
    if ptype not in _REGISTRY:
        raise ValueError(f"unknown pruner_type {ptype!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[ptype](data, seed=seed)


def apply_masks(params: Mapping[str, Any], masks: Mapping[str, Any]):
    """Pure masked-weight projection: ``params[k] *= masks[k]``.

    jit-compatible; call inside the train step after the optimizer update
    (straight-through masked dense training, Pruner.py:17-20).
    """
    out = dict(params)
    for k, m in masks.items():
        out[k] = out[k] * m
    return out


def mask_sparsity_stats(masks: Mapping[str, Any]) -> dict[str, float]:
    """Per-layer sparsity percentage (Pruner.print_stats, Pruner.py:25-27)."""
    stats = {}
    for k, m in masks.items():
        m = np.asarray(m)
        stats[k] = (1.0 - np.count_nonzero(m) / m.size) * 100.0
    return stats
