"""Pruning masks for the port: JSON pruner configs -> 0/1 OIHW masks.

The maskers are the port's own copy of ``tpuseg``'s masker family (every
pruner type: ``block``, ``block_regular``, ``srmbrep``, ``hb``, ``rmb``,
``rmcdb``, ``grouping``), numpy only, in the modules of this package; they
compute on the HWIO numpy view of the port's weights and the masks come
back as OIHW tensors, so one seed gives the same masks in both packages bit
for bit.

Masks are static (``is_static=True``, the construction both serving CLIs
use): drawn at random from the seed, not from the weights' magnitudes.
"""

from __future__ import annotations

from typing import Mapping

import torch

# every masker module registers its pruner type with base's registry
from tpuseg_torch.sparsity import (  # noqa: F401
    base,
    block,
    block_regular,
    grouping,
    hb,
    rmb,
    rmcdb,
    srmbrep,
)


class Masker:
    """``generate_masks(params)`` -> ``{layer: float32 OIHW 0/1 tensor}``
    from the config's masker on the HWIO view of ``params``."""

    def __init__(self, config, seed):
        self._masker = base.create_masker(config, seed=seed)

    def generate_masks(self, params: Mapping) -> dict[str, torch.Tensor]:
        from tpuseg_torch.models.weights import from_jax_params, to_jax_params

        hwio, _ = to_jax_params(params)
        masks = self._masker.generate_masks(hwio, is_static=True)
        return from_jax_params(masks)[0]


def create_masker(config, seed: int | None = 0) -> Masker:
    """The masker of the config's ``pruner_type`` (a JSON path or dict)."""
    return Masker(config, seed)


def apply_masks(params: Mapping, masks: Mapping) -> dict:
    """``params[k] * masks[k]`` for every masked layer (a new dict)."""
    out = dict(params)
    for k, m in masks.items():
        out[k] = out[k] * m.to(out[k].dtype)
    return out
