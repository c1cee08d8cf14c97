"""Hierarchical-block masker: multi-level block pruning.

Behavioral reference: the reference's pruners/HbPruner.py:41-74 — apply the
block masker per level, subtract the selected mass from the tensor, and sum
the level masks (e.g. 2x2 blocks first, then 1x1 stragglers).
"""

from __future__ import annotations

import numpy as np

from tpuseg_torch.sparsity.base import Masker, register_masker
from tpuseg_torch.sparsity.block import construct_as_block, parse_block_config, prune_as_block


@register_masker("hb")
class HbMasker(Masker):
    def parse_layer_config(self, ls_config):
        return [parse_block_config(d) for d in ls_config["levels"]]

    def generate_mask(self, tensor, cfg, rng, is_static):
        tensor = np.array(tensor, dtype=np.float64, copy=True)
        final = np.zeros(tensor.shape, dtype=np.float64)
        for level_cfg in cfg:
            if is_static:
                mask = construct_as_block(tensor, level_cfg, rng)
            else:
                mask = prune_as_block(tensor, level_cfg)
            tensor = tensor - mask * tensor
            final = final + mask
        return np.clip(final, 0, 1)
