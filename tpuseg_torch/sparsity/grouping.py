"""Grouping masker: block-diagonal mask = grouped-convolution emulation.

Behavioral reference: the reference's pruners/GroupingPruner.py:51-60.
"""

from __future__ import annotations

import numpy as np

from tpuseg_torch.sparsity.base import Masker, register_masker


def grouping_mask(shape: tuple[int, ...], num_groups: int) -> np.ndarray:
    mask = np.zeros(shape, dtype=np.float64)
    ofm_stride = shape[0] // num_groups
    ifm_stride = shape[1] // num_groups
    for g in range(num_groups):
        mask[
            g * ofm_stride : (g + 1) * ofm_stride,
            g * ifm_stride : (g + 1) * ifm_stride,
        ] = 1
    return mask


@register_masker("grouping")
class GroupingMasker(Masker):
    def parse_layer_config(self, ls_config):
        return int(ls_config["num_groups"])

    def generate_mask(self, tensor, num_groups, rng, is_static):
        return grouping_mask(tensor.shape, num_groups)
