"""Block-regular masker: block-level N:M — per OUT-block top-k IN-blocks.

tpuseg-native serving geometry (no reference counterpart; the closest
reference relative is pruners/BlockPruner.py, whose per-layer strict
threshold can zero every block of a small layer — measured: the 87.5%
block128 config kills ALL of DRN-D-22's stage-5 2-and-4-block layers,
docs/PERF_NOTES.md round-4 cont.).  This masker instead ranks blocks
per out-block ROW of the (nkb x nmb) block meta-matrix and keeps the
top ``k = max(1, round((1-sparsity) * nkb))`` in-blocks of each:

- every out-block (and therefore every layer) keeps at least one live
  in-block — no dead layers, no dead output channels at any sparsity;
- supports are UNIFORM (every out-block has exactly k in-blocks), the
  friendliest shape for the gathered serving lowerings: exact mode's
  per-block convs are all the same size, split mode pays zero repeat
  padding (S_max == S_j == k);
- it is N:M sparsity lifted to MXU block granularity (keep k of nkb
  128-channel blocks per 128-output block), the structured-sparsity
  family TPU serving actually exploits.

Mask granularity is (128 in x 128 out) channel blocks, uniform across
the spatial taps (the meta matrix sums |w| over taps and within-block
entries — the same coarsening the serving planner applies, so the plan
realizes the mask with no union inflation).

Config schema (reference JSON envelope, create_masker dispatch):
{"pruner_type": "block_regular", "configs": [{"layer_set": [...],
  "sparsity": 0.875, "block_height": 128, "block_width": 128}]}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from tpuseg_torch.sparsity.base import Masker, register_masker


@dataclasses.dataclass
class BlockRegularConfig:
    sparsity: float
    block_height: int = 128  # output-channel block (rows of OIHW)
    block_width: int = 128   # input-channel block


def prune_as_block_regular(
    tensor_oihw: np.ndarray,
    cfg: BlockRegularConfig,
    rng: np.random.Generator | None = None,
    is_static: bool = False,
) -> np.ndarray:
    """0/1 mask keeping the top-k in-blocks per out-block (magnitude), or
    k uniform-random in-blocks per out-block when ``is_static``.

    ``tensor_oihw``: (O, I, kh, kw) conv or (O, I) linear weights.  Block
    sizes clamp to the layer dims; edge-partial blocks are allowed (ceil
    grid).  k = max(1, round((1 - sparsity) * n_in_blocks)).
    """
    assert 0.0 <= cfg.sparsity <= 1.0, cfg.sparsity
    shape = tensor_oihw.shape
    o, i = shape[0], (shape[1] if tensor_oihw.ndim > 1 else 1)
    taps = int(np.prod(shape[2:])) if tensor_oihw.ndim > 2 else 1
    bh = min(cfg.block_height, o)
    bw = min(cfg.block_width, i)
    nob = -(-o // bh)
    nib = -(-i // bw)
    k = max(1, int(round((1.0 - cfg.sparsity) * nib)))
    # meta[ob, ib] = sum over taps and within-block |w| (zero-padded edges)
    w = np.abs(np.asarray(tensor_oihw, np.float64)).reshape(o, i, taps).sum(-1)
    padded = np.zeros((nob * bh, nib * bw), np.float64)
    padded[:o, :i] = w
    meta = padded.reshape(nob, bh, nib, bw).sum(axis=(1, 3))  # (nob, nib)
    meta_mask = np.zeros((nob, nib), np.float64)
    if is_static and rng is None:
        # one generator for the whole layer — constructing it inside the
        # loop would hand every out-block the identical "random" support
        rng = np.random.default_rng(0)
    for ob in range(nob):
        if is_static:
            keep = rng.choice(nib, size=k, replace=False)
        else:
            # descending by |block sum|; ties break at the lower in-block
            # index (stable argsort of the negated row)
            keep = np.argsort(-meta[ob], kind="stable")[:k]
        meta_mask[ob, keep] = 1.0
    full = np.kron(meta_mask, np.ones((bh, bw)))[:o, :i]  # (O, I)
    mask = np.broadcast_to(
        full.reshape(o, i, *([1] * (tensor_oihw.ndim - 2))), shape
    )
    return np.ascontiguousarray(mask)


@register_masker("block_regular")
class BlockRegularMasker(Masker):
    def parse_layer_config(self, ls_config: Mapping[str, Any]):
        return BlockRegularConfig(
            sparsity=ls_config["sparsity"],
            block_height=ls_config.get("block_height", 128),
            block_width=ls_config.get("block_width", 128),
        )

    def generate_mask(self, tensor, cfg, rng, is_static):
        return prune_as_block_regular(tensor, cfg, rng, is_static)
