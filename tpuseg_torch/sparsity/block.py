"""Block masker: magnitude top-k (or random construction) over bh x bw blocks.

Behavioral reference: the reference's pruners/BlockPruner.py (prune:139-241,
construct:251-341).  The block-|sum| meta matrix, thresholding rule
(strictly-greater-than the k-th smallest), optional recursive sub-tiling via
(sub_rows, sub_cols), and the collapse_tensor column scaling all match the
reference; the inner loops are vectorized with reshape-tricks instead of
per-block Python loops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from tpuseg_torch.sparsity.base import Masker, register_masker


@dataclasses.dataclass
class BlockConfig:
    sparsity: float
    block_height: int
    block_width: int
    sub_rows: int
    sub_cols: int
    collapse_tensor: bool


def parse_block_config(d: Mapping[str, Any]) -> BlockConfig:
    return BlockConfig(
        sparsity=d["sparsity"],
        block_height=d["block_height"],
        block_width=d["block_width"],
        sub_rows=d["sub_rows"],
        sub_cols=d["sub_cols"],
        collapse_tensor=d["collapse_tensor"],
    )


def block_abs_sums(mat: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Meta matrix of per-block |sum|s, ceil-padded at the edges.

    Equivalent to the loop at BlockPruner.py:178-187 (and
    pruners/utils.py:get_meta_matrix) but vectorized.
    """
    rows, cols = mat.shape
    nrb = -(-rows // bh)
    ncb = -(-cols // bw)
    padded = np.zeros((nrb * bh, ncb * bw), dtype=np.float64)
    padded[:rows, :cols] = np.abs(mat)
    return padded.reshape(nrb, bh, ncb, bw).sum(axis=(1, 3))


def _expand_block_mask(meta_mask: np.ndarray, bh: int, bw: int, rows: int, cols: int):
    full = np.kron(meta_mask, np.ones((bh, bw)))
    return full[:rows, :cols]


def _resolve_dims(tensor: np.ndarray, cfg: BlockConfig):
    """Collapse to (rows, cols) and resolve -1 / non-collapsed widths
    (BlockPruner.py:143-164)."""
    mat = tensor.reshape(tensor.shape[0], -1)
    rows, cols = mat.shape
    bh = rows if cfg.block_height == -1 else cfg.block_height
    sub_rows = rows if cfg.sub_rows == -1 else cfg.sub_rows
    unit = tensor.size // (tensor.shape[0] * tensor.shape[1]) if tensor.ndim > 1 else 1
    if cfg.block_width == -1:
        bw = cols
    else:
        bw = cfg.block_width if cfg.collapse_tensor else cfg.block_width * unit
    if cfg.sub_cols == -1:
        sub_cols = cols
    else:
        sub_cols = cfg.sub_cols if cfg.collapse_tensor else cfg.sub_cols * unit
    return mat, rows, cols, bh, bw, sub_rows, sub_cols


def prune_as_block(tensor: np.ndarray, cfg: BlockConfig, rev_mask: bool = False) -> np.ndarray:
    """Magnitude block pruning.  Returns a 0/1 mask shaped like ``tensor``."""
    assert 0 <= cfg.sparsity <= 1, "sparsity must be in [0,1]"
    mat, rows, cols, bh, bw, sub_rows, sub_cols = _resolve_dims(tensor, cfg)
    mask = np.zeros((rows, cols), dtype=np.float64)

    if (rows, cols) == (sub_rows, sub_cols):
        if cfg.sparsity > 0:
            meta = mat if (bh, bw) == (1, 1) else block_abs_sums(mat, bh, bw)
            # Keep strictly-above-threshold blocks; threshold is the k-th
            # smallest |block sum| with k = sparsity*size - 1
            # (BlockPruner.py:190-207).
            thresh_ind = max(0, int(cfg.sparsity * meta.size) - 1)
            thresh_val = np.sort(np.abs(meta).ravel())[thresh_ind]
            meta_mask = (np.abs(meta) > thresh_val).astype(np.float64)
            if (bh, bw) == (1, 1):
                mask = meta_mask
            else:
                mask = _expand_block_mask(meta_mask, bh, bw, rows, cols)
        else:
            mask.fill(1)
    else:
        nrb = -(-rows // sub_rows)
        ncb = -(-cols // sub_cols)
        for rb in range(nrb):
            for cb in range(ncb):
                rs, re = rb * sub_rows, min((rb + 1) * sub_rows, rows)
                cs, ce = cb * sub_cols, min((cb + 1) * sub_cols, cols)
                sub = mat[rs:re, cs:ce]
                sub_cfg = dataclasses.replace(
                    cfg, sub_rows=-1, sub_cols=-1, collapse_tensor=True,
                    block_height=bh, block_width=bw,
                )
                mask[rs:re, cs:ce] = prune_as_block(sub, sub_cfg)

    if rev_mask:
        mask = (mask + 1) % 2
    return mask.reshape(tensor.shape)


def construct_as_block(
    tensor: np.ndarray, cfg: BlockConfig, rng: np.random.Generator, rev_mask: bool = False
) -> np.ndarray:
    """Random block *construction* (static masks, BlockPruner.py:251-341)."""
    assert 0 <= cfg.sparsity <= 1
    mat, rows, cols, bh, bw, sub_rows, sub_cols = _resolve_dims(tensor, cfg)
    mask = np.zeros((rows, cols), dtype=np.float64)

    if (rows, cols) == (sub_rows, sub_cols):
        if cfg.sparsity > 0:
            nrb = -(-rows // bh)
            ncb = -(-cols // bw)
            nnzb = int((1.0 - cfg.sparsity) * (nrb * ncb))
            meta_mask = np.zeros(nrb * ncb)
            meta_mask[rng.choice(nrb * ncb, nnzb, replace=False)] = 1
            meta_mask = meta_mask.reshape(nrb, ncb)
            mask = (
                meta_mask
                if (bh, bw) == (1, 1)
                else _expand_block_mask(meta_mask, bh, bw, rows, cols)
            )
        else:
            mask.fill(1)
    else:
        nrb = -(-rows // sub_rows)
        ncb = -(-cols // sub_cols)
        for rb in range(nrb):
            for cb in range(ncb):
                rs, re = rb * sub_rows, min((rb + 1) * sub_rows, rows)
                cs, ce = cb * sub_cols, min((cb + 1) * sub_cols, cols)
                sub = mat[rs:re, cs:ce]
                sub_cfg = dataclasses.replace(
                    cfg, sub_rows=-1, sub_cols=-1, collapse_tensor=True,
                    block_height=bh, block_width=bw,
                )
                mask[rs:re, cs:ce] = construct_as_block(sub, sub_cfg, rng)

    if rev_mask:
        mask = (mask + 1) % 2
    return mask.reshape(tensor.shape)


@register_masker("block")
class BlockMasker(Masker):
    def parse_layer_config(self, ls_config):
        return parse_block_config(ls_config)

    def generate_mask(self, tensor, cfg, rng, is_static):
        if is_static:
            return construct_as_block(tensor, cfg, rng)
        return prune_as_block(tensor, cfg)
