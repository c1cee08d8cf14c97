"""RMB masker: Ramanujan Multi-Blocklet magnitude pruning.

Behavioral reference: the reference's pruners/RmbPruner.py:127-243.

Two phases per layer:
1. *Outer sparsity* ``spo``: per row-block, keep bh x bw blocks whose |sum|
   exceeds the row's k-th smallest block score (RmbPruner.py:144-173).
2. *Inner blocklets*: inside each surviving block, for each blocklet type
   (bl_bh x bl_bw, count c) repeat c times: for every blocklet-row pick the
   blocklet-column with maximal |sum|, claim it (zero it out), and set the
   mask (RmbPruner.py:175-231) — a multi-diagonal-like structure.

Also records the blocklet choices so a BSR text writer can serialize
the 9-array RMB sparse format bit-compatibly.

``RmbMasker.use_native`` (True, as in ``tpuseg``) computes the mask in the
native library (``tpuseg_torch.native.rmb_prune``, built at first use; a
failed build raises); False keeps the numpy path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from tpuseg_torch.sparsity.base import Masker, register_masker
from tpuseg_torch.sparsity.block import block_abs_sums


@dataclasses.dataclass
class BlockletType:
    bh: int
    bw: int


@dataclasses.dataclass
class RmbConfig:
    bh: int
    bw: int
    spo: float
    bl_types: list[BlockletType]
    bl_counts: list[int]


@dataclasses.dataclass
class Blocklet:
    """One chosen blocklet inside global block (grb, gcb)."""

    grb: int
    gcb: int
    bh: int  # blocklet type height
    bw: int  # blocklet type width
    values: np.ndarray  # (block_bh, bw) stacked chosen columns
    indices: np.ndarray  # (block_bh // bh,) chosen blocklet-column per blocklet-row
    block_bh: int
    block_bw: int


def prune_as_rmb(
    tensor: np.ndarray, cfg: RmbConfig, collect: bool = False
) -> tuple[np.ndarray, list[Blocklet]]:
    mat = np.array(tensor.reshape(tensor.shape[0], -1), dtype=np.float64, copy=True)
    mask = np.zeros(mat.shape)
    rows, cols = mat.shape
    bh, bw = cfg.bh, cfg.bw
    assert rows % bh == 0, "Block height should divide rows"
    assert cols % bw == 0, "Block width should divide columns"
    nrb, ncb = rows // bh, cols // bw

    # Outer sparsity: per-row-block top-k of block scores.  The |mat| fast
    # path is only shape-consistent when BOTH block dims are 1 (the
    # reference gates on `bh != 1 and bw != 1`, RmbPruner.py:147-152, which
    # crashes/mis-scores for e.g. 2x1 or 1x4 blocks — same class of bug as
    # the fixed rmcdb `rb`, see rmcdb.py).
    meta_mask = np.ones((nrb, ncb))
    if cfg.spo > 0:
        meta = np.abs(mat) if (bh == 1 and bw == 1) else block_abs_sums(mat, bh, bw)
        thresh_ind = int(cfg.spo * meta.shape[1]) - 1
        if thresh_ind >= 0:
            for rb in range(nrb):
                thresh_val = np.sort(np.abs(meta[rb]).ravel())[thresh_ind]
                meta_mask[rb][meta[rb] <= thresh_val] = 0

    blocklets: list[Blocklet] = []
    for rb in range(nrb):
        for cb in range(ncb):
            if meta_mask[rb, cb] == 0:
                continue
            loc = mat[rb * bh : (rb + 1) * bh, cb * bw : (cb + 1) * bw]
            for bl_id, bl_type in enumerate(cfg.bl_types):
                bl_bh, bl_bw = bl_type.bh, bl_type.bw
                bl_nrb, bl_ncb = bh // bl_bh, bw // bl_bw
                for _ in range(cfg.bl_counts[bl_id]):
                    values = np.zeros((bh, bl_bw))
                    indices = np.zeros(bl_nrb, dtype=int)
                    for bl_rb in range(bl_nrb):
                        rb_mat = loc[bl_rb * bl_bh : (bl_rb + 1) * bl_bh]
                        # per blocklet-column |sum| scores, greedy max
                        scores = (
                            np.abs(rb_mat)
                            .reshape(bl_bh, bl_ncb, bl_bw)
                            .sum(axis=(0, 2))
                        )
                        ch = int(np.argmax(scores))
                        values[bl_rb * bl_bh : (bl_rb + 1) * bl_bh] = rb_mat[
                            :, ch * bl_bw : (ch + 1) * bl_bw
                        ]
                        indices[bl_rb] = ch
                        rb_mat[:, ch * bl_bw : (ch + 1) * bl_bw] = 0
                        mask[
                            rb * bh + bl_rb * bl_bh : rb * bh + (bl_rb + 1) * bl_bh,
                            cb * bw + ch * bl_bw : cb * bw + (ch + 1) * bl_bw,
                        ] = 1.0
                    if collect:
                        blocklets.append(
                            Blocklet(rb, cb, bl_bh, bl_bw, values, indices, bh, bw)
                        )
    return mask.reshape(tensor.shape), blocklets


@register_masker("rmb")
class RmbMasker(Masker):
    use_native = True  # the C++ path of native/sparsity.cpp (tpuseg/sparsity/rmb.py:121)

    def parse_layer_config(self, ls_config: Mapping[str, Any]) -> RmbConfig:
        bl_types = [BlockletType(b["bh"], b["bw"]) for b in ls_config["blocklets"]]
        bl_counts = [b["count"] for b in ls_config["blocklets"]]
        return RmbConfig(
            bh=ls_config["global_bh"],
            bw=ls_config["global_bw"],
            spo=ls_config["global_sp"],
            bl_types=bl_types,
            bl_counts=bl_counts,
        )

    def generate_mask(self, tensor, cfg, rng, is_static):
        if self.use_native:
            from tpuseg_torch import native

            mat = tensor.reshape(tensor.shape[0], -1)
            mask = native.rmb_prune(mat, cfg.bh, cfg.bw, cfg.spo, cfg.bl_types, cfg.bl_counts)
            return mask.reshape(tensor.shape)
        mask, _ = prune_as_rmb(tensor, cfg)
        return mask
