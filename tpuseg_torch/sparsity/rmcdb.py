"""RMCDB masker: Ramanujan Multi-Cyclic-Diagonal-Blocklet pruning.

Behavioral reference: the reference's pruners/RmcdbPruner.py:144-316.

Per surviving bh x bw block, score every cyclic diagonal of blocklet
sub-blocks (offset d: blocklet-row r uses blocklet-col (r+d) % ncb), keep the
top ``count`` diagonals per blocklet type.  The construction (static) mode
picks random diagonals instead.

Note: the reference's ``construct_rmcdb_matrix`` has a latent bug — it uses
an undefined loop variable ``rb`` when applying outer sparsity
(RmcdbPruner.py:167).  We implement the evident intent (independent random
zero-blocks per row block) instead of replicating the crash.
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
class RmcdbConfig:
    bh: int
    bw: int
    spo: float
    bl_types: list[BlockletType]
    bl_counts: list[int]
    collapse_tensor: bool = True


@dataclasses.dataclass
class CyDiaBlocklet:
    grb: int
    gcb: int
    bh: int
    bw: int
    values: np.ndarray  # (block_bh, bl_bw)
    offset: int
    block_bh: int
    block_bw: int


def _set_diagonal(mask, rb, cb, bh, bw, bl_bh, bl_bw, offset):
    bl_nrb, bl_ncb = bh // bl_bh, bw // bl_bw
    for bl_rb in range(bl_nrb):
        bl_cb = (bl_rb + offset) % bl_ncb
        mask[
            rb * bh + bl_rb * bl_bh : rb * bh + (bl_rb + 1) * bl_bh,
            cb * bw + bl_cb * bl_bw : cb * bw + (bl_cb + 1) * bl_bw,
        ] = 1


def construct_rmcdb(
    tensor: np.ndarray, cfg: RmcdbConfig, rng: np.random.Generator
) -> np.ndarray:
    rows = tensor.shape[0]
    cols = tensor.size // rows
    bh, bw = cfg.bh, cfg.bw
    assert rows % bh == 0 and cols % bw == 0
    nrb, ncb = rows // bh, cols // bw
    mask = np.zeros((rows, cols))

    meta_mask = np.ones((nrb, ncb))
    if cfg.spo > 0:
        nzb = int(cfg.spo * ncb)
        for rb in range(nrb):
            meta_mask[rb, rng.choice(ncb, nzb, replace=False)] = 0

    for rb in range(nrb):
        for cb in range(ncb):
            if meta_mask[rb, cb] == 0:
                continue
            for bl_type, count in zip(cfg.bl_types, cfg.bl_counts):
                assert bh % bl_type.bh == 0 and bw % bl_type.bw == 0
                bl_ncb = bw // bl_type.bw
                for off in rng.choice(bl_ncb, count, replace=False):
                    _set_diagonal(mask, rb, cb, bh, bw, bl_type.bh, bl_type.bw, int(off))
    return mask.reshape(tensor.shape)


def prune_as_rmcdb(
    tensor: np.ndarray, cfg: RmcdbConfig, collect: bool = False
) -> tuple[np.ndarray, list[CyDiaBlocklet]]:
    mat = np.array(tensor.reshape(tensor.shape[0], -1), dtype=np.float64, copy=True)
    mask = np.zeros(mat.shape)
    rows, cols = mat.shape
    bh, bw = cfg.bh, cfg.bw
    assert rows % bh == 0 and cols % bw == 0
    nrb, ncb = rows // bh, cols // bw

    meta_mask = np.ones((nrb, ncb))
    if cfg.spo > 0:
        meta = block_abs_sums(mat, bh, bw)
        thresh_ind = int(cfg.spo * ncb) - 1
        if thresh_ind >= 0:
            for rb in range(nrb):
                thresh_val = np.sort(np.abs(meta[rb]).ravel())[thresh_ind]
                meta_mask[rb][meta[rb] <= thresh_val] = 0

    blocklets: list[CyDiaBlocklet] = []
    for rb in range(nrb):
        for cb in range(ncb):
            if meta_mask[rb, cb] == 0:
                continue
            loc = mat[rb * bh : (rb + 1) * bh, cb * bw : (cb + 1) * bw]
            for bl_type, count in zip(cfg.bl_types, cfg.bl_counts):
                bl_bh, bl_bw = bl_type.bh, bl_type.bw
                assert bh % bl_bh == 0 and bw % bl_bw == 0
                bl_nrb, bl_ncb = bh // bl_bh, bw // bl_bw
                # score each cyclic diagonal: sum of blocklet |sums| along it
                meta_loc = block_abs_sums(loc, bl_bh, bl_bw)
                rows_idx = np.arange(bl_nrb)
                scores = np.zeros(bl_ncb)
                for d in range(bl_ncb):
                    scores[d] = meta_loc[rows_idx, (rows_idx % bl_ncb + d) % bl_ncb].sum()
                for d in np.argsort(scores)[::-1][:count]:
                    d = int(d)
                    values = np.zeros((bh, bl_bw))
                    for bl_rb in range(bl_nrb):
                        bl_cb = (bl_rb + d) % bl_ncb
                        values[bl_rb * bl_bh : (bl_rb + 1) * bl_bh] = loc[
                            bl_rb * bl_bh : (bl_rb + 1) * bl_bh,
                            bl_cb * bl_bw : (bl_cb + 1) * bl_bw,
                        ]
                        loc[
                            bl_rb * bl_bh : (bl_rb + 1) * bl_bh,
                            bl_cb * bl_bw : (bl_cb + 1) * bl_bw,
                        ] = 0
                    _set_diagonal(mask, rb, cb, bh, bw, bl_bh, bl_bw, d)
                    if collect:
                        blocklets.append(
                            CyDiaBlocklet(rb, cb, bl_bh, bl_bw, values, d, bh, bw)
                        )
    return mask.reshape(tensor.shape), blocklets


@register_masker("rmcdb")
class RmcdbMasker(Masker):
    def parse_layer_config(self, ls_config: Mapping[str, Any]) -> RmcdbConfig:
        bl_types = [BlockletType(b["bh"], b["bw"]) for b in ls_config["blocklets"]]
        bl_counts = [b["count"] for b in ls_config["blocklets"]]
        return RmcdbConfig(
            bh=ls_config["global_bh"],
            bw=ls_config["global_bw"],
            spo=ls_config["global_sp"],
            bl_types=bl_types,
            bl_counts=bl_counts,
            collapse_tensor=ls_config.get("collapse_tensor", True),
        )

    def generate_mask(self, tensor, cfg, rng, is_static):
        if is_static:
            return construct_rmcdb(tensor, cfg, rng)
        mask, _ = prune_as_rmcdb(tensor, cfg)
        return mask
