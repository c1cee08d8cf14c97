"""SRMBRep / RBGP masker: hierarchical Kronecker-product structured masks.

Behavioral reference: the reference's pruners/SRMBRepMasker.py:337-383.
The mask is ``OB ⊗ (CB ⊗ P) ⊗ IB`` where

- ``OB``  (rows/obh x cols/obw) outer pattern at sparsity ``osp``/``opat``
- ``CB``  (obh/cbh x obw/cbw) all-ones core tiling
- ``P``   (cbh/ibh x cbw/ibw) inner pattern at ``isp``/``ipat``
- ``IB``  (ibh x ibw*kernel) all-ones inner block

With ``is_repetitive=True`` the same inner pattern repeats in every outer
block, making the mask periodic.  ``tpuseg_torch.ops.rbgp_matmul`` detects that
structure and routes each layer to its best MXU lowering (COLUMN/GROUP
patterns compact to dense/grouped convs with real FLOP savings; expander
RAMANUJAN patterns are measured MXU-optimal on the dense path — see the
rbgp_matmul module docstring for the v5e numbers).  This is a
construction-only (static) masker.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from tpuseg_torch.sparsity.base import Masker, register_masker
from tpuseg_torch.sparsity.patterns import generate_sparsity_pattern


@dataclasses.dataclass
class SRMBRepConfig:
    obh: int
    obw: int
    cbh: int
    cbw: int
    ibh: int
    ibw: int
    osp: float
    opat: str
    isp: float
    ipat: str
    is_repetitive: bool
    collapse_tensor: bool
    cross_prob: float = 0.5
    is_symmetric: bool = False


def construct_srmbrep_mask(
    tensor: np.ndarray, cfg: SRMBRepConfig, rng: np.random.Generator
) -> np.ndarray:
    rows = tensor.shape[0]
    cols = tensor.shape[1] if tensor.ndim > 1 else tensor.size // rows
    kernel_size = tensor.size // (rows * cols)
    if cfg.collapse_tensor:
        cols *= kernel_size
        kernel_size = 1

    obh = rows if cfg.obh == -1 else cfg.obh
    obw = cols if cfg.obw == -1 else cfg.obw
    cbh = obh if cfg.cbh == -1 else cfg.cbh
    cbw = obw if cfg.cbw == -1 else cfg.cbw
    ibh, ibw = cfg.ibh, cfg.ibw

    OB = generate_sparsity_pattern(
        rows // obh, cols // obw, cfg.osp, cfg.opat, rng, cfg.cross_prob, cfg.is_symmetric
    )
    CB = np.ones((obh // cbh, obw // cbw))
    IB = np.ones((ibh, ibw * kernel_size))

    if cfg.is_repetitive:
        P = generate_sparsity_pattern(
            cbh // ibh, cbw // ibw, cfg.isp, cfg.ipat, rng, cfg.cross_prob, cfg.is_symmetric
        )
        mask_mat = np.kron(np.kron(OB, np.kron(CB, P)), IB)
    else:
        # Fresh inner pattern per surviving outer block
        # (SRMBRepMasker.py:363-380).
        nrb, ncb = rows // obh, cols // obw
        smbl_nrb, smbl_ncb = obh // ibh, obw // ibw
        OCP = np.zeros((rows // ibh, cols // ibw))
        for rb in range(nrb):
            for cb in range(ncb):
                if OB[rb, cb] == 1:
                    P = generate_sparsity_pattern(
                        cbh // ibh, cbw // ibw, cfg.isp, cfg.ipat, rng,
                        cfg.cross_prob, cfg.is_symmetric,
                    )
                    OCP[
                        rb * smbl_nrb : (rb + 1) * smbl_nrb,
                        cb * smbl_ncb : (cb + 1) * smbl_ncb,
                    ] += np.kron(CB, P)
        mask_mat = np.kron(OCP, IB)

    return mask_mat.reshape(tensor.shape).astype(np.float64)


@register_masker("srmbrep")
class SRMBRepMasker(Masker):
    def parse_layer_config(self, ls_config: Mapping[str, Any]) -> SRMBRepConfig:
        return SRMBRepConfig(
            obh=ls_config["obh"],
            obw=ls_config["obw"],
            cbh=ls_config["cbh"],
            cbw=ls_config["cbw"],
            ibh=ls_config["ibh"],
            ibw=ls_config["ibw"],
            osp=ls_config["osp"],
            opat=ls_config["opat"],
            isp=ls_config["isp"],
            ipat=ls_config["ipat"],
            is_repetitive=ls_config["is_repetitive"],
            collapse_tensor=ls_config["collapse_tensor"],
            cross_prob=ls_config.get("cross_prob", 0.5),
            is_symmetric=ls_config.get("is_symmetric", False),
        )

    def generate_mask(self, tensor, cfg, rng, is_static=True):
        # srmbrep is construction-only (static) in the reference too.
        return construct_srmbrep_mask(tensor, cfg, rng)

    def layer_kernel_plan(self, layer: str):
        """Expose the RBGP geometry for the Pallas/grouped-matmul lowering."""
        return self.layer_configs[layer]
