"""RMCDB cyclic-diagonal lowering: the roll + compact matmul (the port's
copy of ``tpuseg/ops/rmcdb_lowering.py``).

An RMCDB mask (``tpuseg_torch.sparsity.rmcdb``; the reference's
RmcdbPruner.py:271-283) keeps, per surviving (bh x bw) block, a few cyclic
diagonals of (b x b) blocklets: blocklet-row r is connected to
blocklet-column (r + d) % nbl.  Rolling the input's blocklet axis by -d
puts every kept blocklet of diagonal d on the block diagonal, so each kept
diagonal is one batched (b x b) blocklet matmul:

    y[:, rb, r, :] += x[:, cb, (r + d) % nbl, :] @ V[r]^T   for all r

and the products are exactly the kept blocklets' (the arithmetic the
reference's external CUDA kernels exploit).  It covers the collapsed-matmul
case (1x1 convs, the classifier's fc layers).

``tpuseg`` computes this in XLA outside any Pallas kernel, and so does the
port, in PyTorch: ``index_select`` + ``torch.roll`` + ``torch.einsum`` +
``index_add_``.  ``python -m tpuseg_torch.bench_sparse --rmcdb`` times it
against the dense matmul on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RmcdbRollPlan:
    """Per distinct offset d: the (rb, cb) block pairs keeping that diagonal
    and their compact blocklet weights."""

    # offset d -> (rb_idx (Q,) int64, cb_idx (Q,) int64, vals (Q, nbl, b, b))
    per_offset: dict
    bh: int
    bw: int
    b: int
    rows: int
    cols: int
    density: float

    def to(self, device) -> "RmcdbRollPlan":
        return dataclasses.replace(self, per_offset={
            d: tuple(t.to(device) for t in v) for d, v in self.per_offset.items()})


def detect_rmcdb_rolls(
    w: np.ndarray,
    mask: np.ndarray,
    bh: int,
    bw: int,
    b: int,
    dtype: torch.dtype = torch.bfloat16,
) -> RmcdbRollPlan | None:
    """The roll plan of a realized mask: ``w`` and ``mask`` are (rows, cols)
    = (out, in) matrices in the masker's orientation.  Returns None unless
    the blocklet grid is square and the mask is exactly a union of full
    cyclic blocklet diagonals per (bh x bw) block (which every rmcdb mask
    is by construction)."""
    mask = np.asarray(mask)
    rows, cols = mask.shape
    if rows % bh or cols % bw or bh % b or bw % b or bh // b != bw // b:
        return None
    nbl = bh // b
    nrb, ncb = rows // bh, cols // bw
    # a working copy zeroed as diagonals are taken: an extra offset whose
    # slots happen to be covered by other diagonals takes zeros instead of
    # counting weights twice
    wm = np.asarray(w, np.float32) * np.asarray(mask, np.float32)
    per_offset: dict[int, list] = {}
    covered = np.zeros(mask.shape, dtype=bool)
    m = mask != 0
    r_ids = np.arange(nbl)
    for rb in range(nrb):
        for cb in range(ncb):
            blk = m[rb * bh:(rb + 1) * bh, cb * bw:(cb + 1) * bw]
            if not blk.any():
                continue
            occ = blk.reshape(nbl, b, nbl, b).any(axis=(1, 3))  # blocklet occupancy
            for d in range(nbl):
                if not occ[r_ids, (r_ids + d) % nbl].all():
                    continue
                vals = np.zeros((nbl, b, b), np.float32)
                for r in range(nbl):
                    c = (r + d) % nbl
                    sl = (slice(rb * bh + r * b, rb * bh + (r + 1) * b),
                          slice(cb * bw + c * b, cb * bw + (c + 1) * b))
                    vals[r] = wm[sl]
                    wm[sl] = 0.0
                    covered[sl] = True
                per_offset.setdefault(d, []).append((rb, cb, vals))
    if not per_offset or not covered[m].all():
        return None  # live entries outside full cyclic diagonals
    packed = {}
    for d, items in per_offset.items():
        packed[d] = (torch.tensor([it[0] for it in items], dtype=torch.int64),
                     torch.tensor([it[1] for it in items], dtype=torch.int64),
                     torch.from_numpy(np.stack([it[2] for it in items])).to(dtype))
    return RmcdbRollPlan(per_offset=packed, bh=bh, bw=bw, b=b, rows=rows, cols=cols,
                         density=float(m.mean()))


def rmcdb_roll_matmul(x: torch.Tensor, plan: RmcdbRollPlan) -> torch.Tensor:
    """y (P, rows) = x (P, cols) @ (W * mask)^T in x's dtype, by roll +
    batched blocklet einsums (products exactly at the kept diagonals)."""
    if x.dim() != 2 or x.shape[1] != plan.cols:
        raise ValueError(f"x must be (P, {plan.cols}), got {tuple(x.shape)}")
    p = x.shape[0]
    nbl, b = plan.bh // plan.b, plan.b
    xb = x.reshape(p, plan.cols // plan.bw, nbl, b)
    y = torch.zeros((p, plan.rows // plan.bh, nbl, b), dtype=x.dtype, device=x.device)
    for d, (rb_idx, cb_idx, vals) in sorted(plan.per_offset.items()):
        # the Q source blocks, rolled so the kept diagonal is the block diagonal
        xg = torch.roll(xb.index_select(1, cb_idx), -d, dims=2)  # (P, Q, nbl, b)
        contrib = torch.einsum("pqnk,qnik->pqni", xg, vals.to(x.dtype))
        y.index_add_(1, rb_idx, contrib)
    return y.reshape(p, plan.rows)
