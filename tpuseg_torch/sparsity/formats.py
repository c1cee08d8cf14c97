"""Sparse-matrix text formats (the port's copy of ``tpuseg/sparsity/formats.py``).

The reference exports pruned layers to text files read by its external CUDA
SpMM kernels; these writers reproduce those formats byte for byte (held
against ``tpuseg``'s writers in tests/test_torch_formats.py):

- BSR-like block format (values / indices / rowBlockPtr): the reference's
  BlockPruner.generate_block_matrix + write_block_matrix_to_file
  (pruners/BlockPruner.py:343-432);
- RMB 9-array format: RmbPruner.write_rmb_matrix_to_file
  (pruners/RmbPruner.py:284-378);
- RMCDB format: RmcdbPruner.write_rmcdb_matrix_to_file
  (pruners/RmcdbPruner.py:357-439).

They are interchange only: the port's kernels pack their own tiles from the
masks (``tpuseg_torch.ops``).  numpy only, as in ``tpuseg``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import IO, Iterable, Sequence

import numpy as np

from tpuseg_torch.sparsity.block import block_abs_sums
from tpuseg_torch.sparsity.rmb import Blocklet
from tpuseg_torch.sparsity.rmcdb import CyDiaBlocklet


def write_array(array: Iterable, fh: IO[str]) -> None:
    """pruners/utils.py:3-6 format: space-separated with trailing space."""
    for element in array:
        fh.write(str(element) + " ")
    fh.write("\n")


# --------------------------------------------------------------------------
# BSR block format
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BlockMatrix:
    rows: int
    cols: int
    bh: int
    bw: int
    values: np.ndarray
    indices: np.ndarray
    rowBlockPtr: np.ndarray


def to_block_matrix(mat: np.ndarray, bh: int, bw: int) -> BlockMatrix:
    """Pack nonzero bh x bw blocks in row-major order, values column-major
    within each block (BlockPruner.py:343-413)."""
    assert mat.ndim == 2
    rows, cols = mat.shape
    if bh == 1 and bw == 1:
        rind, cind = np.nonzero(mat)
        nnz = rind.size
        values = mat[rind, cind]
        indices = cind.astype(int)
        rowPtr = np.zeros(rows + 1, dtype=int)
        np.add.at(rowPtr, rind, 1)
        # reference quirk: counts then exclusive-scan of counts[:-1]
        rowPtr[1:] = np.cumsum(rowPtr[:-1])
        rowPtr[0] = 0
        return BlockMatrix(rows, cols, bh, bw, values, indices, rowPtr)

    nrb = -(-rows // bh)
    ncb = -(-cols // bw)
    meta = block_abs_sums(mat, bh, bw)
    nnzb = int(np.count_nonzero(meta))
    values = np.zeros(nnzb * bh * bw, dtype=mat.dtype)
    indices = np.zeros(nnzb, dtype=int)
    rowPtr = np.zeros(nrb + 1, dtype=int)
    block_id = 0
    for rb in range(nrb):
        for cb in range(ncb):
            if meta[rb, cb] != 0:
                indices[block_id] = cb
                rowPtr[rb] += 1
                blk = mat[rb * bh : (rb + 1) * bh, cb * bw : (cb + 1) * bw]
                s = block_id * bh * bw
                values[s : s + bh * bw] = blk.flatten("F")
                block_id += 1
    rowPtr[1:] = np.cumsum(rowPtr[:-1])
    rowPtr[0] = 0
    return BlockMatrix(rows, cols, bh, bw, values, indices, rowPtr)


def write_block_matrix(bm: BlockMatrix, filepath: str) -> None:
    nnzb = bm.rowBlockPtr[-1]
    with open(filepath, "w") as fh:
        fh.write(f"{bm.rows}\n{bm.cols}\n{bm.bh}\n{bm.bw}\n{nnzb}\n")
        write_array(bm.values, fh)
        write_array(bm.indices, fh)
        write_array(bm.rowBlockPtr, fh)


# --------------------------------------------------------------------------
# RMB format
# --------------------------------------------------------------------------


def write_rmb_matrix(
    rows: int,
    cols: int,
    bh: int,
    bw: int,
    blocklets: Sequence[Blocklet],
    filepath: str,
) -> None:
    """Serialize RMB blocklets grouped per global block, row-major
    (RmbPruner.py:246-378)."""
    ncb = cols // bw
    nrb = rows // bh
    order = np.argsort([bl.grb * ncb + bl.gcb for bl in blocklets], kind="stable")
    bls = [blocklets[i] for i in order]
    mbl_ids = np.array([bl.grb * ncb + bl.gcb for bl in bls], dtype=int)
    uniq, counts = np.unique(mbl_ids, return_counts=True)
    bl_ptr = np.concatenate([[0], np.cumsum(counts)])

    nnzb = uniq.size
    indices = uniq % ncb
    rowBlockPtr = np.zeros(nrb + 1, dtype=int)
    np.add.at(rowBlockPtr, uniq // ncb, 1)
    rowBlockPtr[1:] = np.cumsum(rowBlockPtr[:-1])
    rowBlockPtr[0] = 0

    num_blets = len(bls)
    nnz = sum(bl.values.size for bl in bls)
    num_indices = sum(bl.indices.size for bl in bls)

    row_patterns = np.array(
        [int(round(math.log2(bl.block_bh // bl.bh))) for bl in bls], dtype=int
    )
    col_patterns = np.array(
        [int(round(math.log2(bl.block_bw // bl.bw))) for bl in bls], dtype=int
    )

    valPtr = np.zeros(nnzb + 1, dtype=int)
    indPtr = np.zeros(nnzb + 1, dtype=int)
    bletPtr = np.zeros(nnzb + 1, dtype=int)
    for i in range(nnzb):
        group = bls[bl_ptr[i] : bl_ptr[i + 1]]
        valPtr[i] = sum(b.values.size for b in group)
        indPtr[i] = sum(b.indices.size for b in group)
        bletPtr[i] = len(group)
    for arr in (valPtr, indPtr, bletPtr):
        arr[1:] = np.cumsum(arr[:-1])
        arr[0] = 0

    values = np.zeros(nnz)
    l_indices = np.zeros(num_indices, dtype=int)
    vi = ii = 0
    for bl in bls:
        values[vi : vi + bl.values.size] = bl.values.flatten("F")
        l_indices[ii : ii + bl.indices.size] = bl.indices.flatten("F")
        vi += bl.values.size
        ii += bl.indices.size

    with open(filepath, "w") as fh:
        fh.write(
            f"{rows}\n{cols}\n{bh}\n{bw}\n{nnz}\n{nnzb}\n{num_blets}\n{num_indices}\n"
        )
        write_array(values, fh)
        write_array(indices, fh)
        write_array(rowBlockPtr, fh)
        write_array(row_patterns, fh)
        write_array(col_patterns, fh)
        write_array(l_indices, fh)
        write_array(valPtr, fh)
        write_array(indPtr, fh)
        write_array(bletPtr, fh)


# --------------------------------------------------------------------------
# RMCDB format
# --------------------------------------------------------------------------


def write_rmcdb_matrix(
    rows: int,
    cols: int,
    bh: int,
    bw: int,
    blocklets: Sequence[CyDiaBlocklet],
    filepath: str,
) -> None:
    """Serialize cyclic-diagonal blocklets (RmcdbPruner.py:319-439)."""
    ncb = cols // bw
    nrb = rows // bh
    order = np.argsort([bl.grb * ncb + bl.gcb for bl in blocklets], kind="stable")
    bls = [blocklets[i] for i in order]
    mbl_ids = np.array([bl.grb * ncb + bl.gcb for bl in bls], dtype=int)
    uniq, counts = np.unique(mbl_ids, return_counts=True)
    bl_ptr = np.concatenate([[0], np.cumsum(counts)])

    nnzb = uniq.size
    indices = uniq % ncb
    rowBlockPtr = np.zeros(nrb + 1, dtype=int)
    np.add.at(rowBlockPtr, uniq // ncb, 1)
    rowBlockPtr[1:] = np.cumsum(rowBlockPtr[:-1])
    rowBlockPtr[0] = 0

    num_blets = len(bls)
    nnz = sum(bl.values.size for bl in bls)
    row_patterns = np.array([bl.bh for bl in bls], dtype=int)
    col_patterns = np.array([bl.bw for bl in bls], dtype=int)

    valPtr = np.zeros(nnzb + 1, dtype=int)
    bletPtr = np.zeros(nnzb + 1, dtype=int)
    for i in range(nnzb):
        group = bls[bl_ptr[i] : bl_ptr[i + 1]]
        valPtr[i] = sum(b.values.size for b in group)
        bletPtr[i] = len(group)
    for arr in (valPtr, bletPtr):
        arr[1:] = np.cumsum(arr[:-1])
        arr[0] = 0

    values = np.zeros(nnz)
    offsets = np.zeros(num_blets, dtype=int)
    vi = 0
    for i, bl in enumerate(bls):
        values[vi : vi + bl.values.size] = bl.values.flatten("F")
        offsets[i] = bl.offset
        vi += bl.values.size

    with open(filepath, "w") as fh:
        fh.write(f"{rows}\n{cols}\n{bh}\n{bw}\n{nnz}\n{nnzb}\n{num_blets}\n")
        write_array(values, fh)
        write_array(indices, fh)
        write_array(rowBlockPtr, fh)
        write_array(row_patterns, fh)
        write_array(col_patterns, fh)
        write_array(offsets, fh)
        write_array(valPtr, fh)
        write_array(bletPtr, fh)
