"""ctypes bindings of the native C++ sparsity library (the port's copy of
``tpuseg/native.py``, on ``native/sparsity.cpp``).

The library speeds up host-side mask generation and BSR packing; each entry
point equals the numpy code of ``tpuseg_torch.sparsity`` (held in
tests/test_torch_native_sparsity.py).  Unlike ``tpuseg``, which loads
``native/libtpuseg_sparsity.so`` when it exists and else falls back to numpy
silently, the port builds its own copy at first use
(``tpuseg_torch.native_build.build_sparsity``: ``g++`` into
``tpuseg_torch/_build/``, keyed by a hash of the source and command) and a
failed build raises ``RuntimeError`` with ``g++``'s output.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tpuseg_torch.native_build import build_sparsity


@functools.cache
def lib() -> ctypes.CDLL:
    """The built library, its argument types declared; built and loaded
    once a process."""
    L = ctypes.CDLL(build_sparsity())
    i64 = ctypes.c_int64
    f64 = ctypes.c_double

    def arr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C")

    L.block_abs_sums.argtypes = [arr(np.float32), i64, i64, i64, i64, arr(np.float64)]
    L.block_abs_sums.restype = None
    L.prune_block_mask.argtypes = [arr(np.float32), i64, i64, i64, i64, f64, arr(np.float32)]
    L.prune_block_mask.restype = None
    L.rmb_prune.argtypes = [arr(np.float32), i64, i64, i64, i64, f64, arr(np.int64),
                            arr(np.int64), arr(np.int64), i64, arr(np.float32)]
    L.rmb_prune.restype = None
    L.bsr_pack.argtypes = [arr(np.float32), i64, i64, i64, i64, arr(np.int32), arr(np.int32),
                           arr(np.float32)]
    L.bsr_pack.restype = i64
    return L


def so_path() -> str:
    """The file the loaded library came from."""
    return lib()._name


def _matrix(mat: np.ndarray) -> np.ndarray:
    mat = np.ascontiguousarray(mat, np.float32)
    if mat.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {mat.shape}")
    return mat


def _blocks(bh: int, bw: int) -> None:
    if bh < 1 or bw < 1:
        raise ValueError(f"block sizes must be positive, got {bh}x{bw}")


def block_abs_sums(mat: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(ceil(rows/bh), ceil(cols/bw)) float64 sums of |mat| per block
    (``sparsity.block.block_abs_sums``)."""
    mat = _matrix(mat)
    _blocks(bh, bw)
    rows, cols = mat.shape
    out = np.zeros((-(-rows // bh), -(-cols // bw)), np.float64)
    lib().block_abs_sums(mat, rows, cols, bh, bw, out)
    return out


def prune_block_mask(mat: np.ndarray, bh: int, bw: int, sparsity: float) -> np.ndarray:
    """The magnitude BlockPruner mask of ``mat`` (float32 0/1), as
    ``sparsity.block.prune_as_block`` with collapsed tensors."""
    mat = _matrix(mat)
    _blocks(bh, bw)
    rows, cols = mat.shape
    mask = np.zeros((rows, cols), np.float32)
    lib().prune_block_mask(mat, rows, cols, bh, bw, sparsity, mask)
    return mask


def rmb_prune(mat: np.ndarray, bh: int, bw: int, spo: float, bl_types,
              bl_counts) -> np.ndarray:
    """The RMB mask of ``mat`` (float32 0/1), as ``sparsity.rmb.prune_as_rmb``."""
    m = _matrix(mat).copy()  # the library zeroes claimed blocklets in place
    rows, cols = m.shape
    if bh < 1 or bw < 1 or rows % bh or cols % bw:
        raise ValueError(f"RMB blocks {bh}x{bw} must divide the {rows}x{cols} matrix")
    if len(bl_types) != len(bl_counts):
        raise ValueError("one count per blocklet type")
    for t in bl_types:
        if t.bh < 1 or t.bw < 1 or bh % t.bh or bw % t.bw:
            raise ValueError(f"blocklet {t.bh}x{t.bw} must divide the {bh}x{bw} block")
    mask = np.zeros((rows, cols), np.float32)
    bh_arr = np.asarray([t.bh for t in bl_types], np.int64)
    bw_arr = np.asarray([t.bw for t in bl_types], np.int64)
    cnt = np.asarray(bl_counts, np.int64)
    lib().rmb_prune(m, rows, cols, bh, bw, spo, bh_arr, bw_arr, cnt, len(bl_types), mask)
    return mask


def bsr_pack(wm: np.ndarray, bm: int, bk: int):
    """``(vals (nnzb, bm, bk) f32, rowptr (rows/bm + 1,) i32, colidx (nnzb,)
    i32)``: the nonzero bm x bk blocks of ``wm`` in row-major order."""
    wm = _matrix(wm)
    _blocks(bm, bk)
    rows, cols = wm.shape
    if rows % bm or cols % bk:
        raise ValueError(f"BSR blocks {bm}x{bk} must divide the {rows}x{cols} matrix")
    nrb, ncb = rows // bm, cols // bk
    rowptr = np.zeros(nrb + 1, np.int32)
    colidx = np.zeros(nrb * ncb, np.int32)
    vals = np.zeros((nrb * ncb, bm, bk), np.float32)
    nnzb = lib().bsr_pack(wm, rows, cols, bm, bk, rowptr, colidx, vals.reshape(-1))
    return vals[:nnzb], rowptr, colidx[:nnzb]
