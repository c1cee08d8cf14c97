"""Block-sparse (BSR) matmul, ``y (M, N) = W (M, K) @ x (K, N)`` (counterpart
of ``tpuseg/ops/bsr.py``).

W is packed as ``tpuseg`` packs it (``pack_bsr``): dense value tiles
``vals (nnzb, bm, bk)``, one per nonzero block, row-major by row block,
with CSR ``rowptr (nrb + 1,)`` and ``colidx (nnzb,)`` kept as host numpy,
byte for byte ``tpuseg``'s; a block is kept iff its mask has any nonzero.
The port holds int32 device copies of ``rowptr``/``colidx`` beside them.

- ``bsr_matmul_reference``: the plain version (the dense W rebuilt from
  the packing, f32 matmul on the upcast operands).
- ``bsr_matmul`` and ``bsr_matmul_gathered``: the ports of kernels B5
  (``tpuseg.ops.bsr.bsr_matmul``) and B6 (``bsr_matmul_gathered``).  The
  two TPU kernels compute one function and differ only in how a TPU grid
  walks a row's blocks (a sequential grid step per block, or one gathered
  dot); a CUDA block's K loop makes that moot, so on a CUDA tensor both
  launch the hand-written kernel ``tpuseg_torch/csrc/bsr_matmul.cu`` on the
  CSR (bf16 with N % 8 == 0: its TMA + ``wgmma`` path; other N and f32: its
  other paths, chosen by shape), each counted in its own ``launches``; on a
  CPU tensor both run the plain version.  The kernel takes 128x128 blocks
  (``pack_bsr``'s default and every caller's); the plain version any block
  size.
- ``masked_dense_matmul``: the reference's simulated sparsity (dense W x
  0/1 mask), for comparisons.

x is (K, N), channels-major, unlike the port's other kernels; its
contiguity is checked, not assumed.  The result is f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_BLOCK = 128  # the kernel's bm = bk


@dataclasses.dataclass
class BsrWeights:
    """BSR operand: ``tpuseg``'s arrays plus int32 device copies of the CSR."""

    vals: torch.Tensor      # (nnzb, bm, bk)
    rowptr: np.ndarray      # (nrb + 1,) int32
    colidx: np.ndarray      # (nnzb,) int32
    shape: tuple[int, int]  # (M, K) dense shape
    bm: int
    bk: int
    rowptr_t: torch.Tensor | None = None  # rowptr as an int32 tensor on vals' device
    colidx_t: torch.Tensor | None = None  # colidx likewise

    def __post_init__(self):
        if self.rowptr_t is None:
            self.rowptr_t = torch.from_numpy(self.rowptr).to(self.vals.device)
            self.colidx_t = torch.from_numpy(self.colidx).to(self.vals.device)

    @property
    def nrb(self) -> int:
        return self.shape[0] // self.bm

    @property
    def max_nnzb_row(self) -> int:
        return int(np.max(np.diff(self.rowptr))) if len(self.colidx) else 0

    @property
    def block_density(self) -> float:
        total = self.nrb * (self.shape[1] // self.bk)
        return len(self.colidx) / total if total else 1.0

    def to(self, device) -> "BsrWeights":
        """The packing with its tensors on ``device`` (host CSR unchanged)."""
        return dataclasses.replace(self, vals=self.vals.to(device),
                                   rowptr_t=self.rowptr_t.to(device),
                                   colidx_t=self.colidx_t.to(device))


def pack_bsr(w: np.ndarray, mask: np.ndarray, bm: int = 128, bk: int = 128,
             dtype: torch.dtype = torch.bfloat16) -> BsrWeights:
    """Pack a masked dense (M, K) matrix into BSR tiles, ``tpuseg``'s numpy:
    the mask is coarsened to the (bm, bk) grid, a block kept iff it has any
    nonzero mask entry.  A W with no kept block gives ``vals`` of shape
    (0, bm, bk)."""
    w = np.asarray(w)
    mask = np.asarray(mask)
    M, K = w.shape
    if M % bm or K % bk:
        raise ValueError(f"W {w.shape} is not a grid of {bm}x{bk} blocks")
    nrb, ncb = M // bm, K // bk
    wm = (w * mask).reshape(nrb, bm, ncb, bk).transpose(0, 2, 1, 3)
    coarse = mask.reshape(nrb, bm, ncb, bk).transpose(0, 2, 1, 3).reshape(
        nrb, ncb, -1).any(axis=-1)
    rowptr = np.zeros(nrb + 1, dtype=np.int32)
    cols, tiles = [], []
    for i in range(nrb):
        nz = np.flatnonzero(coarse[i])
        cols.extend(nz.tolist())
        tiles.extend(wm[i, j] for j in nz)
        rowptr[i + 1] = rowptr[i] + len(nz)
    vals = np.stack(tiles).astype(np.float32) if tiles else np.zeros((0, bm, bk), np.float32)
    return BsrWeights(vals=torch.from_numpy(vals).to(dtype), rowptr=rowptr,
                      colidx=np.asarray(cols, np.int32), shape=(M, K), bm=bm, bk=bk)


def bsr_dense(bsr: BsrWeights) -> torch.Tensor:
    """The dense (M, K) f32 matrix a packing holds."""
    M, K = bsr.shape
    dense = torch.zeros((M, K), dtype=torch.float32, device=bsr.vals.device)
    vals = bsr.vals.float()
    for i in range(bsr.nrb):
        for b in range(int(bsr.rowptr[i]), int(bsr.rowptr[i + 1])):
            c = int(bsr.colidx[b])
            dense[i * bsr.bm:(i + 1) * bsr.bm, c * bsr.bk:(c + 1) * bsr.bk] = vals[b]
    return dense


def bsr_matmul_reference(bsr: BsrWeights, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B5/B6: ``W @ x`` with W rebuilt from the packing, in
    f32 on the upcast operands (x first cast to the vals dtype, as the
    kernel does)."""
    return bsr_dense(bsr) @ x.to(bsr.vals.dtype).float()


def _check(bsr: BsrWeights, x: torch.Tensor) -> None:
    M, K = bsr.shape
    if x.dim() != 2 or x.shape[0] != K or x.shape[1] < 1:
        raise ValueError(f"x must be (K={K}, N >= 1), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or bsr.vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"x and vals must be float32 or bfloat16, got {x.dtype}, "
                        f"{bsr.vals.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (K, N), N fastest")
    nnzb = len(bsr.colidx)
    tensors = (bsr.vals, bsr.rowptr_t, bsr.colidx_t)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"packing on {bsr.vals.device}, x on {x.device}")
    if (tuple(bsr.vals.shape) != (nnzb, bsr.bm, bsr.bk)
            or tuple(bsr.rowptr_t.shape) != (bsr.nrb + 1,) or tuple(bsr.colidx_t.shape) != (nnzb,)
            or bsr.rowptr_t.dtype != torch.int32 or bsr.colidx_t.dtype != torch.int32
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError("packing does not match its geometry (contiguous vals "
                         f"{(nnzb, bsr.bm, bsr.bk)}, int32 rowptr {(bsr.nrb + 1,)} and "
                         f"colidx {(nnzb,)})")
    if max(x.shape) > 2**31 - 1:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's int sizes")


def _launch(bsr: BsrWeights, x: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/bsr_matmul.cu`` on CUDA ``x`` (checked by the
    caller), cast to the vals dtype; raises if the launch fails."""
    from tpuseg_torch.ops._build import load_library

    x = x.to(bsr.vals.dtype)
    M, K = bsr.shape
    n = x.shape[1]
    y = torch.empty((M, n), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_bsr_matmul(
            bsr.vals.data_ptr(), bsr.rowptr_t.data_ptr(), bsr.colidx_t.data_ptr(),
            x.data_ptr(), y.data_ptr(), M, K, n, len(bsr.colidx), _DTYPE_CODE[bsr.vals.dtype],
            stream)
    if err != 0:
        msg = lib.tpuseg_cuda_error_string(err).decode()
        raise RuntimeError(f"bsr_matmul kernel launch failed: {msg} ({err})")
    return y


def _run(bsr: BsrWeights, x: torch.Tensor, entry) -> torch.Tensor:
    """The plain version on a CPU tensor; on a CUDA tensor one launch of
    ``csrc/bsr_matmul.cu``, counted in ``entry.launches``."""
    _check(bsr, x)
    if x.device.type == "cpu":
        return bsr_matmul_reference(bsr, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (bsr.bm, bsr.bk) != (KERNEL_BLOCK, KERNEL_BLOCK):
        raise ValueError(f"the kernel takes {KERNEL_BLOCK}x{KERNEL_BLOCK} blocks, the packing "
                         f"{bsr.bm}x{bsr.bk}")
    y = _launch(bsr, x)
    entry.launches += 1
    return y


def bsr_matmul(bsr: BsrWeights, x: torch.Tensor) -> torch.Tensor:
    """y (M, N) = W_sparse @ x, x (K, N) -> f32; ``tpuseg``'s ``bsr_matmul``
    (kernel B5) without its ``bn`` tile: any N.  CUDA: one kernel launch,
    counted in ``bsr_matmul.launches``; CPU: the plain version."""
    return _run(bsr, x, bsr_matmul)


def bsr_matmul_gathered(bsr: BsrWeights, x: torch.Tensor) -> torch.Tensor:
    """The same product, ``tpuseg``'s ``bsr_matmul_gathered`` (kernel B6):
    CUDA: one launch of the same kernel on the CSR (its row-padded repack
    was the TPU's way to one dot per row), counted in
    ``bsr_matmul_gathered.launches``; CPU: the plain version."""
    return _run(bsr, x, bsr_matmul_gathered)


bsr_matmul.launches = 0
bsr_matmul_gathered.launches = 0


def masked_dense_matmul(w, mask, x):
    """The reference's simulated-sparsity semantics (dense W x 0/1 mask),
    for correctness comparisons."""
    return (w * mask) @ x
