"""Fused block-sparse convolution (counterpart of ``tpuseg/ops/sparse_conv.py``
``FusedSparseConv`` / ``plan_fused_sparse_conv`` / ``fused_sparse_conv_apply``).

A masked stride-1 'same' k x k conv with dilation d is packed per
128-channel output block ``jb``: the union over the T = k*k taps of the
input 128-channel blocks with any nonzero weight is the block's support,
padded to the layer's largest support S by repeating ``rows[jb, 0]`` with
zero weights.  The packing is ``tpuseg``'s, value for value:

    rows (nmb, S) int32        support block ids per out-block
    vals (nmb, T*S*128, 128)   weights, row (t*S + s)*128 + c, column m

and the conv is

    y[n, i, j, jb*128 + m] = sum_t sum_s sum_c
        x[n, i + dy_t - pad, j + dx_t - pad, rows[jb, s]*128 + c]
        * vals[jb, (t*S + s)*128 + c, m]

with pad = d*(k-1)/2, taps (dy_t, dx_t) = (p*d, q*d) for t = p*k + q, x
zero outside the image, x cast to the vals dtype, f32 accumulation and an
f32 (N, H, W, Cout) result.

- ``fused_sparse_conv_reference``: the plain version (per out-block channel
  gather + dense ``F.conv2d`` in f32 on the upcast operands).
- ``fused_sparse_conv_apply``: the serving entry point.  On a CUDA tensor
  it launches the hand-written kernel ``tpuseg_torch/csrc/sparse_conv.cu``
  (the port of ``tpuseg.ops.sparse_conv.fused_sparse_conv_apply``); on a
  CPU tensor it runs the plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.weights import oihw_to_hwio_np

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BK = BM = 128  # channel block sizes (in, out), the kernel's


@dataclasses.dataclass
class FusedSparseConv:
    """Packed operand of the fused block-sparse conv."""

    vals: torch.Tensor  # (nmb, T*S*bk, bm), the plan dtype
    rows: torch.Tensor  # (nmb, S) int32 K-block index per support slot
    taps: np.ndarray    # (T, 2) (dy, dx) offsets into the padded input
    s: int
    bk: int
    bm: int
    kernel: int
    dilation: int
    cin: int
    cout: int
    block_density: float
    rows_per_tile: int = 8  # tpuseg's TPU row tile, kept as a field; nothing reads it

    def to(self, device) -> "FusedSparseConv":
        """The plan with ``vals``/``rows`` on ``device`` (dtype unchanged)."""
        return dataclasses.replace(self, vals=self.vals.to(device), rows=self.rows.to(device))


def plan_fused_sparse_conv(
    w_oihw,
    mask_oihw,
    dilation: int = 1,
    dtype: torch.dtype = torch.bfloat16,
) -> FusedSparseConv:
    """Pack a masked stride-1 conv (OIHW weight and mask, tensors or numpy)
    for the fused kernel: ``tpuseg``'s numpy packing on the HWIO view, so
    ``rows``/``vals`` equal ``tpuseg``'s bit for bit."""
    wm = oihw_to_hwio_np(w_oihw) * oihw_to_hwio_np(mask_oihw)
    kh, kw, cin, cout = wm.shape
    bk, bm = BK, BM
    assert cin % bk == 0 and cout % bm == 0
    nkb, nmb = cin // bk, cout // bm
    T = kh * kw
    nz = np.zeros((nmb, T, nkb), bool)
    for t in range(T):
        p, q = divmod(t, kw)
        blocks = wm[p, q].reshape(nkb, bk, nmb, bm)
        nz[:, t, :] = (np.abs(blocks).sum(axis=(1, 3)) > 0).T
    union = nz.any(axis=1)  # (nmb, nkb)
    S = max(int(union.sum(axis=1).max()), 1)
    vals = np.zeros((nmb, T, S, bk, bm), np.float32)
    rows = np.zeros((nmb, S), np.int32)
    for j in range(nmb):
        for s_i, k in enumerate(np.flatnonzero(union[j])):
            rows[j, s_i] = k
            for t in range(T):
                p, q = divmod(t, kw)
                if nz[j, t, k]:
                    vals[j, t, s_i] = wm[p, q][k * bk:(k + 1) * bk, j * bm:(j + 1) * bm]
    taps = np.array([(p * dilation, q * dilation) for p in range(kh) for q in range(kw)],
                    np.int32)
    return FusedSparseConv(
        vals=torch.from_numpy(vals.reshape(nmb, T * S * bk, bm)).to(dtype),
        rows=torch.from_numpy(rows),
        taps=taps,
        s=S,
        bk=bk,
        bm=bm,
        kernel=kh,
        dilation=dilation,
        cin=cin,
        cout=cout,
        block_density=float(union.mean()),
    )


def fused_sparse_conv_reference(x: torch.Tensor, plan: FusedSparseConv) -> torch.Tensor:
    """Plain version: for each out-block, gather its support channels,
    rebuild the dense (bm, S*bk, k, k) weight from ``vals`` and run
    ``F.conv2d`` in f32 on the upcast operands (x first cast to the vals
    dtype, as the kernel does).  NHWC in, f32 NHWC out."""
    k, S, bk, bm = plan.kernel, plan.s, plan.bk, plan.bm
    pad = plan.dilation * (k - 1) // 2
    xin = x.to(plan.vals.dtype).float()
    rows = plan.rows.to(device=x.device, dtype=torch.int64)
    chan = (rows[:, :, None] * bk + torch.arange(bk, device=x.device)).reshape(rows.shape[0], -1)
    outs = []
    for jb in range(plan.cout // bm):
        xg = xin.index_select(3, chan[jb]).permute(0, 3, 1, 2)
        wj = plan.vals[jb].float().reshape(k, k, S * bk, bm).permute(3, 2, 0, 1)
        outs.append(F.conv2d(xg, wj, None, 1, pad, plan.dilation))
    return torch.cat(outs, dim=1).permute(0, 2, 3, 1).contiguous()


def _check(x: torch.Tensor, plan: FusedSparseConv) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if plan.vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"plan vals must be float32 or bfloat16, got {plan.vals.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    if x.shape[3] != plan.cin:
        raise ValueError(f"x has {x.shape[3]} channels, the plan {plan.cin}")
    if plan.vals.device != x.device or plan.rows.device != x.device:
        raise ValueError(f"plan on {plan.vals.device}, x on {x.device}")
    nmb, T = plan.cout // plan.bm, plan.kernel * plan.kernel
    if (tuple(plan.vals.shape) != (nmb, T * plan.s * plan.bk, plan.bm)
            or tuple(plan.rows.shape) != (nmb, plan.s) or plan.rows.dtype != torch.int32
            or not (plan.vals.is_contiguous() and plan.rows.is_contiguous())):
        raise ValueError("plan vals/rows do not match its geometry (contiguous "
                         f"{(nmb, T * plan.s * plan.bk, plan.bm)} and int32 {(nmb, plan.s)})")
    if plan.kernel % 2 == 0:
        raise ValueError(f"'same' padding needs an odd kernel, got {plan.kernel}")
    if max(x.shape) > 2**31 - 1:
        # the kernel takes C ints; it checks its own grid and shared-memory
        # limits and returns an error the wrapper raises
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's int sizes")


def fused_sparse_conv_apply(x: torch.Tensor, plan: FusedSparseConv) -> torch.Tensor:
    """Stride-1 'same' block-sparse conv of NHWC-contiguous ``x`` -> f32
    (N, H, W, Cout).

    On a CUDA tensor this casts x to the plan's dtype, launches the CUDA
    kernel on the current stream, counts the launch in
    ``fused_sparse_conv_apply.launches`` and raises if the launch fails; on
    a CPU tensor it runs ``fused_sparse_conv_reference``.  Nothing falls
    back: A/B checks call ``fused_sparse_conv_reference`` by name."""
    _check(x, plan)
    if x.device.type == "cpu":
        return fused_sparse_conv_reference(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from tpuseg_torch.ops._build import load_library

    x = x.to(plan.vals.dtype)
    n, h, w, cin = x.shape
    out = torch.empty((n, h, w, plan.cout), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_sparse_conv(
            x.data_ptr(), plan.vals.data_ptr(), plan.rows.data_ptr(), out.data_ptr(),
            n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation,
            _DTYPE_CODE[plan.vals.dtype], stream,
        )
    if err != 0:
        msg = lib.tpuseg_cuda_error_string(err).decode()
        raise RuntimeError(f"sparse_conv kernel launch failed: {msg} ({err})")
    fused_sparse_conv_apply.launches += 1
    return out


fused_sparse_conv_apply.launches = 0
