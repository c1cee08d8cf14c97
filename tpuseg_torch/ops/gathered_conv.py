"""Block-sparse conv as channel gather + small dense convs (counterpart of
``tpuseg/ops/gathered_conv.py``, float modes).

Per output-channel block j with input 128-channel block support
{k_1..k_S}:

    y[..., j*bm:(j+1)*bm] = conv(x[..., gather(k_1..k_S)], W_j)

The gather is an ``index_select`` over the NHWC channel axis (its result is
NHWC-contiguous, so the conv sees a channels_last input) and each per-block
conv is ``F.conv2d`` (cuDNN on the card), as ``tpuseg`` leaves them to XLA.

Modes, as in ``tpuseg``:
- ``exact``: block j takes exactly its own S_j gathered blocks; a block with
  no support emits zeros with no conv;
- ``split``: supports repeat-padded (with zero weights) to the layer's max S;
- ``grouped``: one grouped conv over the concatenated gathers.

Weights are OIHW: ``exact`` keeps a list of (bm, S_j*bk, k, k) tensors (None
for a dead block), ``split``/``grouped`` one (nmb, bm, S*bk, k, k) tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.weights import hwio_to_oihw_tensor, oihw_to_hwio_np


BK = BM = 128  # channel block sizes (in, out)


def _channels(blocks) -> torch.Tensor:
    """Channel indices of 128-channel blocks ``blocks``, in order."""
    b = np.asarray(blocks, np.int64)
    return torch.from_numpy((b[:, None] * BK + np.arange(BK)).reshape(-1))


@dataclasses.dataclass
class GatheredGroupConv:
    """Per-out-block gathered dense weights (see the module docstring)."""

    idx: "np.ndarray | list"      # (nmb, S) int32, or exact: list of (S_j,)
    w: "torch.Tensor | list"      # (nmb, bm, S*bk, k, k), or exact: list (None when S_j == 0)
    kernel: int
    dilation: int
    bk: int
    bm: int
    s: int                        # max per-block support (exact: max S_j)
    cin: int
    cout: int
    block_density: float
    mode: str = "split"           # "split" | "grouped" | "exact"
    chan: list = dataclasses.field(default_factory=list)  # per-block channel gathers

    def __post_init__(self):
        if not self.chan:
            self.chan = [_channels(ks) for ks in self.idx]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return gathered_conv_apply(x, self)

    def to(self, device) -> "GatheredGroupConv":
        """The plan with every tensor on ``device`` (dtypes unchanged)."""
        w = ([None if wj is None else wj.to(device) for wj in self.w]
             if isinstance(self.w, list) else self.w.to(device))
        return dataclasses.replace(self, w=w, chan=[c.to(device) for c in self.chan])


def plan_gathered_conv(
    w_oihw,
    mask_oihw,
    dilation: int = 1,
    dtype: torch.dtype = torch.bfloat16,
    mode: str = "split",
) -> GatheredGroupConv:
    """Pack a masked stride-1 conv (OIHW weight and mask) for the gathered
    lowering; supports are ``tpuseg``'s (the union over taps of nonzero
    K-blocks per out-block)."""
    if mode not in ("split", "grouped", "exact"):
        raise ValueError(f"unknown gathered mode: {mode}")
    wm = oihw_to_hwio_np(w_oihw) * oihw_to_hwio_np(mask_oihw)
    kh, kw, cin, cout = wm.shape
    bk, bm = BK, BM
    assert kh == kw
    assert cin % bk == 0 and cout % bm == 0
    nkb, nmb = cin // bk, cout // bm
    blocks = wm.reshape(kh, kw, nkb, bk, nmb, bm)
    nz = np.abs(blocks).sum(axis=(0, 1, 3, 5)) > 0  # (nkb, nmb)
    common = dict(kernel=kh, dilation=dilation, bk=bk, bm=bm, cin=cin, cout=cout,
                  block_density=float(nz.mean()), mode=mode)
    if mode == "exact":
        idx_l, w_l = [], []
        for j in range(nmb):
            ks = np.flatnonzero(nz[:, j]).astype(np.int32)
            idx_l.append(ks)
            if ks.size:
                wj = np.concatenate([blocks[:, :, k, :, j, :] for k in ks], axis=2)
                w_l.append(hwio_to_oihw_tensor(wj, dtype))
            else:
                w_l.append(None)
        return GatheredGroupConv(idx=idx_l, w=w_l, s=max(int(nz.sum(axis=0).max()), 0),
                                 **common)
    S = max(int(nz.sum(axis=0).max()), 1)
    idx = np.zeros((nmb, S), np.int32)
    w_g = np.zeros((nmb, kh, kw, S * bk, bm), np.float32)
    for j in range(nmb):
        for s_i, k in enumerate(np.flatnonzero(nz[:, j])):
            idx[j, s_i] = k
            w_g[j, :, :, s_i * bk:(s_i + 1) * bk, :] = blocks[:, :, k, :, j, :]
    w_t = torch.from_numpy(np.ascontiguousarray(w_g.transpose(0, 4, 3, 1, 2))).to(dtype)
    return GatheredGroupConv(idx=idx, w=w_t, s=S, **common)


def gathered_conv_apply(x: torch.Tensor, plan: GatheredGroupConv) -> torch.Tensor:
    """Stride-1 'same' sparse conv of NHWC ``x`` by channel gather + dense
    convs; NHWC result in x's dtype (callers cast as they do for dense)."""
    nmb, bm = plan.cout // plan.bm, plan.bm
    pad = plan.dilation * (plan.kernel - 1) // 2

    def conv(xg, w, groups=1):
        y = F.conv2d(xg.permute(0, 3, 1, 2), w.to(x.dtype), None, 1, pad, plan.dilation, groups)
        return y.permute(0, 2, 3, 1)

    if plan.mode == "exact":
        outs = []
        for j in range(nmb):
            if plan.w[j] is None:
                # whole out-block masked away: its conv output is exactly zero
                outs.append(x.new_zeros(x.shape[:-1] + (bm,)))
                continue
            outs.append(conv(x.index_select(3, plan.chan[j]), plan.w[j]))
        return torch.cat(outs, dim=-1)
    if plan.mode == "grouped":
        xg = x.index_select(3, torch.cat(plan.chan))
        w = plan.w.reshape(nmb * bm, plan.s * plan.bk, plan.kernel, plan.kernel)
        return conv(xg, w, groups=nmb)
    return torch.cat([conv(x.index_select(3, plan.chan[j]), plan.w[j]) for j in range(nmb)],
                     dim=-1)
