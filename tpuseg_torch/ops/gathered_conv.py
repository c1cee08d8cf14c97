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

``GatheredGroupConvQ`` (``quantize_gathered_plan``) is the int8 form, with
``tpuseg``'s per-block int8 weights in its HWIO layout.  Its plain version
keeps ``tpuseg``'s structure (quantize the whole x, gather per block, an
exact integer conv, zeros for dead blocks); on the card it runs as ONE
launch of kernel B3 on the equivalent fused packing (``rows`` = the
supports, padded with zero weights; a dead block all zero), which computes
the same integers with the same epilogue.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.weights import hwio_to_oihw_tensor, oihw_to_hwio_np
from tpuseg_torch.ops.sparse_conv import (
    QMAX,
    FusedSparseConvQ,
    dequantize,
    fused_sparse_conv_apply_q,
    int_conv_exact,
    quantize_activation,
)


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


@dataclasses.dataclass
class GatheredGroupConvQ:
    """Int8 gathered plan: ``tpuseg``'s per-block int8 weights and
    per-output-channel scales (``exact``: lists with None for a dead block;
    otherwise one array), plus the equivalent fused packing for B3."""

    idx: "np.ndarray | list"
    w_q: "torch.Tensor | list"      # (nmb, kh, kw, S*bk, bm) int8, or exact: list of (kh, kw, S_j*bk, bm)
    w_scale: "torch.Tensor | list"  # (nmb, bm) f32, or exact: list of (bm,)
    kernel: int
    dilation: int
    bk: int
    bm: int
    s: int
    cin: int
    cout: int
    block_density: float
    x_scale: float | None = None  # static activation scale; None = per frame
    packed: FusedSparseConvQ | None = None
    chan: list = dataclasses.field(default_factory=list)  # per-block channel gathers

    def __post_init__(self):
        if not self.chan:
            self.chan = [_channels(ks) for ks in self.idx]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC float x -> f32 NHWC: the plain version on a CPU tensor, one
        B3 launch on a CUDA tensor."""
        if x.device.type == "cpu":
            return gathered_conv_q_reference(x, self)
        return fused_sparse_conv_apply_q(x, self.packed)

    def to(self, device) -> "GatheredGroupConvQ":
        def mv(v):
            if isinstance(v, list):
                return [None if t is None else t.to(device) for t in v]
            return v.to(device)

        return dataclasses.replace(self, w_q=mv(self.w_q), w_scale=mv(self.w_scale),
                                   packed=self.packed.to(device),
                                   chan=[c.to(device) for c in self.chan])


def gathered_conv_q_reference(x: torch.Tensor, plan: GatheredGroupConvQ) -> torch.Tensor:
    """Plain version, ``tpuseg``'s ``GatheredGroupConvQ.apply``: quantize the
    whole x, then per out-block gather its support channels, the exact
    integer conv and the epilogue; a dead block gives zeros."""
    xq, xs = quantize_activation(x, plan.x_scale)
    outs = []
    for j in range(plan.cout // plan.bm):
        if plan.w_q[j] is None:
            outs.append(torch.zeros(x.shape[:-1] + (plan.bm,), dtype=torch.float32,
                                    device=x.device))
            continue
        acc = int_conv_exact(xq.index_select(3, plan.chan[j]), plan.w_q[j], plan.dilation)
        outs.append(dequantize(acc, xs, plan.w_scale[j]))
    return torch.cat(outs, dim=-1)


def quantize_gathered_plan(plan: GatheredGroupConv,
                           x_scale: float | None = None) -> GatheredGroupConvQ:
    """Per-output-channel symmetric int8 on each block's gathered weight,
    ``tpuseg``'s numpy on the HWIO view of the plan's weights as f32, so
    ``w_q``/``w_scale`` equal ``tpuseg``'s bit for bit.  Also builds the
    equivalent fused packing that B3 runs."""
    k, bk, bm = plan.kernel, plan.bk, plan.bm
    nmb, T = plan.cout // bm, plan.kernel * plan.kernel
    if plan.mode == "exact":
        wq_l: list = []
        ws_l: list = []
        for wj in plan.w:
            if wj is None:
                wq_l.append(None)
                ws_l.append(None)
                continue
            wjf = oihw_to_hwio_np(wj)  # (kh, kw, S_j*bk, bm)
            amax = np.abs(wjf).reshape(-1, wjf.shape[-1]).max(axis=0)
            sc = np.maximum(amax, 1e-8) / 127.0  # (bm,)
            wq_l.append(np.clip(np.round(wjf / sc), -QMAX, QMAX).astype(np.int8))
            ws_l.append(sc.astype(np.float32))
    else:
        w = np.ascontiguousarray(plan.w.detach().cpu().float().numpy().transpose(0, 3, 4, 2, 1))
        absmax = np.abs(w).reshape(w.shape[0], -1, w.shape[-1]).max(axis=1)
        scale = np.maximum(absmax, 1e-8) / 127.0  # (nmb, bm)
        wq = np.clip(np.round(w / scale[:, None, None, None, :]), -QMAX, QMAX).astype(np.int8)
        wq_l, ws_l = list(wq), list(scale.astype(np.float32))
    # the equivalent fused packing: slot s of block j holds in-block idx[j][s];
    # padded slots and dead blocks keep zero weights (and a dead block the
    # scale of an all-zero channel), so they add exact zeros
    S = max(plan.s, 1)
    vals = np.zeros((nmb, T, S, bk, bm), np.int8)
    rows = np.zeros((nmb, S), np.int32)
    wsc = np.full((nmb, 1, bm), np.float32(1e-8) / np.float32(127.0), np.float32)
    for j, ks in enumerate(plan.idx):
        if wq_l[j] is None:
            continue
        wsc[j, 0] = ws_l[j]
        for s_i, kb in enumerate(ks):
            rows[j, s_i] = kb
            vals[j, :, s_i] = wq_l[j][:, :, s_i * bk:(s_i + 1) * bk].reshape(T, bk, bm)
    packed = FusedSparseConvQ(
        vals=torch.from_numpy(vals.reshape(nmb, T * S * bk, bm)),
        w_scale=torch.from_numpy(wsc), rows=torch.from_numpy(rows),
        taps=np.array([(p * plan.dilation, q * plan.dilation)
                       for p in range(k) for q in range(k)], np.int32),
        s=S, bk=bk, bm=bm, kernel=k, dilation=plan.dilation, cin=plan.cin, cout=plan.cout,
        block_density=plan.block_density, x_scale=x_scale)
    if plan.mode == "exact":
        w_q = [None if a is None else torch.from_numpy(a) for a in wq_l]
        w_scale = [None if a is None else torch.from_numpy(a) for a in ws_l]
    else:
        w_q, w_scale = torch.from_numpy(wq), torch.from_numpy(scale.astype(np.float32))
    return GatheredGroupConvQ(
        idx=plan.idx, w_q=w_q, w_scale=w_scale, kernel=k, dilation=plan.dilation, bk=bk,
        bm=bm, s=plan.s, cin=plan.cin, cout=plan.cout, block_density=plan.block_density,
        x_scale=x_scale, packed=packed, chan=list(plan.chan))
