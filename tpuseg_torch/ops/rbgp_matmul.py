"""RBGP structured-mask lowerings (counterpart of ``tpuseg/ops/rbgp_matmul.py``).

An SRMBRep mask with ``is_repetitive=True`` is a small pattern ``P`` tiled
periodically over the collapsed (cout x cin*k*k) weight matrix.
``plan_rbgp`` detects that structure on the mask and picks a lowering:

- ``column_compact``: input channels dead in every tap are sliced away and
  the conv runs dense at reduced cin;
- ``tap_compact``: each tap has its own dead channels; the conv becomes a
  sum of shifted compact 1x1 matmuls;
- ``grouped_conv``: the (cout x cin) support is block-diagonal after a
  residue-class permutation -> a grouped conv;
- ``dense``: anything else (the caller keeps the dense conv).

The decisions and the ``note`` strings are ``tpuseg``'s, computed by the
same numpy code on the HWIO view of the mask, so ``build_sparse_plans``
reports identical strings.  Plan weights are OIHW tensors (the port's conv
layout); ``rbgp_conv_apply`` takes and returns NHWC like ``tpuseg``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.weights import hwio_to_oihw_tensor, oihw_to_hwio_np

# a compact lowering must skip at least this share of the conv's inputs
MIN_SAVINGS = 0.10


def _min_period(arr: np.ndarray, axis: int) -> int:
    """Smallest divisor p of arr.shape[axis] such that arr is p-periodic."""
    n = arr.shape[axis]
    m = np.moveaxis(arr, axis, 0).reshape(n, -1)
    for p in sorted(d for d in range(1, n + 1) if n % d == 0):
        tiles = m.reshape(n // p, p, -1)
        if (tiles == tiles[:1]).all():
            return p
    return n


@dataclasses.dataclass(frozen=True)
class RbgpStructure:
    """Periodic structure of a collapsed mask: mask = tile(P)."""

    pattern: np.ndarray  # (pr, pc) 0/1
    pr: int
    pc: int
    row_degree: int
    density: float


def detect_structure(mask_oik: np.ndarray) -> RbgpStructure | None:
    """Periodic structure of a (cout, cin*k*k) 0/1 mask in torch collapse
    order, or None when it has no non-trivial period."""
    m = np.asarray(mask_oik)
    if m.ndim != 2 or not m.size:
        return None
    mb = (m != 0).astype(np.int8)
    pr = _min_period(mb, 0)
    pc = _min_period(mb, 1)
    if pr == mb.shape[0] and pc == mb.shape[1]:
        return None
    P = mb[:pr, :pc].astype(np.float32)
    return RbgpStructure(pattern=P, pr=pr, pc=pc,
                         row_degree=int(P.sum(1).max()), density=float(P.mean()))


@dataclasses.dataclass
class RbgpPlan:
    kind: str                                # dense | column_compact | tap_compact | grouped_conv
    note: str
    live_in: torch.Tensor | None = None      # column_compact: input channel idx (int64)
    weights: object = None                   # OIHW tensor, or tap_compact: list of (live, cout)
    groups: int = 1
    perm_in: torch.Tensor | None = None      # grouped_conv: residue-class gather
    perm_out: torch.Tensor | None = None     # grouped_conv: output scatter
    taps: list | None = None                 # tap_compact: [(dy, dx, live idx tensor)]

    def to(self, device) -> "RbgpPlan":
        """The plan with every tensor on ``device`` (dtypes unchanged)."""
        def mv(v):
            return None if v is None else v.to(device)

        return dataclasses.replace(
            self,
            live_in=mv(self.live_in),
            weights=([mv(w) for w in self.weights] if isinstance(self.weights, list)
                     else mv(self.weights)),
            perm_in=mv(self.perm_in),
            perm_out=mv(self.perm_out),
            taps=(None if self.taps is None
                  else [(dy, dx, mv(live)) for dy, dx, live in self.taps]),
        )


def _collapse_hwio(mask_hwio: np.ndarray) -> np.ndarray:
    kh, kw, cin, cout = mask_hwio.shape
    return (np.transpose(mask_hwio, (3, 2, 0, 1)).reshape(cout, cin * kh * kw) != 0
            ).astype(np.float32)


def _index(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


def plan_rbgp(w_oihw, mask_oihw, dtype: torch.dtype = torch.bfloat16) -> RbgpPlan:
    """The lowering for a structured mask (``tpuseg``'s rules, in its
    order).  ``kind='dense'`` means "run the masked conv densely"."""
    mask_hwio = oihw_to_hwio_np(mask_oihw)
    w = oihw_to_hwio_np(w_oihw) * mask_hwio
    kh, kw, cin, cout = w.shape

    ch_alive = np.abs(mask_hwio).sum(axis=(0, 1, 3)) != 0
    n_live = int(ch_alive.sum())
    if 0 < n_live <= cin * (1.0 - MIN_SAVINGS):
        live = np.nonzero(ch_alive)[0].astype(np.int32)
        return RbgpPlan(
            kind="column_compact",
            note=f"dead input channels: {cin - n_live}/{cin}",
            live_in=_index(live),
            weights=hwio_to_oihw_tensor(w[:, :, live, :], dtype),
        )

    tap_alive = np.abs(mask_hwio).sum(axis=3) != 0  # (kh, kw, cin)
    worst_live = tap_alive.reshape(kh * kw, cin).sum(1).max() / cin
    if 0 < worst_live <= 1.0 - MIN_SAVINGS and (kh, kw) != (1, 1):
        taps, wpack = [], []
        for dy in range(kh):
            for dx in range(kw):
                live = np.nonzero(tap_alive[dy, dx])[0].astype(np.int32)
                taps.append((dy, dx, _index(live)))
                wpack.append(torch.from_numpy(np.ascontiguousarray(w[dy, dx][live, :])).to(dtype))
        return RbgpPlan(kind="tap_compact", note=f"per-tap live fraction {worst_live:.2f}",
                        weights=wpack, taps=taps)

    support = np.abs(mask_hwio).sum(axis=(0, 1)) != 0  # (cin, cout)
    sdet = detect_structure(support.T.astype(np.float32))
    if sdet is not None:
        P, pr, pc = sdet.pattern, sdet.pr, sdet.pc
        g = _blockdiag_groups(P)
        if g is not None and g > 1 and cin % pc == 0 and cout % pr == 0:
            sh, sw = pr // g, pc // g
            ib = (np.arange(cin) % pc) // sw
            ob = (np.arange(cout) % pr) // sh
            perm_in = np.argsort(ib, kind="stable").astype(np.int32)
            perm_out_fwd = np.argsort(ob, kind="stable").astype(np.int32)
            perm_out = np.argsort(perm_out_fwd).astype(np.int32)
            wp = w[:, :, perm_in][:, :, :, perm_out_fwd]
            bi, bo = cin // g, cout // g
            wg = np.concatenate([wp[:, :, i * bi:(i + 1) * bi, i * bo:(i + 1) * bo]
                                 for i in range(g)], axis=3)
            return RbgpPlan(
                kind="grouped_conv",
                note=f"block-diagonal after residue permutation, {g} groups",
                weights=hwio_to_oihw_tensor(wg, dtype),
                groups=g,
                perm_in=_index(perm_in),
                perm_out=_index(perm_out),
            )

    s = detect_structure(_collapse_hwio(mask_hwio))
    if s is not None:
        return RbgpPlan(
            kind="dense",
            note=(f"periodic P {s.pr}x{s.pc} density {s.density:.2f}: "
                  "expander pattern -> dense is MXU-optimal (measured; "
                  "see module docstring)"),
        )
    return RbgpPlan(kind="dense", note="no exploitable structure")


def _blockdiag_groups(P: np.ndarray) -> int | None:
    """Largest G > 1 such that P is block-diagonal with G equal blocks."""
    pr, pc = P.shape
    for g in range(min(pr, pc), 1, -1):
        if pr % g or pc % g:
            continue
        sh, sw = pr // g, pc // g
        blocks = P.reshape(g, sh, g, sw)
        off = blocks.sum() - sum(blocks[i, :, i, :].sum() for i in range(g))
        if off == 0:
            return g
    return None


def rbgp_conv_apply(x: torch.Tensor, plan: RbgpPlan, stride: int = 1, dilation: int = 1,
                    padding: int | None = None) -> torch.Tensor:
    """Run a compact/grouped plan on NHWC ``x``; NHWC result in x's dtype
    (``tap_compact`` is stride-1 'same' and sums its taps in f32)."""
    if plan.kind == "tap_compact":
        assert stride == 1, "tap_compact lowers stride-1 convs"
        kh = max(dy for dy, _, _ in plan.taps) + 1
        pad = dilation * (kh - 1) // 2 if padding is None else padding
        n, h, w_, _ = x.shape
        xp = F.pad(x, (0, 0, pad, pad, pad, pad))
        out = None
        for (dy, dx, live), wt in zip(plan.taps, plan.weights):
            sh = xp[:, dy * dilation:dy * dilation + h, dx * dilation:dx * dilation + w_]
            sh = sh.index_select(3, live)
            y = torch.matmul(sh.float(), wt.to(sh.dtype).float())
            out = y if out is None else out + y
        return out.to(x.dtype)

    w = plan.weights
    assert w is not None, "dense plans execute on the standard path"
    w = w.to(x.dtype)
    if padding is None:
        padding = dilation * (w.shape[-1] - 1) // 2
    if plan.kind == "column_compact":
        xs = x.index_select(3, plan.live_in).permute(0, 3, 1, 2)
        return F.conv2d(xs, w, None, stride, padding, dilation).permute(0, 2, 3, 1)
    if plan.kind == "grouped_conv":
        xs = x.index_select(3, plan.perm_in).permute(0, 3, 1, 2)
        y = F.conv2d(xs, w, None, stride, padding, dilation, plan.groups)
        return y.permute(0, 2, 3, 1).index_select(3, plan.perm_out)
    raise ValueError(plan.kind)
