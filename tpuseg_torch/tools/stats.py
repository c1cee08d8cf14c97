"""Checkpoint / model statistics (the port's copy of ``tpuseg/tools/stats.py``).

Behavioral reference:
- the reference's tools/get_sparsity_stats.py:15-61: per-layer overall /
  filter / channel / row / col sparsity of a checkpoint's weights, and
  optionally their block-level occupancy;
- tools/get_matrix_shapes.py:7-64: per-conv GEMM shapes (M, K, N) and
  FLOPs (forward hooks in the reference; here from the static spec).

The port stores conv weights OIHW, the reference's view, so no transpose
is needed; 2-D (Linear) weights are ``(out, in)`` in both packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpuseg_torch.models.drn import DrnSpec


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def get_sparsity_stats(
    params: Mapping,
    block: tuple[int, int] | None = None,
) -> dict[str, dict]:
    """Per-layer sparsity breakdown over the conv (OIHW) and Linear weights
    of the port's param dict (tensors or arrays); ``up.weight``, the frozen
    upsample kernel, is skipped."""
    out = {}
    for name, v in params.items():
        w = _np(v)
        if w.ndim not in (2, 4) or name == "up.weight":
            continue
        mat = w.reshape(w.shape[0], -1)
        nz = mat != 0
        stats = {
            "shape": list(w.shape),
            "overall_sparsity": float(1 - nz.mean()),
            "row_sparsity": float((~nz.any(axis=1)).mean()),
            "col_sparsity": float((~nz.any(axis=0)).mean()),
        }
        if w.ndim == 4:
            stats["filter_sparsity"] = float((~nz.any(axis=1)).mean())
            stats["channel_sparsity"] = float((~(w != 0).any(axis=(0, 2, 3))).mean())
        if block is not None:
            bh, bw = block
            m, k = mat.shape
            if m % bh == 0 and k % bw == 0:
                blocks = nz.reshape(m // bh, bh, k // bw, bw).any(axis=(1, 3))
                stats["block_occupancy"] = float(blocks.mean())
        out[name] = stats
    return out


def get_matrix_shapes(spec: DrnSpec, input_hw: tuple[int, int] = (512, 512)) -> list[dict]:
    """Per-conv GEMM shapes (M, K, N) = (OFM, IFM*kh*kw, OH*OW) and FLOPs,
    walking the port's static ``DrnSpec`` in forward order (a block's
    downsample after its convs, on the block's input size)."""
    if not isinstance(spec, DrnSpec):
        raise TypeError(f"expected a DrnSpec, got {type(spec).__name__}")
    h, w = input_hw
    out = []

    def add(cdef, h, w):
        span = cdef.dilation * (cdef.kernel - 1) + 1
        oh = (h + 2 * cdef.padding - span) // cdef.stride + 1
        ow = (w + 2 * cdef.padding - span) // cdef.stride + 1
        m, k, n = cdef.cout, cdef.cin * cdef.kernel * cdef.kernel, oh * ow
        out.append({"name": cdef.name, "M": m, "K": k, "N": n, "flops": 2 * m * k * n})
        return oh, ow

    for _, stage in spec.stages:
        if stage.kind == "convs":
            for cdef, _bn in stage.convs:
                h, w = add(cdef, h, w)
        else:
            for blk in stage.blocks:
                bh, bw = h, w
                for cdef in blk.convs:
                    bh, bw = add(cdef, bh, bw)
                if blk.downsample is not None:
                    add(blk.downsample[0], h, w)
                h, w = bh, bw
    return out
