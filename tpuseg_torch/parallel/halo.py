"""Halo exchange for H-sharded convolutions (the port's counterpart of the
halos XLA SPMD inserts for ``tpuseg``'s ``spatial`` mesh axis).

Each rank of a spatial group holds a strip of ``h`` image rows (NCHW dim
2), rank ``i`` the rows ``[i*h, (i+1)*h)``.  A conv with kernel ``k``,
dilation ``d``, stride ``s`` and padding ``p`` maps the strip's output rows
``[a, b)`` (``a*s = i*h``) to the input rows ``[a*s - p, (b-1)*s - p +
d*(k-1) + 1)``: ``p`` rows above the strip and ``d*(k-1) - p + 1 - s``
below it (a negative count drops rows).  ``Halo.rows`` assembles them:
every rank contributes its top and bottom ``min(halo, h)`` rows to one
``all_gather`` of fixed-size slabs, and a rank takes the rows it needs from
as many neighbours as the halo spans (at stride 8 a strip of a small map
can be thinner than a dilation-4 halo), with zeros outside the image.  The
gather's backward adds each halo row's gradient back into its owner's row
(``tpuseg_torch.parallel.mesh.gather``), so training through it is exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.parallel.mesh import gather


def _rows_of(slabs: torch.Tensor) -> torch.Tensor:
    """(k, N, C, r, W) slabs of consecutive ranks -> (N, C, k*r, W) rows."""
    k, n, c, r, w = slabs.shape
    return slabs.permute(1, 2, 0, 3, 4).reshape(n, c, k * r, w)


class Halo:
    """The spatial group of this rank: ``count`` strips, this one at
    ``index``."""

    def __init__(self, group, index: int, count: int):
        self.group, self.index, self.count = group, index, count

    def rows(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """NCHW strip -> the rows from ``top`` above it to ``bottom`` below
        it (negative: that many of the strip's own rows dropped), zeros
        outside the image.  Every rank of the group must call this with the
        same counts and shapes."""
        h = x.shape[2]
        need = max(top, bottom, 0)
        if need == 0:
            return x[:, :, -top:h + bottom] if top or bottom else x
        slab = min(need, h)
        payload = torch.cat([x[:, :, :slab], x[:, :, h - slab:]], dim=2)
        slabs = gather(payload, self.group, self.index)  # (count, N, C, 2*slab, W)
        # the ranks past either edge of the image hold zeros; the graph is
        # the same on every rank (only slice offsets differ), so every
        # rank's backward runs its collectives in the same order
        kt = -(-max(top, 0) // slab)  # neighbours the halo spans above
        kb = -(-max(bottom, 0) // slab)  # and below
        pad = max(kt, kb)
        zeros = torch.zeros((pad,) + tuple(slabs.shape[1:]), dtype=x.dtype, device=x.device)
        slabs = torch.cat([zeros, slabs, zeros])
        i = self.index + pad
        parts = []
        if top > 0:
            above = slabs[i - kt:i, :, :, slab:]  # their bottom slabs
            parts.append(_rows_of(above)[:, :, -top:])
        parts.append(x[:, :, max(-top, 0):h + min(bottom, 0)])
        if bottom > 0:
            below = slabs[i + 1:i + 1 + kb, :, :, :slab]  # their top slabs
            parts.append(_rows_of(below)[:, :, :bottom])
        return torch.cat(parts, dim=2)

    def conv2d(self, x, w, bias, stride: int, padding: int, dilation: int,
               groups: int = 1) -> torch.Tensor:
        """``F.conv2d`` of the whole image, computed on this strip: the halo
        rows around it, then the conv unpadded in H (padded in W)."""
        k = w.shape[2]
        ext = self.rows(x, padding, dilation * (k - 1) - padding + 1 - stride)
        return F.conv2d(ext, w, bias, stride, (0, padding), dilation, groups)

    def same(self, x: torch.Tensor, halo: int, fn) -> torch.Tensor:
        """A stride-1 "same" conv ``fn`` (NCHW -> NCHW, e.g. a sparse plan)
        on this strip: ``fn`` of the strip with ``halo`` rows on each side,
        cropped back to the strip's rows."""
        if halo == 0:
            return fn(x)
        h = x.shape[2]
        y = fn(self.rows(x, halo, halo).contiguous(memory_format=torch.channels_last))
        return y[:, :, halo:halo + h]

    def upsample8(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """DRNSeg's depthwise ×8 transposed conv (kernel 16, padding 4) on an
        NCHW strip: the output rows ``[8a, 8b)`` read input rows ``a-1`` to
        ``b``, a one-row halo each side; unpadded that transposed conv starts
        12 rows above ``8a``, hence padding 12 in H."""
        c = x.shape[1]
        ext = self.rows(x, 1, 1)
        return F.conv_transpose2d(ext, w, stride=8, padding=(12, 4), groups=c)

    def gather_rows(self, y: torch.Tensor) -> torch.Tensor:
        """NHWC strips of every rank -> the full (N, H, W, C) output on
        every rank (no gradient)."""
        parts = gather(y.detach(), self.group, self.index)
        return torch.cat(list(parts), dim=1)
