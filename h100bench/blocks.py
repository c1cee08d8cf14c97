"""The least time of a configuration's bottleneck blocks (fyu/drn's
``Bottleneck``: a 1x1 reduce, a 3x3 with the block's stride and dilation,
a 1x1 expand x4, a 1x1 downsample where the block has one, the residual
add): the yardstick of ``bottleneck_roofline.video``.

Each conv takes the larger of its operations at the bf16 peak and its bytes
at the memory rate (``work.PEAK_*``): its bf16 input read once, its bf16
weights once a forward and its bf16 output written once.  Each block adds
one bf16 read of its residual.  Fed from the configuration through
``work.conv_geometry``, never from the program's own tables.
"""

from __future__ import annotations

from h100bench import work
from h100bench.reference import drn

BF16 = 2  # bytes


def bottleneck_convs(cfg: dict, size) -> list[tuple[list, tuple]]:
    """Per bottleneck block, ``(convs, residual)``: ``convs`` a list of
    ``(Conv, in_h, in_w, out_h, out_w)`` (conv1, conv2, conv3, then the
    downsample where there is one), ``residual`` the (channels, h, w) of
    the block's output that the residual add reads.  Empty for a
    configuration of basic blocks."""
    if cfg["block"] != "bottleneck":
        return []
    geo = work.conv_geometry(cfg, size)
    out = []
    for kind, _i, items in drn.architecture(cfg):
        if kind != "blocks":
            continue
        for blk in items:
            first = blk.convs[0]
            _c, h0, w0 = geo[first.name]  # conv1 is 1x1 at stride 1: its input's size
            convs, h, w = [], h0, w0
            for c in blk.convs:
                _c, oh, ow = geo[c.name]
                convs.append((c, h, w, oh, ow))
                h, w = oh, ow
            if blk.downsample is not None:
                d = blk.downsample
                _c, oh, ow = geo[d.name]  # the block's output size
                convs.append((d, h0, w0, oh, ow))
            out.append((convs, (blk.convs[-1].cout, h, w)))
    return out


def conv_ops_bytes(c, in_h: int, in_w: int, out_h: int, out_w: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one conv over ``n`` frames: bf16 x read once,
    the bf16 weights once, bf16 y written once."""
    ops = 2.0 * n * out_h * out_w * c.k * c.k * c.cin * c.cout
    nbytes = BF16 * (n * in_h * in_w * c.cin + c.cout * c.cin * c.k * c.k
                     + n * out_h * out_w * c.cout)
    return ops, nbytes


def block_ms(convs: list, residual: tuple, n: int) -> float:
    """The least time, in ms, of one bottleneck block (an entry of
    ``bottleneck_convs``) over ``n`` frames."""
    total = 0.0
    for c, ih, iw, oh, ow in convs:
        ops, nbytes = conv_ops_bytes(c, ih, iw, oh, ow, n)
        total += work.bound_ms(nbytes, ops, "bf16")
    ch, h, w = residual
    return total + BF16 * n * ch * h * w / work.PEAK_BYTES_S * 1e3


def bound_ms(cfg: dict, size, n: int) -> float:
    """The least time, in ms, of one forward of ``n`` frames of ``size``
    through every bottleneck block of ``cfg``; 0 without such blocks."""
    return sum(block_ms(convs, res, n) for convs, res in bottleneck_convs(cfg, size))
