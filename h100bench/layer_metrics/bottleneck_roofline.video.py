"""The bottleneck blocks (``models/drn.py::_run_block``: cuDNN's 1x1 and
3x3 convs and PyTorch's ReLU, residual-add and bias epilogues) against
their least time: for each ``forward`` span of the traced burst, the least
time of its ``batch`` frames through every bottleneck block
(``blocks.bound_ms``: each conv's operations at the bf16 peak or its bf16
x, weights and y at the memory rate, whichever is larger, and one bf16
read of each block's residual), summed, over the summed ``device_ms`` of
the burst's ``block.reduce``, ``block.spatial`` and ``block.expand``
spans.  Warm and padded frames count on both sides."""

from h100bench import blocks, program_spans

PARTS = ("block.reduce", "block.spatial", "block.expand")


def read(ctx):
    spans = program_spans.burst(ctx)
    if not spans:
        return None
    ms = [s.device_ms for s in program_spans.named(spans, *PARTS)]
    batches = [s.attrs.get("batch") for s in program_spans.named(spans, "forward")]
    if not ms or not batches or any(v is None for v in ms + batches) or not sum(ms):
        return None
    size = tuple(ctx.cell.cfg["frame"])
    bound = sum(blocks.bound_ms(ctx.cell.cfg, size, b) for b in batches)
    return 100.0 * bound / sum(ms)
