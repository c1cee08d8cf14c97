"""Device milliseconds a forwarded frame of the bottleneck blocks' expand
part (``block.expand``: the 1x1 conv to 4x the block's planes, the
downsample where the block has one, the residual add and the last ReLU):
the summed ``device_ms`` of the traced burst's ``block.expand`` spans over
the frames its ``forward`` spans ran (the sum of their ``batch``, warm and
padded frames included)."""

from h100bench import program_spans


def read(ctx):
    spans = program_spans.burst(ctx)
    if not spans:
        return None
    ms = [s.device_ms for s in program_spans.named(spans, "block.expand")]
    batches = [s.attrs.get("batch") for s in program_spans.named(spans, "forward")]
    if not ms or not batches or any(v is None for v in ms + batches) or not sum(batches):
        return None
    return sum(ms) / sum(batches)
