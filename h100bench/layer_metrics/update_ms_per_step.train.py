"""The optimizer update's device time a train step: the mean
``device_ms`` (CUDA events around ``_sgd_update`` on the step's stream,
gaps inside it included) of the ``train.update`` spans of the traced
burst's steps."""

from h100bench import program_spans


def read(ctx):
    spans = program_spans.burst(ctx)
    if not spans:
        return None
    ms = [s.device_ms for s in program_spans.named(spans, "train.update")]
    if not ms or any(v is None for v in ms):
        return None
    return sum(ms) / len(ms)
