"""``run()``'s host work a returned frame: the self time of its
``run.stack``, ``run.encode``, ``run.pin``, ``run.unpack``, ``run.color``
and ``run.concat`` spans over the traced burst's calls, over the frames
those calls returned (their ``run`` spans' ``frames_returned``), in ms."""

from h100bench import program_spans


def read(ctx):
    spans = program_spans.burst(ctx)
    if not spans:
        return None
    frames = sum(s.attrs.get("frames_returned", 0) for s in program_spans.named(spans, "run"))
    if not frames:
        return None
    return program_spans.self_ms(spans, program_spans.HOST_SPANS) / frames
