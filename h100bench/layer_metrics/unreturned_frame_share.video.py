"""Share of the frames ``run()`` forwarded that it did not return: the
untimed first batch of every call and the padding of each call's last
batch, ``(frames_warm + frames_padded) / frames_forwarded`` summed over the
traced burst's ``run`` spans."""

from h100bench import program_spans


def read(ctx):
    spans = program_spans.burst(ctx)
    if not spans:
        return None
    runs = program_spans.named(spans, "run")
    fwd = sum(s.attrs.get("frames_forwarded", 0) for s in runs)
    if not fwd:
        return None
    lost = sum(s.attrs.get("frames_warm", 0) + s.attrs.get("frames_padded", 0) for s in runs)
    return 100.0 * lost / fwd
