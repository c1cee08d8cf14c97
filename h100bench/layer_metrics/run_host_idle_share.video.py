"""Share of the traced serving window in which the device ran nothing
(no kernel, copy or memset) while ``run()`` was inside one of its host
spans (``run.stack``, ``run.encode``, ``run.pin``, ``run.unpack``,
``run.color``, ``run.concat``), the spans put on the trace's clock by the
``run.wait`` anchors.  The part of ``device_idle_share.video`` that
``run()``'s own host work holds the card idle for."""

from h100bench import program_spans


def read(ctx):
    spans = program_spans.burst(ctx)
    if not spans:
        return None
    idle = program_spans.idle_inside_s(spans, ctx.trace, program_spans.HOST_SPANS)
    return None if idle is None else 100.0 * idle / ctx.window_s
