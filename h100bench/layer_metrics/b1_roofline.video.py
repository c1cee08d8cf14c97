"""B1 (``csrc/upsample_argmax.cu``) against its least time: each launch's
bound (``work.b1_bound_ms`` at the batch's logits: bytes, issued f32
instructions or the compare/select pipe, whichever is largest) summed over
its launches in the traced window, over their device time."""

PATTERN = r"upsample_argmax_kernel"


def read(ctx):
    n = ctx.trace.count_where(PATTERN)
    if not n or ctx.work.get("b1_bound_ms") is None:
        return None
    return 100.0 * n * ctx.work["b1_bound_ms"] / (ctx.trace.seconds_where(PATTERN) * 1e3)
