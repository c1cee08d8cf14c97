"""The served convs' share of the card's peak: for every frame returned in
the traced window, the time its convs' operations (live weights only for
pruned convs; the head included) take at the peak of the type each runs in
(bf16 989 TFLOP/s, int8 1,979 TOP/s), summed, over the window's wall
time."""


def read(ctx):
    if not ctx.counts.get("frames"):
        return None
    return 100.0 * ctx.counts["frames"] * ctx.work["frame_peak_s"] / ctx.window_s
