"""The train step's share of the card's bf16 peak: each step's conv
operations (forward, dgrad and wgrad of every trainable conv, the first
conv's dgrad left out; forward and dgrad of the frozen x8 upsampler) at
989 TFLOP/s, over the traced window's wall time a step."""


def read(ctx):
    if not ctx.counts.get("steps"):
        return None
    return 100.0 * ctx.counts["steps"] * ctx.work["step_peak_s"] / ctx.window_s
