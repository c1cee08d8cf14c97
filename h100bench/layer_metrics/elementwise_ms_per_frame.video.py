"""Device milliseconds a returned frame of PyTorch's own elementwise,
reduce, index and copy kernels (bias adds, ReLU, residual adds, normalize,
casts, pads, gathers; device-to-device copies and memsets), over the frames
returned in the traced window."""

PATTERN = r"at::native::|Memcpy DtoD|Memset"


def read(ctx):
    if not ctx.counts.get("frames"):
        return None
    return ctx.trace.seconds_where(PATTERN) * 1e3 / ctx.counts["frames"]
