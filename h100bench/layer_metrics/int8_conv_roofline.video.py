"""The int8 convs' kernels (B3, ``csrc/sparse_conv_q.cu`` and
``csrc/sparse_conv_q_narrow.cu``, with their quantize pass,
``csrc/quantize.cu``) against their least time: each forward's int8 convs
counted as B3's served function (``work.int8_forward_bound_ms``: bf16 x of
the live in-blocks in, live int8 tiles, bf16 y out; live products at the
int8 peak), times the forwards in the traced window (B1's launches), over
the device time of those kernels."""

PATTERN = r"sparse_conv_q_kernel|narrow_q_kernel|quantize_kernel|absmax_kernel"


def read(ctx):
    t = ctx.trace.seconds_where(PATTERN)
    forwards = ctx.trace.count_where(r"upsample_argmax_kernel")
    if not t or not forwards or not ctx.work.get("int8_bound_ms"):
        return None
    return 100.0 * forwards * ctx.work["int8_bound_ms"] / (t * 1e3)
