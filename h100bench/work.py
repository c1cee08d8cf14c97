"""The yardstick's arithmetic: the card's published peaks, the operations
each served frame and each train step needs, and the least time of the
kernels whose rooflines the benchmark reports.

Frozen copies of the port's ``chip_smoke.py`` (``PEAK_BYTES_S``,
``PEAK_OPS_S``, ``_bound``, ``_b1_instructions``, ``_b1_bound``, and the
byte and operation count of B3's served function), fed here from the
configuration's shapes and masks, never from the program's own tables.
Operations count 2 a multiply-add; a pruned conv counts only its live
weights.
"""

from __future__ import annotations

import numpy as np

from h100bench.reference import drn

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_ms(nbytes: float, ops: float, peak: str) -> float:
    """The larger of bytes over the memory rate and operations over the
    peak of their type, in ms."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[peak]) * 1e3


def b1_instructions(a, b) -> tuple[float, float]:
    """B1's f32 instructions per output pixel and class with phase weights
    (a, b): (issued, of which on the half-rate compare/select pipe).  Each
    interpolation pass makes a value from two products and an add; when
    a[q] == b[7-q] (the bilinear kernel) the 16 weights an input value meets
    are 8 distinct products, so 1 multiply a value, else 2; the row pass's
    values serve the 8 output columns of an input column.  The argmax is a
    compare and two selects at half the f32 rate."""
    products = 1 if (np.asarray(a) == np.asarray(b)[::-1]).all() else 2
    return (products + 1) * (1 + 1 / 8) + 3, 3


def phase_weights(kernel_2d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-phase 2-tap weights (a[r], b[r]) of the x8 transposed conv: the
    separable factor ``sqrt(diag(k))``, taps k[15 - k0] and k[7 - k0] with
    k0 = (11 - r) % 8."""
    k1 = np.sqrt(np.diagonal(kernel_2d)).astype(np.float32)
    k0 = (11 - np.arange(8)) % 8
    return k1[15 - k0], k1[7 - k0]


def b1_bound_ms(shape, itemsize: int, lane_rate: float) -> float:
    """B1 (fused x8 upsample + argmax) on (N, h, w, C) logits: the largest
    of the bytes (logits read once, uint8 ids written once) over the memory
    rate, the issued f32 instructions over ``lane_rate`` (SMs x 128 lanes x
    the max SM clock) and the compare/select pipe's over half of it."""
    n, h, w, c = shape
    pixel_classes = 64 * n * h * w * c
    issued, half_rate = b1_instructions(*phase_weights(drn.bilinear_kernel()))
    return max((n * h * w * c * itemsize + 64 * n * h * w) / PEAK_BYTES_S,
               pixel_classes * issued / lane_rate,
               pixel_classes * half_rate * 2 / lane_rate) * 1e3


def conv_geometry(cfg: dict, size) -> dict:
    """``{conv name: (Conv, out_h, out_w)}`` for a (H, W) input, the head
    under ``seg``."""
    h, w = size
    out = {}
    for kind, _i, items in drn.architecture(cfg):
        convs = items if kind == "convs" else [c for b in items for c in b.convs] + [
            b.downsample for b in items if b.downsample is not None]
        for c in convs:
            if c.stride > 1 and c.role != "downsample":
                h, w = -(-h // c.stride), -(-w // c.stride)
            out[c.name] = (c, h, w)
    seg = drn.Conv("seg", "", drn.feature_channels(cfg), cfg["num_classes"], 1, 1, 1, 9, "head")
    out["seg"] = (seg, h, w)
    return out


def live_pairs(cfg: dict, masks: dict | None, name: str, c) -> int:
    """Live (in, out) channel pairs of a conv: its mask's nonzeros over one
    tap, or cin x cout unmasked."""
    m = (masks or {}).get(f"{name}.weight")
    return int(np.count_nonzero(m[:, :, 0, 0])) if m is not None else c.cin * c.cout


def frame_ops(cfg: dict, masks: dict | None, size, backbone_only: bool = False) -> dict:
    """Operations of one served frame by the type they run in: ``{"bf16":
    ops, "int8": ops}`` (live weights only; the head included unless
    ``backbone_only``)."""
    int8 = set(drn.int8_convs(cfg))
    ops = {"bf16": 0.0, "int8": 0.0}
    for name, (c, h, w) in conv_geometry(cfg, size).items():
        if backbone_only and name == "seg":
            continue
        n = 2.0 * h * w * c.k * c.k * live_pairs(cfg, masks, name, c)
        ops["int8" if name in int8 else "bf16"] += n
    return ops


def frame_peak_s(cfg: dict, masks: dict | None, size) -> float:
    """Seconds one frame's convs take at the peak of the type each runs in."""
    ops = frame_ops(cfg, masks, size)
    return sum(v / PEAK_OPS_S[t] for t, v in ops.items())


def train_step_ops(cfg: dict, crop, batch: int) -> float:
    """Operations of one bf16 train step: each conv's forward, its dgrad
    (not the first conv's: the images take no gradient) and its wgrad; the
    frozen x8 upsampler's forward and dgrad (a depthwise 16x16 transposed
    conv: 256 multiply-adds an input value)."""
    total = 0.0
    first = drn.all_convs(cfg)[0].name
    for name, (c, h, w) in conv_geometry(cfg, crop).items():
        f = 2.0 * batch * h * w * c.k * c.k * c.cin * c.cout
        total += f * (2 if name == first else 3)
    _seg, h, w = conv_geometry(cfg, crop)["seg"]
    total += 2 * 2.0 * batch * h * w * cfg["num_classes"] * drn.UP_KERNEL ** 2
    return total


def int8_forward_bound_ms(cfg: dict, masks: dict | None, n: int, size) -> float:
    """The least time of one batch's int8 convs as B3's served function
    computes each (quantize + B3 + bf16 bias): bf16 x in (the live
    in-blocks), the live int8 128x128 tiles, their f32 scales and the block
    table, bf16 bias and y out; the live products at the int8 peak."""
    total = 0.0
    geo = conv_geometry(cfg, size)
    for name in drn.int8_convs(cfg):
        c, h, w = geo[name]
        pix = n * h * w
        m = (masks or {}).get(f"{name}.weight")
        meta = (np.ones((c.cout // 128, c.cin // 128), bool) if m is None else
                m[:, :, 0, 0].reshape(c.cout // 128, 128, c.cin // 128, 128).any(axis=(1, 3)))
        tiles = int(meta.sum()) * c.k * c.k
        in_blocks = int(meta.any(axis=0).sum())
        nbytes = (pix * in_blocks * 128 * 2 + tiles * 128 * 128 + c.cout * 4
                  + meta.size * 4 + c.cout * 2 + pix * c.cout * 2)
        total += bound_ms(nbytes, 2.0 * pix * tiles * 128 * 128, "int8")
    return total
