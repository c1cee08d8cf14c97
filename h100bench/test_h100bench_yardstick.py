"""The yardstick's frozen arithmetic against the figures the port's
measurements were taken with (PERF.md)."""

import numpy as np
import pytest

from h100bench import work
from h100bench.harness import bench_spec, cell_for, with_waiting
from h100bench.reference import drn

H100_LANE_RATE = 132 * 128 * 1980e6  # SMs x f32 lanes x max SM clock (Hz)


def _cfg(name="d22.clips30"):
    return cell_for(with_waiting(bench_spec()), name, 0, "cpu").cfg


def test_peaks_are_the_data_sheets():
    assert work.PEAK_BYTES_S == 3.35e12
    assert work.PEAK_OPS_S == {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def test_b1_bound_at_the_serving_shape():
    # chip_smoke phase 5: 0.2287 ms at (32, 128, 256, 19) bf16, compare/select-bound
    assert work.b1_bound_ms((32, 128, 256, 19), 2, H100_LANE_RATE) == pytest.approx(
        0.2287, abs=5e-5)


def test_b1_instructions_of_the_bilinear_kernel():
    a, b = work.phase_weights(drn.bilinear_kernel())
    assert np.allclose(a, b[::-1])
    assert work.b1_instructions(a, b) == (2 * (1 + 1 / 8) + 3, 3)


def test_dense_frame_is_1089_5_gflop():
    cfg = _cfg()
    ops = work.frame_ops(cfg, None, (1024, 2048), backbone_only=True)
    assert ops["int8"] == 0
    assert ops["bf16"] / 1e9 == pytest.approx(1089.5124, abs=1e-4)
    head = work.frame_ops(cfg, None, (1024, 2048))["bf16"] - ops["bf16"]
    assert head == 2 * 128 * 256 * 512 * 19


def test_pruned_int8_frame_counts_live_weights_only():
    cfg = _cfg("d22_b875_int8.clips30")
    shapes = {f"{c.name}.weight": (c.cout, c.cin, c.k, c.k) for c in drn.all_convs(cfg)}
    masks = drn.block_regular_masks(cfg["prune"], shapes)
    dense = work.frame_ops(_cfg(), None, (1024, 2048))
    ops = work.frame_ops(cfg, masks, (1024, 2048))
    assert sum(ops.values()) < sum(dense.values())
    # layer.6.1.conv2 keeps one of its four 128-channel in-blocks per out-block
    c = {c.name: c for c in drn.all_convs(cfg)}["layer.6.1.conv2"]
    assert work.live_pairs(cfg, masks, "layer.6.1.conv2", c) == 512 * 128
    assert ops["int8"] > 0 and work.frame_peak_s(cfg, masks, (1024, 2048)) < (
        work.frame_peak_s(_cfg(), None, (1024, 2048)))


def test_int8_bound_of_one_dense_conv():
    cfg = dict(_cfg("d22_b875_int8.clips30"))
    b = work.int8_forward_bound_ms(cfg, None, 32, (1024, 2048))
    assert b > 0
    # layer.6.1.conv2 alone, unpruned: 16 live tiles x 9 taps, ops-bound at the int8 peak
    ops = 2.0 * 32 * 128 * 256 * 9 * 512 * 512
    assert b >= ops / 1979e12 * 1e3


def test_train_step_ops():
    cfg = _cfg()
    fwd = work.frame_ops(cfg, None, (512, 512))["bf16"]
    ops = work.train_step_ops(cfg, (512, 512), 8)
    first = 2.0 * 512 * 512 * 49 * 3 * 16
    up = 2 * 2.0 * 64 * 64 * 19 * 256
    assert ops == pytest.approx(8 * (3 * fwd - first) + 8 * up, rel=1e-12)
