"""Port parity for batched temporal serving: ``drift_threshold``, the frame
deltas (K3) and budget selection (K4) plain versions, and
``VideoSegmenter``'s budgeted and interval modes and their CLI flags,
against tpuseg on the same seed, weights and frames (f32, CPU)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.data.shapes import shapes_video as j_shapes
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.video.autotune import drift_threshold as j_drift_threshold
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.ops import temporal
from tpuseg_torch.ops.upsample import upsample_argmax
from tpuseg_torch.video.autotune import drift_threshold
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
SIZE = (64, 64)


def _abc():
    """tests/test_video.py's three random frames A, B, C (64x64)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=SIZE + (3,), dtype=np.uint8) for _ in range(3)]


def _segmenters(**kw):
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    return (TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.float32,
                       **kw),
            JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=None, **kw))


def _jax_budget(jseg, frames):
    """tpuseg's budgeted program batch by batch from a fresh carry: (ids,
    flags) of every frame."""
    b = jseg.batch
    carry = jseg._make_carry(*frames[0].shape[:2])
    ids, flags = [], []
    for i in range(0, len(frames), b):
        arr = np.stack(frames[i:i + b])
        (out, _, _), f, carry = jseg._program(jseg.params, jseg.bn_state,
                                              jnp.asarray(arr.reshape(b, arr.shape[1], -1)),
                                              *carry)
        ids.append(np.asarray(out))
        flags.append(np.asarray(f))
    return np.concatenate(ids), np.concatenate(flags)


def test_drift_threshold_bit_equal():
    frames = list(j_shapes(12, (48, 80), seed=1)[0])
    got, ref = drift_threshold(frames), j_drift_threshold(frames)
    assert got == ref and all(isinstance(v, float) for v in got)


def test_frame_deltas_match_jax():
    """K3's plain version against tpuseg's f32 jnp.mean of |f[i] - f[i-1]|
    (pipeline.py:670-678): within 2e-6 relative (tpuseg's f32 sum runs in an
    order XLA picks; the port's is the exact sum's double quotient rounded
    to f32, exactly what the kernel computes)."""
    frames = np.stack(list(j_shapes(6, (96, 160), seed=2)[0])).reshape(6, 96, -1)
    prev = np.random.default_rng(1).integers(0, 256, size=frames.shape[1:], dtype=np.uint8)
    prevs = np.concatenate([prev[None], frames[:-1]])
    ref = np.asarray(jnp.mean(jnp.abs(jnp.asarray(frames).astype(jnp.int16)
                                      - jnp.asarray(prevs).astype(jnp.int16)).astype(jnp.float32),
                              axis=(1, 2)))
    got = temporal.frame_deltas(torch.from_numpy(frames), torch.from_numpy(prev))
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6)
    exact = np.abs(frames.astype(np.int64) - prevs).sum(axis=(1, 2)) / prev.size
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("budget,seq,promoted", [
    (2, "AABBCCCA", [0, 2, 4, 7]),
    (1, "ABCAABCA", [0, 4]),   # budget pressure: one keyframe a batch
])
def test_budget_mode_matches_jax(budget, seq, promoted):
    """The A/B/C sequences of tests/test_video.py (threshold 5.0, batch 4,
    two batches, so the carry crosses a batch): the port's flags equal
    tpuseg's program's, every frame's ids are its keyframe's (the carried
    ids before a batch's first keyframe), and the ids equal tpuseg's."""
    a, b, c = _abc()
    frames = [{"A": a, "B": b, "C": c}[ch] for ch in seq]
    tseg, jseg = _segmenters(batch=4, temporal_thresh=5.0, temporal_budget=budget)
    out = tseg.run(frames, need_color=False)
    ref_ids, ref_flags = _jax_budget(jseg, frames)
    assert out["promoted"] == len(promoted) and out["promotion_rate"] == len(promoted) / 8
    flags = np.zeros(8, bool)
    flags[promoted] = True
    np.testing.assert_array_equal(ref_flags, flags)
    exact = TSegmenter(*init_drnseg(0, "drn_d_22", 19), MEAN, STD, device="cpu",
                       compute_dtype=torch.float32, batch=4).run(frames, need_color=False)["ids"]
    key = np.maximum.accumulate(np.where(flags, np.arange(8), 0))
    np.testing.assert_array_equal(out["ids"], exact[key])
    np.testing.assert_array_equal(out["ids"], ref_ids)


def test_budget_select_ties_and_first_frame():
    """K4's plain version: n_keyed = 0 promotes the first frame whatever its
    delta; a drift equal to the threshold does not promote (acc > thresh);
    unfilled slots forward frame 0; the inputs are not written."""
    d = torch.tensor([0.0, 2.0, 2.0, 2.0, 0.5, 9.0], dtype=torch.float32)
    acc0, n0 = torch.zeros(1), torch.zeros(1, dtype=torch.int32)
    flags, fwd_idx, keyslot, acc, n = temporal.budget_select(d, acc0, n0, 4.0, 4)
    assert flags.tolist() == [True, False, False, True, False, True]
    assert fwd_idx.tolist() == [0, 3, 5, 0] and keyslot.tolist() == [0, 0, 0, 1, 1, 2]
    assert acc.tolist() == [0.0] and n.tolist() == [3]
    assert acc0.tolist() == [0.0] and n0.tolist() == [0]
    # a carried drift that already sits at the threshold, and budget pressure
    flags, fwd_idx, keyslot, acc, n = temporal.budget_select(
        d, torch.tensor([4.0]), torch.tensor([5], dtype=torch.int32), 4.0, 1)
    assert flags.tolist() == [False, True, False, False, False, False]
    assert fwd_idx.tolist() == [1] and keyslot.tolist() == [-1, 0, 0, 0, 0, 0]
    assert acc.tolist() == [13.5] and n.tolist() == [6]


def test_interval_mode_matches_jax():
    """temporal_interval=3 over 7 frames at batch 4 (the last batch padded
    with a repeat): each frame's ids are its keyframe's, and equal
    tpuseg's."""
    frames = list(j_shapes(7, SIZE, seed=3)[0])
    tseg, jseg = _segmenters(batch=4, temporal_interval=3)
    out = tseg.run(frames, need_color=False)
    ref = np.asarray(jseg.run(frames, warmup=False, need_color=False)["ids"])
    np.testing.assert_array_equal(out["ids"], ref)
    assert out["ids"].shape == (7,) + SIZE
    for i in range(7):
        key = (i // 4) * 4 + ((i % 4) // 3) * 3
        np.testing.assert_array_equal(out["ids"][i], out["ids"][key])
    assert "promoted" not in out


def test_warmup_leaves_the_carry():
    """run()'s untimed first call does not advance the budgeted carry: on a
    static first batch the first frame is still promoted (n_keyed = 0), and
    the carry counts exactly the returned promotions."""
    a, b, _ = _abc()
    tseg, _ = _segmenters(batch=4, temporal_thresh=5.0, temporal_budget=2)
    out = tseg.run([a, a, a, a, b, b, b, b], need_color=False)
    assert out["promoted"] == 2
    assert int(tseg._carry[3]) == 2
    assert torch.equal(tseg._carry[0], torch.from_numpy(b).reshape(64, -1))


def test_promotion_rate_counts_returned_frames():
    """max_frames=5 of 8 (promotions at 0, 2, 4, 7): the flights past the
    cut are collected but their promotions do not count."""
    a, b, c = _abc()
    tseg, _ = _segmenters(batch=4, temporal_thresh=5.0, temporal_budget=2)
    out = tseg.run([a, a, b, b, c, c, c, a], max_frames=5, need_color=False)
    assert out["frames"] == 5 and out["promoted"] == 3 and out["promotion_rate"] == 3 / 5


@pytest.mark.parametrize("kw,match", [
    (dict(temporal_thresh=5.0, temporal_nearest=True), "BATCHED"),
    (dict(temporal_nearest=True), "BATCHED"),
    (dict(temporal_thresh=5.0, temporal_warp=True), "temporal_warp requires"),
    (dict(temporal_budget=2), "requires temporal_thresh"),
    (dict(temporal_interval=2, temporal_thresh=5.0, temporal_budget=2), "mutually exclusive"),
    (dict(temporal_thresh=5.0, temporal_budget=0), "1..batch"),
    (dict(temporal_thresh=5.0, temporal_budget=5), "1..batch"),
    (dict(temporal_interval=0), ">= 1"),
])
def test_temporal_argument_checks(kw, match):
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    with pytest.raises(ValueError, match=match):
        TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", batch=4, **kw)


def test_device_rates_refuse_cpu_and_wrong_mode():
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    seg = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", batch=2, temporal_thresh=5.0,
                     temporal_budget=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        seg.benchmark_adaptive_device_fps(_abc())


def test_budget_step_launches_nothing_on_cpu():
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted."""
    a, b, c = _abc()
    tseg, _ = _segmenters(batch=4, temporal_thresh=5.0, temporal_budget=2)
    temporal.frame_deltas.launches = temporal.budget_select.launches = 0
    upsample_argmax.launches = 0
    tseg.run([a, b, c, a], need_color=False)
    assert (temporal.frame_deltas.launches, temporal.budget_select.launches,
            upsample_argmax.launches) == (0, 0, 0)


@pytest.mark.parametrize("flags,fields", [
    (["--temporal-thresh", "3.0", "--temporal-budget", "2"],
     {"temporal_thresh", "promotion_rate", "temporal_budget"}),
    (["--temporal", "2"], {"temporal_interval"}),
])
def test_cli_temporal_fields(capsys, flags, fields):
    """The result line carries tpuseg's temporal fields
    (tpuseg/cli/seg_video.py:468-530), and with --temporal-report the
    agreement against the exact run and its fps."""
    from tpuseg_torch.cli import seg_video

    seg_video.main(["--device", "cpu", "--video", "shapes", "--size", "64x128", "--frames", "8",
                    "--batch", "4", "--temporal-report", *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    base = {"frames", "seconds", "fps", "size", "arch", "device"}
    assert set(line) == base | fields | {"temporal_ids_agreement", "full_fps"}
    assert line["frames"] == 8 and 0 < line["temporal_ids_agreement"] <= 1
    if "promotion_rate" in fields:
        assert 0 < line["promotion_rate"] <= 1


def test_temporal_path_loads_no_jax():
    """The budgeted CLI path in a fresh interpreter, with the new modules
    imported, loads no jax, jaxlib or tpuseg module."""
    code = (
        "import sys\n"
        "import tpuseg_torch.ops.temporal, tpuseg_torch.video.autotune\n"
        "from tpuseg_torch.cli import seg_video\n"
        "seg_video.main(['--device', 'cpu', '--video', 'shapes', '--size', '32x64',"
        " '--frames', '4', '--batch', '2', '--temporal-thresh', '2.0',"
        " '--temporal-budget', '1', '--quantize', '--quantize-stem'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"promotion_rate"' in proc.stdout
