"""Port parity for the temporal modes this slice adds to ``VideoSegmenter``:
the sequential adaptive mode (K5's plain version), nearest reuse in the
interval and budgeted modes, warped reuse, their combination with the
transports, the argument checks and ``autotune_budget``, against
``tpuseg``'s on the same weights and numpy-seeded frames (f32, CPU)."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.video.autotune import autotune_budget as j_autotune
from tpuseg.video.autotune import candidate_ladder as j_ladder
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.ops import temporal
from tpuseg_torch.ops.upsample import upsample_argmax
from tpuseg_torch.video.autotune import autotune_budget, candidate_ladder, default_ladder
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter
from tpuseg_torch.video.pipeline import budget_nearest_slots, interval_nearest_keys

torch.set_num_threads(2)

MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
T_MODEL = init_drnseg(0, "drn_d_22", 19)
J_MODEL = j_init(0, "drn_d_22", 19)


def _tseg(**kw):
    return TSegmenter(*T_MODEL, MEAN, STD, device="cpu", compute_dtype=torch.float32, **kw)


def _jseg(**kw):
    return JSegmenter(*J_MODEL, MEAN, STD, compute_dtype=None, **kw)


def _frames(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=size + (3,), dtype=np.uint8) for _ in range(n)]


def _blend(a, b, ts):
    return [np.clip(a.astype(np.float32) * (1 - t) + b.astype(np.float32) * t, 0,
                    255).astype(np.uint8) for t in ts]


def _jax_adaptive(jseg, frames):
    """tpuseg's adaptive program batch by batch from a fresh carry: (ids,
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


def _margin_ok(frames, thresh, keys):
    """Every mean |f - keyframe| of the sequence is at least 1e-3 away from
    the threshold, so tpuseg's f32 mean and K5's exact one decide alike."""
    d = [np.abs(f.astype(np.int16) - frames[k].astype(np.int16)).mean()
         for f, k in zip(frames, keys)]
    return min(abs(v - thresh) for v in d) > 1e-3


A, B, C = _frames(3, (64, 64))
SEQ = [A, A, B, B, B, C, C, A]


def test_sequential_mode_matches_tpuseg():
    """temporal_thresh=5 without a budget, batch 4, two batches: the flags
    equal tpuseg's program's, the ids agree on >= 0.999 (measured: all),
    each frame's ids are its keyframe's, and one forward a batch serves
    exactly the promoted frames."""
    tseg = _tseg(batch=4, temporal_thresh=5.0)
    forwarded = []
    orig = tseg.ids_for
    tseg.ids_for = lambda x: forwarded.append(x.shape[0]) or orig(x)
    out = tseg.run(SEQ, need_color=False)
    ref_ids, ref_flags = _jax_adaptive(_jseg(batch=4, temporal_thresh=5.0), SEQ)
    np.testing.assert_array_equal(ref_flags, [1, 0, 1, 0, 0, 1, 0, 1])
    assert out["promoted"] == 4 and out["promotion_rate"] == 0.5
    assert (out["ids"] == ref_ids).mean() >= 0.999
    for i, k in enumerate([0, 0, 2, 2, 2, 5, 5, 7]):
        np.testing.assert_array_equal(out["ids"][i], out["ids"][k])
    assert forwarded == [2, 2, 2]  # run()'s untimed first call, then the two batches


def test_sequential_mode_drift_and_carry_across_runs():
    """Slow drift A -> B: a frame promotes only once its distance to the
    KEYFRAME (not to the previous frame) passes the threshold; the keyframe
    carry crosses batches and run() calls, as tpuseg's does."""
    fs = _blend(A, B, np.linspace(0.0, 0.35, 12))
    tseg, jseg = _tseg(batch=4, temporal_thresh=12.0), _jseg(batch=4, temporal_thresh=12.0)
    first, second = tseg.run(fs[:8], need_color=False), tseg.run(fs[8:], need_color=False)
    j_first = jseg.run(fs[:8], warmup=False, need_color=False)
    j_second = jseg.run(fs[8:], warmup=False, need_color=False)
    assert (first["promoted"], second["promoted"]) == (j_first["promoted"], j_second["promoted"])
    assert 1 < first["promoted"] + second["promoted"] < 12
    np.testing.assert_array_equal(np.concatenate([first["ids"], second["ids"]]),
                                  np.concatenate([j_first["ids"], j_second["ids"]]))
    _, flags = _jax_adaptive(_jseg(batch=4, temporal_thresh=12.0), fs)
    keys = np.maximum.accumulate(np.where(flags, np.arange(12), 0))
    assert _margin_ok(fs, 12.0, np.concatenate([[0], keys[:-1]]))


def _k5_tpuseg(frames, carried, n, thresh):
    """tpuseg's scan (pipeline.py:614-634) in numpy, the diff an f32 mean."""
    flags, kf = [], carried
    for f in frames:
        diff = np.abs(f.astype(np.int16) - kf.astype(np.int16)).astype(np.float32).mean()
        run = n == 0 or diff > np.float32(thresh)
        if run:
            kf, n = f, n + 1
        flags.append(run)
    return np.array(flags), n, kf


@pytest.mark.parametrize("case", ["first frame", "scene cut", "carried keyframe", "tie", "drift"])
def test_keyframe_select_plain(case):
    """K5's plain version: n_keyed = 0 promotes the first frame whatever it
    holds; a cut promotes; with n_keyed > 0 the carried keyframe is the
    reference; a diff exactly at the threshold does not promote (diff >
    thresh); slow drift promotes against the keyframe.  Flags, slots and the
    new keyframe equal tpuseg's scan (margins far from ties except the tie
    case, whose diffs are exact in f32); the diffs are the exact sums'."""
    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, 256, size=(16, 48), dtype=np.uint8) for _ in range(2))
    thresh, n0, carried = 5.0, 1, a
    if case == "first frame":
        frames, n0 = [a, a, a], 0
    elif case == "scene cut":
        frames = [a, a, b, b]
    elif case == "carried keyframe":
        frames, carried = [a, a], b
    elif case == "tie":
        frames, thresh = [np.full_like(a, 12), np.full_like(a, 14), np.full_like(a, 15)], 2.0
        carried = np.full_like(a, 10)
    else:
        frames = _blend(a, b, np.linspace(0.02, 0.4, 8))
    x = torch.from_numpy(np.stack(frames))
    got = temporal.keyframe_select(x, torch.from_numpy(carried),
                                   torch.tensor([n0], dtype=torch.int32), thresh)
    flags, keyslot, fwd_idx, diffs, count, n, kf = got
    want_flags, want_n, want_kf = _k5_tpuseg(frames, carried, n0, thresh)
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    np.testing.assert_array_equal(keyslot.numpy(), np.cumsum(want_flags) - 1)
    assert int(count) == want_flags.sum() and int(n) == want_n
    np.testing.assert_array_equal(fwd_idx[:int(count)].numpy(), np.flatnonzero(want_flags))
    np.testing.assert_array_equal(kf.numpy(), want_kf)
    keys = [carried] + [frames[i] for i in np.flatnonzero(want_flags)]
    refs = [keys[s] for s in np.cumsum(np.concatenate([[0], want_flags[:-1]]))]
    exact = [np.abs(f.astype(np.int64) - r).sum() / f.size for f, r in zip(frames, refs)]
    np.testing.assert_array_equal(diffs.numpy(), np.asarray(exact).astype(np.float32))
    if case == "tie":
        # 12 - 10 = 2 does not promote; 14 - 10 = 4 does; 15 - 14 = 1 not
        np.testing.assert_array_equal(want_flags, [False, True, False])
    if case == "first frame":
        assert want_flags.tolist() == [True, False, False]


def test_keyframe_select_counts_no_cpu_launch():
    temporal.keyframe_select.launches = upsample_argmax.launches = 0
    _tseg(batch=4, temporal_thresh=5.0).run(SEQ[:4], need_color=False)
    assert (temporal.keyframe_select.launches, upsample_argmax.launches) == (0, 0)


def test_interval_nearest_matches_tpuseg():
    """tests/test_video.py:553's sequence [A, A, B, B, B, B, C, C], interval
    4, batch 8: frames 2 and 3 move to the B keyframe; ids equal tpuseg's."""
    seq = [A, A, B, B, B, B, C, C]
    out = _tseg(batch=8, temporal_interval=4, temporal_nearest=True).run(seq, need_color=False)
    ref = _jseg(batch=8, temporal_interval=4, temporal_nearest=True).run(
        seq, warmup=False, need_color=False)["ids"]
    np.testing.assert_array_equal(out["ids"], np.asarray(ref))
    exact = _tseg(batch=8).run(seq, need_color=False)["ids"]
    np.testing.assert_array_equal(out["ids"][2], exact[4])
    np.testing.assert_array_equal(out["ids"][1], exact[0])


def test_budget_nearest_matches_tpuseg():
    """tests/test_video.py:587's two sequences: a cut's spike keeps pre-cut
    frames on the pre-cut keyframe; across a batch boundary a frame adopts
    the later promotion through the carried drift.  Ids and promotions equal
    tpuseg's."""
    kw = dict(batch=4, temporal_thresh=5.0, temporal_budget=2, temporal_nearest=True)
    out = _tseg(**kw).run([A, A, A, B], need_color=False)
    ref = _jseg(**kw).run([A, A, A, B], warmup=False, need_color=False)
    assert out["promoted"] == ref["promoted"] == 2
    np.testing.assert_array_equal(out["ids"], np.asarray(ref["ids"]))
    fs = _blend(A, B, np.linspace(0.0, 0.21, 8))
    d = [float(np.mean(np.abs(fs[i + 1].astype(np.int16) - fs[i].astype(np.int16))))
         for i in range(7)]
    kw1 = dict(batch=4, temporal_thresh=(sum(d[:4]) + sum(d[:5])) / 2.0, temporal_budget=1,
               temporal_nearest=True)
    out = _tseg(**kw1).run(fs, need_color=False)
    ref = _jseg(**kw1).run(fs, warmup=False, need_color=False)
    assert out["promoted"] == ref["promoted"] == 2
    np.testing.assert_array_equal(out["ids"], np.asarray(ref["ids"]))
    np.testing.assert_array_equal(out["ids"][4], out["ids"][5])


def _tpuseg_interval_keys(d_tail, interval, n_frames, n_keys):
    """tpuseg's index map (pipeline.py:556-570) in numpy f32 from its d."""
    cum = np.concatenate([np.zeros(1, np.float32), np.cumsum(d_tail, dtype=np.float32)])
    prev_k = np.arange(n_frames) // interval
    next_k = np.minimum(prev_k + 1, n_keys - 1)
    drift_prev = cum - cum[prev_k * interval]
    drift_next = cum[np.minimum(next_k * interval, n_frames - 1)] - cum
    return np.where((next_k > prev_k) & (drift_next < drift_prev), next_k, prev_k)


@pytest.mark.parametrize("interval,n_frames", [(4, 32), (3, 32), (2, 8), (8, 8)])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_interval_nearest_index_map(interval, n_frames, kind):
    """The index map from a given d: the port's (d[0] = 0, cumsum) against
    tpuseg's formula on the same d; with ties (constant d) frames stay
    causal."""
    rng = np.random.default_rng(interval * n_frames)
    d_tail = (rng.random(n_frames - 1) * 6 if kind == "random"
              else np.full(n_frames - 1, 1.0)).astype(np.float32)
    n_keys = -(-n_frames // interval)
    d = torch.from_numpy(np.concatenate([[np.float32(0)], d_tail]))
    got = interval_nearest_keys(d, interval, n_keys).numpy()
    np.testing.assert_array_equal(got, _tpuseg_interval_keys(d_tail, interval, n_frames, n_keys))


@pytest.mark.parametrize("seed", range(4))
def test_budget_nearest_index_map(seed):
    """The budgeted slot map from given d, acc0 and K4's selection against
    tpuseg's formula (pipeline.py:720-731) in numpy f32."""
    rng = np.random.default_rng(seed)
    k = 8
    d = (rng.random(32) * 3).astype(np.float32)
    acc0 = np.float32(rng.random() * 2)
    flags, fwd_idx, keyslot, _, _ = temporal.budget_select(
        torch.from_numpy(d), torch.tensor([acc0]), torch.tensor([3], dtype=torch.int32), 2.5, k)
    got = budget_nearest_slots(torch.from_numpy(d), fwd_idx, keyslot, torch.tensor([acc0]), k)
    ks, fi = keyslot.numpy(), fwd_idx.numpy()
    cum = np.cumsum(d, dtype=np.float32)
    nxt = ks + 1
    drift_prev = np.where(ks >= 0, cum - cum[fi[np.clip(ks, 0, k - 1)]], acc0 + cum)
    drift_next = cum[fi[np.clip(nxt, 0, k - 1)]] - cum
    want = np.where((nxt < flags.numpy().sum()) & (drift_next < drift_prev), nxt, ks)
    np.testing.assert_array_equal(got.numpy(), want)


A128, B128 = _frames(2, (128, 128), seed=11)
A2 = np.roll(A128, (8, -16), axis=(0, 1))


@pytest.mark.parametrize("kw,seq,reused", [
    (dict(temporal_interval=2, temporal_warp=True), [A128, A2, B128, B128], True),
    (dict(temporal_interval=4, temporal_warp=True, temporal_nearest=True),
     [A128, A2, B128, B128], True),
    (dict(temporal_thresh=5.0, temporal_budget=1, temporal_warp=True), [A128, A2, A2, A2], True),
    (dict(temporal_thresh=5.0, temporal_budget=2, temporal_warp=True, temporal_nearest=True),
     [A128, A2, B128, B128], False),
])
def test_warp_modes_match_tpuseg(kw, seq, reused):
    """Warped reuse at 128x128 (tests/test_video.py:390, :498): ids equal
    tpuseg's; where frame 1 reuses frame 0's ids, its interior is them moved
    by (8, -16)."""
    out = _tseg(batch=4, **kw).run(seq, need_color=False)
    ref = _jseg(batch=4, **kw).run(seq, warmup=False, need_color=False)
    np.testing.assert_array_equal(out["ids"], np.asarray(ref["ids"]))
    if "temporal_budget" in kw:
        assert out["promoted"] == ref["promoted"]
    if reused:
        want = np.roll(out["ids"][0], (8, -16), axis=(0, 1))
        np.testing.assert_array_equal(out["ids"][1][16:-16, 16:-16], want[16:-16, 16:-16])


def test_budget_warp_nearest_with_transport_matches_tpuseg():
    """Budgeted + nearest + warp with decode 64x64 -> target 128x128 on the
    device, yuv420 and ids packed to 5 bits: ids and promotions equal
    tpuseg's (the pooled luma resizes onto the target grid), two run()
    calls chaining the luma carry; the adaptive device-rate method refuses
    the CPU."""
    a, b = _frames(2, (64, 64), seed=12)
    seq = [a, np.roll(a, (4, -8), axis=(0, 1)), b, b]
    kw = dict(batch=4, temporal_thresh=5.0, temporal_budget=2, temporal_nearest=True,
              temporal_warp=True, target_size=(128, 128), transport="yuv420", ids_bits=5)
    tseg, jseg = _tseg(**kw), _jseg(**kw)
    for _ in range(2):
        out = tseg.run(seq, need_color=False)
        ref = jseg.run(seq, warmup=False, need_color=False)
        assert out["ids"].shape == (4, 128, 128) and out["promoted"] == ref["promoted"]
        np.testing.assert_array_equal(out["ids"], np.asarray(ref["ids"]))
    assert len(tseg._carry) == 5 and tuple(tseg._carry[4].shape) == (16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tseg.benchmark_adaptive_device_fps(seq)


@pytest.mark.parametrize("kw", [
    dict(temporal_nearest=True),
    dict(temporal_thresh=5.0, temporal_nearest=True),
    dict(temporal_warp=True),
    dict(temporal_thresh=5.0, temporal_warp=True),
    dict(temporal_budget=2),
    dict(temporal_interval=2, temporal_thresh=5.0),
    dict(temporal_thresh=5.0, temporal_budget=9),
])
def test_argument_checks_match_tpuseg(kw):
    """Each rejected combination raises ValueError with tpuseg's message
    (its AssertionError's)."""
    with pytest.raises(AssertionError) as jerr:
        _jseg(batch=8, **kw)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value).split(";")[0][:40])):
        _tseg(batch=8, **kw)


@pytest.mark.parametrize("batch", [1, 2, 4, 8, 32])
def test_candidate_ladder_equals_tpuseg(batch):
    assert default_ladder(batch) == __import__("tpuseg.video.autotune",
                                               fromlist=["x"]).default_ladder(batch)
    for extra in (dict(), dict(include_warp=True), dict(include_nearest=False, intervals=(4, 1)),
                  dict(ks=())):
        assert candidate_ladder(batch, **extra) == j_ladder(batch, **extra)


@pytest.mark.parametrize("target", [0.9, 1.1])
def test_autotune_budget_matches_tpuseg(target):
    """autotune_budget on 8 shapes frames at 64x64, batch 4: the same table
    (modes, costs, agreements, skips) and choice as tpuseg's, each side
    measuring its own segmenters; 1.1 walks the whole ladder and falls back
    to exact serving."""
    from tpuseg.data.shapes import shapes_video

    frames = list(shapes_video(8, (64, 64), seed=2)[0])
    got = autotune_budget(lambda **kw: _tseg(batch=4, **kw), frames, target_agreement=target,
                          batch=4)
    want = j_autotune(lambda **kw: _jseg(batch=4, **kw), frames, target_agreement=target,
                      batch=4)
    assert got == want
    if target > 1:
        assert got["choice"] is None and got["choice_kwargs"] == {}
