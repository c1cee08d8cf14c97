"""Port parity for the one-launch keyframe choices (CPU): the budgeted
mode's K3 + K4 entry ``frame_deltas_budget`` against ``tpuseg``'s
``program_budget`` selection and against ``frame_deltas`` followed by
``budget_select``; a numpy model of K5's chunked pair schedule
(``csrc/temporal.cu``: a chunk's live keyframe, the pair sums S[key, i] and
S[j, i], the key moving to j on a promotion) against
``keyframe_select_reference`` and ``tpuseg``'s sequential scan; the buffers
the CUDA wrappers carve their outputs from; the argument checks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.ops import temporal
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter

torch.set_num_threads(2)

MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
CHUNK = 8  # K5's frames a pass (kChunk in csrc/temporal.cu)


def _frames(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=shape, dtype=np.uint8) for _ in range(n)]


def _blend(a, b, t):
    return np.clip(a.astype(np.float32) * (1 - t) + b.astype(np.float32) * t, 0,
                   255).astype(np.uint8)


def _sequence(n, shape, seed, cuts=(), drift=0.04):
    """n frames drifting from scene to scene: a new random scene at each
    index in ``cuts``, a blend step of ``drift`` towards the next one
    between them."""
    rng = np.random.default_rng(seed)
    scene = lambda: rng.integers(0, 256, size=shape, dtype=np.uint8)  # noqa: E731
    a, b, t, out = scene(), scene(), 0.0, []
    for i in range(n):
        if i in cuts:
            a, b, t = scene(), scene(), 0.0
        out.append(_blend(a, b, t))
        t += drift
    return out


def _k5_chunk_model(frames, carried, n, thresh, chunk=CHUNK):
    """K5 as csrc/temporal.cu schedules it, in numpy: frames in chunks; a
    chunk's pair sums S[r, i] (r = 0 the chunk's live keyframe, r = j + 1
    its frame j < i), each the exact integer sum of |differences| summed
    per 4-byte lane; then the scan over the chunk, reading S[key, i] and
    moving the key to i on a promotion.  Returns keyframe_select's outputs
    as numpy: (flags, keyslot, fwd_idx[:count], diffs, count, n, keyframe)."""
    t = np.float32(thresh)
    f = np.stack(frames).reshape(len(frames), -1)
    kflat = carried.reshape(-1)
    nb, size = f.shape
    key, used = -1, 0
    flags, keyslot, fwd, diffs = [], [], [], []
    for start in range(0, nb, chunk):
        c = min(chunk, nb - start)
        rows = [kflat if key < 0 else f[key]] + [f[start + j] for j in range(c)]
        pairs = {}
        for i in range(c):
            for r in range(i + 1):
                lanes = np.abs(f[start + i].astype(np.int64) - rows[r].astype(np.int64))
                pairs[r, i] = int(lanes.sum())
        r = 0
        for i in range(c):
            diff = np.float32(pairs[r, i] / size)
            run = n == 0 or diff > t
            if run:
                fwd.append(start + i)
                used, n, r = used + 1, n + 1, i + 1
            flags.append(run)
            keyslot.append(used - 1)
            diffs.append(diff)
        if r:
            key = start + r - 1
    kf = kflat if key < 0 else f[key]
    return (np.array(flags), np.array(keyslot, np.int32), np.array(fwd, np.int32),
            np.array(diffs, np.float32), used, n, kf.reshape(carried.shape))


def _tpuseg_scan(frames, carried, n, thresh):
    """program_adaptive's choice (tpuseg/video/pipeline.py:614-634), its
    diff the f32 jnp.mean of the int16 |difference|: (flags, n)."""
    kf, flags = carried, []
    for f in frames:
        diff = jnp.mean(jnp.abs(jnp.asarray(f).astype(jnp.int16)
                                - jnp.asarray(kf).astype(jnp.int16)).astype(jnp.float32))
        run = n == 0 or bool(diff > thresh)
        if run:
            kf, n = f, n + 1
        flags.append(run)
    return np.array(flags), n


def _margin(frames, carried, flags, thresh):
    """The least distance of a chosen diff from the threshold, so that
    tpuseg's f32 mean and the exact sum decide alike where it is > 1e-3."""
    kf, out = carried, []
    for f, run in zip(frames, flags):
        out.append(abs(np.abs(f.astype(np.int16) - kf.astype(np.int16)).mean() - thresh))
        kf = f if run else kf
    return min(out)


def _k5_case(name):
    """(frames, carried, n_keyed, thresh) of a named case; frames of 16x48
    bytes, or 5x7 (not a multiple of 16 bytes, K5's byte path)."""
    shape = (5, 7) if name == "bytes" else (16, 48)
    b = {"b1": 1, "b7": 7, "b8": 8, "b9": 9, "b17": 17, "b32": 32, "bytes": 17,
         "n0": 9, "cuts": 32, "tie": 9, "chunk_end": 17}[name]
    if name == "tie":  # constant frames: every diff an exact integer
        vals = [12, 14, 15, 13, 10, 16, 12, 11, 15]
        return [np.full(shape, v, np.uint8) for v in vals], np.full(shape, 10, np.uint8), 1, 2.0
    if name == "chunk_end":  # cuts on the last frame of each chunk
        return _sequence(b, shape, 7, cuts=(7, 15), drift=0.0), _frames(1, shape, 8)[0], 3, 20.0
    seed = sum(map(ord, name))
    cuts = {"cuts": (3, 8, 9, 16, 24, 31)}.get(name, (b // 2,))
    frames = _sequence(b, shape, seed, cuts=cuts)
    carried = frames[0] if name != "b32" else _frames(1, shape, seed + 1)[0]
    return frames, carried, 0 if name in ("n0", "b1") else 2, 9.0


K5_CASES = ["b1", "b7", "b8", "b9", "b17", "b32", "bytes", "n0", "cuts", "tie", "chunk_end"]


@pytest.mark.parametrize("name", K5_CASES)
def test_k5_chunk_model_matches_reference_and_tpuseg(name):
    """The chunked pair schedule gives keyframe_select_reference's outputs
    bit for bit (flags, slots, promoted indices, diffs, count, n, the new
    keyframe) and tpuseg's scan's flags and count, at B in {1, 7, 8, 9, 17,
    32}, from n_keyed = 0, across scene cuts, on diffs exactly at the
    threshold and with promotions on a chunk's last frame."""
    frames, carried, n0, thresh = _k5_case(name)
    got = _k5_chunk_model(frames, carried, n0, thresh)
    want = temporal.keyframe_select_reference(
        torch.from_numpy(np.stack(frames)), torch.from_numpy(carried),
        torch.tensor([n0], dtype=torch.int32), thresh)
    flags, keyslot, fwd, diffs, count, n, kf = got
    np.testing.assert_array_equal(flags, want[0].numpy())
    np.testing.assert_array_equal(keyslot, want[1].numpy())
    assert count == int(want[4]) and n == int(want[5])
    np.testing.assert_array_equal(fwd, want[2][:count].numpy())
    np.testing.assert_array_equal(diffs, want[3].numpy())
    np.testing.assert_array_equal(kf, want[6].numpy())
    if name != "tie":
        assert _margin(frames, carried, flags, thresh) > 1e-3
    j_flags, j_n = _tpuseg_scan(frames, carried, n0, thresh)
    np.testing.assert_array_equal(flags, j_flags)
    assert n == j_n
    if name == "tie":  # 12-10 = 2 stays, 14-10 = 4 promotes, then |v - 14| vs 2
        np.testing.assert_array_equal(flags, [False, True, False, False, True, True, True,
                                              False, True])
    if name == "chunk_end":  # each cut promotes, and the next chunk keys on it
        assert {7, 15} <= set(fwd.tolist()) and keyslot[8] == keyslot[7]
    if name == "n0":
        assert flags[0]


def test_k5_chunk_model_matches_tpuseg_program():
    """tpuseg's own sequential program (batch 9: a full chunk and a ragged
    one, two batches, so the keyframe crosses a batch) chooses the frames
    the chunked model does, carried batch to batch; the port's sequential
    mode on the CPU too."""
    frames = _sequence(18, (64, 64, 3), 3, cuts=(5, 8, 13), drift=0.05)
    thresh, b = 20.0, 9
    jseg = JSegmenter(*j_init(0, "drn_d_22", 19), MEAN, STD, compute_dtype=None, batch=b,
                      temporal_thresh=thresh)
    carry = jseg._make_carry(64, 64)
    j_flags = []
    for i in range(0, len(frames), b):
        arr = np.stack(frames[i:i + b]).reshape(b, 64, -1)
        _, f, carry = jseg._program(jseg.params, jseg.bn_state, jnp.asarray(arr), *carry)
        j_flags.append(np.asarray(f))
    kf, n, flags = np.zeros((64, 192), np.uint8), 0, []
    for i in range(0, len(frames), b):
        fl, _, _, _, _, n, kf = _k5_chunk_model([x.reshape(64, -1) for x in frames[i:i + b]],
                                                kf, n, thresh)
        flags.append(fl)
    np.testing.assert_array_equal(np.concatenate(flags), np.concatenate(j_flags))
    assert 2 < n < len(frames) and n == int(carry[2])
    tseg = TSegmenter(*init_drnseg(0, "drn_d_22", 19), MEAN, STD, device="cpu",
                      compute_dtype=torch.float32, batch=b, temporal_thresh=thresh)
    temporal.keyframe_select.launches = 0
    seq_flags = [tseg._call(torch.from_numpy(np.stack(frames[i:i + b]).reshape(b, 64, -1)))[2]
                 for i in range(0, len(frames), b)]
    np.testing.assert_array_equal(torch.cat(seq_flags).numpy(), np.concatenate(j_flags))
    assert temporal.keyframe_select.launches == 0


def _budget_case():
    """Three batches of 4 at 64x64 over A/B/C scenes with slow drift."""
    frames = _sequence(12, (64, 64, 3), 11, cuts=(2, 5, 9), drift=0.03)
    return frames, 6.0


@pytest.mark.parametrize("budget", [1, 2])
def test_frame_deltas_budget_matches_tpuseg(budget):
    """The fused entry on CPU tensors, chained through its carry, selects
    the frames tpuseg's program_budget does (flags, promotions a batch, the
    carried count, the drift within f32 rounding of tpuseg's f32 means),
    equals frame_deltas followed by budget_select exactly, and launches
    nothing."""
    frames, thresh = _budget_case()
    b = 4
    jseg = JSegmenter(*j_init(0, "drn_d_22", 19), MEAN, STD, compute_dtype=None, batch=b,
                      temporal_thresh=thresh, temporal_budget=budget)
    carry = jseg._make_carry(64, 64)
    prev = torch.zeros((64, 192), dtype=torch.uint8)
    acc, nk = torch.zeros(1), torch.zeros(1, dtype=torch.int32)
    counters = (temporal.frame_deltas_budget, temporal.frame_deltas, temporal.budget_select)
    for f in counters:
        f.launches = 0
    for i in range(0, len(frames), b):
        arr = np.stack(frames[i:i + b]).reshape(b, 64, -1)
        _, j_flags, carry = jseg._program(jseg.params, jseg.bn_state, jnp.asarray(arr), *carry)
        x = torch.from_numpy(arr)
        got = temporal.frame_deltas_budget(x, prev, acc, nk, thresh, budget)
        d = temporal.frame_deltas(x, prev)
        want = (d, *temporal.budget_select(d, acc, nk, thresh, budget))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        d, flags, fwd_idx, keyslot, acc, nk = got
        np.testing.assert_array_equal(flags.numpy(), np.asarray(j_flags))
        assert int(nk) == int(carry[3])
        np.testing.assert_allclose(acc.numpy(), np.asarray(carry[2]).reshape(1), rtol=1e-5,
                                   atol=1e-6)
        promoted = np.flatnonzero(flags.numpy())
        assert len(promoted) <= budget
        np.testing.assert_array_equal(fwd_idx.numpy()[:len(promoted)], promoted)
        np.testing.assert_array_equal(keyslot.numpy(), np.cumsum(flags.numpy()) - 1)
        prev = x[-1]
    assert int(nk) > 2
    assert [f.launches for f in counters] == [0, 0, 0]


def test_budget_step_runs_the_fused_entry():
    """VideoSegmenter's budgeted step calls the fused entry once a batch
    (its CPU plain version here, so no launch is counted)."""
    frames, thresh = _budget_case()
    tseg = TSegmenter(*init_drnseg(0, "drn_d_22", 19), MEAN, STD, device="cpu",
                      compute_dtype=torch.float32, batch=4, temporal_thresh=thresh,
                      temporal_budget=2)
    calls = []
    orig = temporal.frame_deltas_budget
    import tpuseg_torch.video.pipeline as pipeline

    pipeline.frame_deltas_budget = lambda *a: calls.append(a[0].shape[0]) or orig(*a)
    try:
        temporal.frame_deltas_budget.launches = 0
        out = tseg.run(frames[:8], need_color=False)
    finally:
        pipeline.frame_deltas_budget = orig
    assert calls == [4, 4, 4]  # run()'s untimed first call, then the two batches
    assert out["promoted"] >= 2 and temporal.frame_deltas_budget.launches == 0


@pytest.mark.parametrize("n,budget,nb,scratch", [(1, 1, 1, 36), (5, 2, 9, 36 * 264),
                                                  (32, 8, 17, 36 * 1056)])
def test_output_buffers_are_disjoint_and_aligned(n, budget, nb, scratch):
    """The CUDA wrappers' outputs are views of one buffer each: the shapes
    and dtypes the callers expect, each view at a multiple of its item size
    and no two overlapping."""
    views = {"budget": temporal._budget_buffers(n, budget, "cpu"),
             "keyframe": temporal._keyframe_buffers(nb, scratch, "cpu")}
    want = {"budget": [(torch.int64, n + 1), (torch.float32, n), (torch.bool, n),
                       (torch.int32, budget), (torch.int32, n), (torch.float32, 1),
                       (torch.int32, 1)],
            "keyframe": [(torch.int64, scratch), (torch.int32, 3), (torch.bool, nb),
                         (torch.int32, nb), (torch.int32, nb), (torch.float32, nb)]}
    for kind, vs in views.items():
        assert [(v.dtype, v.numel()) for v in vs] == want[kind]
        base = vs[0].untyped_storage().data_ptr()
        spans = []
        for v in vs:
            assert v.untyped_storage().data_ptr() == base and v.is_contiguous()
            start = v.data_ptr() - base
            assert start % v.element_size() == 0
            spans.append((start, start + v.numel() * v.element_size()))
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= vs[0].untyped_storage().nbytes()


def _checks():
    x = torch.zeros((4, 8, 6), dtype=torch.uint8)
    acc, nk = torch.zeros(1), torch.zeros(1, dtype=torch.int32)
    return x, x[0], acc, nk


@pytest.mark.parametrize("case,match", [
    ("float frames", "uint8"),
    ("prev shape", "one frame"),
    ("budget 0", "budget 0"),
    ("budget > B", "budget 5"),
    ("acc0 f64", "acc0 must be one f32"),
    ("n_keyed two values", "n_keyed one int32"),
    ("meta device", "unsupported device"),
])
def test_frame_deltas_budget_argument_checks(case, match):
    x, prev, acc, nk = _checks()
    args = {"float frames": (x.float(), prev, acc, nk, 1.0, 2),
            "prev shape": (x, prev[1:], acc, nk, 1.0, 2),
            "budget 0": (x, prev, acc, nk, 1.0, 0),
            "budget > B": (x, prev, acc, nk, 1.0, 5),
            "acc0 f64": (x, prev, acc.double(), nk, 1.0, 2),
            "n_keyed two values": (x, prev, acc, torch.zeros(2, dtype=torch.int32), 1.0, 2),
            "meta device": (x.to("meta"), prev.to("meta"), acc.to("meta"), nk.to("meta"),
                            1.0, 2)}[case]
    with pytest.raises((TypeError, ValueError), match=match):
        temporal.frame_deltas_budget(*args)


@pytest.mark.parametrize("case,match", [
    ("empty batch", "at least one frame"),
    ("n_keyed int64", "n_keyed must be one int32"),
    ("carried shape", "one frame"),
    ("meta device", "unsupported device"),
])
def test_keyframe_select_argument_checks(case, match):
    x, prev, _, nk = _checks()
    args = {"empty batch": (x[:0], prev, nk),
            "n_keyed int64": (x, prev, nk.long()),
            "carried shape": (x, prev[:, 1:], nk),
            "meta device": (x.to("meta"), prev.to("meta"), nk.to("meta"))}[case]
    with pytest.raises((TypeError, ValueError), match=match):
        temporal.keyframe_select(*args, 1.0)
