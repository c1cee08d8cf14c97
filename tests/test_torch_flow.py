"""Port parity for the flow module (``tpuseg_torch/video/flow.py``): luma
pooling, K6's and K7's plain versions and the end-to-end warp, against
``tpuseg.video.flow`` on the same numpy-seeded inputs (f32, CPU).  A numpy
transcription of each kernel's loop (``csrc/flow.cu``) is held to
``tpuseg`` too, so the algorithm the card runs is checked here; the card
holds the kernels to their plain versions (``chip_smoke.py`` phase 25)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.video import flow as jflow
from tpuseg_torch.video import flow

torch.set_num_threads(2)


def _j(fn, *arrays, **kw):
    out = fn(*(jnp.asarray(a) for a in arrays), **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _t(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _shifts_loop(key, cur, radius=4, block=16, accept_frac=0.7):
    """K6's loop in numpy f32: per block, thread o sums shift o's |cur - key|
    row-major over the edge-clamped window; the first least SAD; accepted
    below f32(accept_frac) x the centre's SAD."""
    b, hs, ws = key.shape
    k = 2 * radius + 1
    dy = np.zeros((b, hs // block, ws // block), np.int32)
    dx = np.zeros_like(dy)
    f32 = np.float32
    for n in range(b):
        for by in range(hs // block):
            for bx in range(ws // block):
                ys = np.clip(np.arange(by * block - radius, (by + 1) * block + radius), 0, hs - 1)
                xs = np.clip(np.arange(bx * block - radius, (bx + 1) * block + radius), 0, ws - 1)
                win = key[n][np.ix_(ys, xs)]
                c = cur[n, by * block:(by + 1) * block, bx * block:(bx + 1) * block]
                sad = np.empty(k * k, np.float32)
                for o in range(k * k):
                    oy, ox = divmod(o, k)
                    s = f32(0)
                    for v in np.abs(c - win[oy:oy + block, ox:ox + block]).ravel():
                        s = f32(s + v)
                    sad[o] = s
                best = 0
                for o in range(1, k * k):
                    if sad[o] < sad[best]:
                        best = o
                if sad[best] < f32(accept_frac) * sad[radius * k + radius]:
                    dy[n, by, bx], dx[n, by, bx] = radius - best // k, radius - best % k
    return dy, dx


def _warp_gather(key, dy, dx, scale, block, radius=4):
    """K7's per-pixel gather in numpy: xs from the block's dx at (y, x),
    then the row from dy at (y, xs), each only where the shift is nonzero,
    within the radius and its source in the frame."""
    b, h, w = key.shape
    up = scale * block
    out = np.empty_like(key)

    def ok(s, pos, extent):
        return s != 0 and -radius <= s <= radius and 0 <= pos - s * scale < extent

    for n in range(b):
        for y in range(h):
            for x in range(w):
                sx = dx[n, y // up, x // up]
                xs = x - sx * scale if ok(sx, x, w) else x
                sy = dy[n, y // up, xs // up]
                ys = y - sy * scale if ok(sy, y, h) else y
                out[n, y, x] = key[n, ys, xs]
    return out


@pytest.mark.parametrize("layout", ["flat", "image"])
def test_downsample_and_pooled_luma_equal(layout):
    """Integer box sums equal tpuseg's; pooled_luma crops the <8-px
    remainder (a 70x100 decode) and returns f32."""
    rng = np.random.default_rng(0)
    f = rng.integers(0, 256, size=(3, 70, 100, 3), dtype=np.uint8)
    x = f.reshape(3, 70, 300) if layout == "flat" else f
    crop = np.ascontiguousarray(x[:, :64, :96] if layout == "image" else x[:, :64, :288])
    np.testing.assert_array_equal(flow.downsample_luma(torch.from_numpy(crop), 64, 96, 8).numpy(),
                                  np.asarray(jflow.downsample_luma(jnp.asarray(crop), 64, 96, 8)))
    got, want = _t(flow.pooled_luma, x), _j(jflow.pooled_luma, x)
    assert got.dtype == np.float32 and got.shape == (3, 8, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decode,grid", [
    ((64, 128), (16, 32)),    # grid equals the pooled size: no resize
    ((64, 128), (32, 64)),    # up
    ((256, 512), (16, 32)),   # down: antialiased in tpuseg
    ((360, 640), (32, 64)),   # down, non-integer scale (640x360 -> 256x512 target)
    ((200, 256), (32, 16)),   # up in one dim, down in the other
])
def test_pooled_luma_grid_resize(decode, grid):
    """The grid resize against jax.image.resize (antialias on by default):
    equal to f32 rounding, 1e-6 relative (measured at most 2.7e-7)."""
    rng = np.random.default_rng(1)
    f = rng.integers(0, 256, size=(2,) + decode + (3,), dtype=np.uint8)
    got = _t(flow.pooled_luma, f, grid=grid)
    want = _j(jflow.pooled_luma, f, grid=grid)
    assert got.shape == (2,) + grid
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_estimate_recovers_translation():
    """tests/test_video.py:316's case: interior blocks recover (2, -3); the
    whole map (edge-replicated border included) equals tpuseg's, and the
    kernel's loop agrees."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(2, 32, 32)).astype(np.float32)
    cur = np.roll(img, (2, -3), axis=(1, 2))
    got = _t(flow.estimate_block_shifts, img, cur, radius=4, block=8)
    want = _j(jflow.estimate_block_shifts, img, cur, radius=4, block=8)
    assert got[0].dtype == np.int32 and got[0].shape == (2, 4, 4)
    assert (got[0][:, 1:3, 1:3] == 2).all() and (got[1][:, 1:3, 1:3] == -3).all()
    for g, w, lp in zip(got, want, _shifts_loop(img, cur, 4, 8)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(lp, w)


@pytest.mark.parametrize("case", ["translated", "random", "constant", "periodic"])
def test_estimate_on_integer_luma_equal(case):
    """Serving defaults (r = 4, block 16) on pooled luma of 256x256 frames:
    a translated frame, unrelated frames, a constant map (all SADs tie: the
    first index, rejected by the gate) and a period-2 map (ties between
    shifts): dy and dx equal tpuseg's, and the kernel loop's."""
    rng = np.random.default_rng(3)
    f = rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8)
    key = _t(flow.pooled_luma, f)
    if case == "translated":
        cur = _t(flow.pooled_luma, np.roll(f, (16, -24), axis=(1, 2)))
    elif case == "random":
        cur = _t(flow.pooled_luma, rng.integers(0, 256, size=f.shape, dtype=np.uint8))
    elif case == "constant":
        key = np.full_like(key, 1000.0)
        cur = np.full_like(key, 900.0)
    else:
        key = np.tile(np.array([[0.0, 765.0]], np.float32), (2, 32, 16))
        cur = np.roll(key, 1, axis=2) + 1.0
    got = _t(flow.estimate_block_shifts, key, cur)
    want = _j(jflow.estimate_block_shifts, key, cur)
    loop = _shifts_loop(key, cur)
    for g, w, lp in zip(got, want, loop):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(lp, w)
    if case == "translated":
        assert (got[0][:, 1:-1, 1:-1] == 2).all() and (got[1][:, 1:-1, 1:-1] == -3).all()


def test_estimate_on_resized_luma():
    """Resized (non-integer) luma sums in an order each side picks: on 8
    frames of a 360x640 decode onto the 32x64 grid, shifts agree with
    tpuseg on >= 0.99 of the blocks (measured: all of them)."""
    rng = np.random.default_rng(4)
    f = rng.integers(0, 256, size=(8, 360, 640, 3), dtype=np.uint8)
    g = np.roll(f, (8, -8), axis=(1, 2))
    key = _t(flow.pooled_luma, f, grid=(32, 64))
    cur = _t(flow.pooled_luma, g, grid=(32, 64))
    got = _t(flow.estimate_block_shifts, key, cur)
    want = _j(jflow.estimate_block_shifts, jnp.asarray(key), jnp.asarray(cur))
    agree = np.mean([(a == b).mean() for a, b in zip(got, want)])
    assert agree >= 0.99, agree


@pytest.mark.parametrize("scale,block,h,w", [(8, 16, 256, 384), (4, 4, 64, 64), (2, 4, 32, 48),
                                             (1, 8, 32, 32)])
def test_warp_ids_equal(scale, block, h, w):
    """Random shift fields in [-6, 6] (out-of-radius shifts included), every
    block its own: K7's plain version and its gather equal tpuseg's."""
    rng = np.random.default_rng(5)
    up = scale * block
    ids = rng.integers(0, 19, size=(2, h, w)).astype(np.uint8)
    dy = rng.integers(-6, 7, size=(2, h // up, w // up)).astype(np.int32)
    dx = rng.integers(-6, 7, size=(2, h // up, w // up)).astype(np.int32)
    want = _j(jflow.warp_ids, ids, dy, dx, scale=scale, block=block)
    np.testing.assert_array_equal(_t(flow.warp_ids, ids, dy, dx, scale=scale, block=block), want)
    if h * w <= 64 * 64:
        np.testing.assert_array_equal(_warp_gather(ids, dy, dx, scale, block), want)


def test_warp_ids_seam_and_range_semantics():
    """tests/test_video.py:460's contract: dy sampled at the source column
    (two block columns, the right one (2, -1)); a shift outside the radius
    keeps the copy."""
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 19, size=(1, 32, 32)).astype(np.uint8)
    dy = np.array([[[0, 2], [0, 2]]], np.int32)
    dx = np.array([[[0, -1], [0, -1]]], np.int32)
    got = _t(flow.warp_ids, ids, dy, dx, scale=4, block=4)
    np.testing.assert_array_equal(got, _j(jflow.warp_ids, ids, dy, dx, scale=4, block=4))
    np.testing.assert_array_equal(_warp_gather(ids, dy, dx, 4, 4), got)
    a = ids[0]
    for y in range(32):
        for x in range(32):
            sx = x + 4 if x >= 16 and x + 4 < 32 else x
            sy = y - 8 if sx >= 16 and y >= 8 else y
            assert got[0, y, x] == a[sy, sx], (y, x)
    big = np.array([[[0, 7], [0, 7]]], np.int32)
    np.testing.assert_array_equal(_t(flow.warp_ids, ids, big, dx * 0, scale=4, block=4)[0], a)


@pytest.mark.parametrize("layout", ["image", "flat"])
def test_warp_key_ids_to_frames_equal(layout):
    """tests/test_video.py:357's end-to-end case at serving defaults: a
    keyframe paired with itself is the identity; a (8, -16) translation
    warps the ids as tpuseg's chain does, in both frame layouts."""
    rng = np.random.default_rng(7)
    key = rng.integers(0, 256, size=(1, 128, 128, 3), dtype=np.uint8)
    ids = rng.integers(0, 19, size=(1, 128, 128)).astype(np.uint8)
    cur = np.roll(key, (8, -16), axis=(1, 2))
    if layout == "flat":
        key, cur = key.reshape(1, 128, 384), cur.reshape(1, 128, 384)
    np.testing.assert_array_equal(_t(flow.warp_key_ids_to_frames, ids, key, key), ids)
    got = _t(flow.warp_key_ids_to_frames, ids, key, cur)
    np.testing.assert_array_equal(got, _j(jflow.warp_key_ids_to_frames, ids, key, cur))
    rowp = np.concatenate([ids[:, :8], ids[:, :-8]], axis=1)
    np.testing.assert_array_equal(got, np.concatenate([rowp[:, :, 16:], rowp[:, :, -16:]], axis=2))


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    """On CPU tensors the wrappers run their plain versions (no launch
    counted) and reject what the kernels would not take."""
    flow.estimate_block_shifts.launches = flow.warp_ids.launches = 0
    key = torch.zeros((1, 32, 32))
    dy, dx = flow.estimate_block_shifts(key, key)
    flow.warp_ids(torch.zeros((1, 256, 256), dtype=torch.uint8), dy, dx, scale=8, block=16)
    assert (flow.estimate_block_shifts.launches, flow.warp_ids.launches) == (0, 0)
    with pytest.raises(ValueError, match="f32"):
        flow.estimate_block_shifts(key.double(), key.double())
    with pytest.raises(ValueError, match="16-blocks"):
        flow.estimate_block_shifts(torch.zeros((1, 24, 32)), torch.zeros((1, 24, 32)))
    with pytest.raises(ValueError, match="128-px"):
        flow.warp_ids(torch.zeros((1, 96, 128), dtype=torch.uint8), dy, dx, scale=8, block=16)
    with pytest.raises(ValueError, match="int32"):
        flow.warp_ids(torch.zeros((1, 256, 256), dtype=torch.uint8), dy.long(), dx, scale=8,
                      block=16)
