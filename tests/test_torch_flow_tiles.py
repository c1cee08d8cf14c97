"""The flow kernels' schedules (``tpuseg_torch/csrc/flow.cu``) in numpy,
held to ``tpuseg.video.flow`` on the CPU: K7's band tiles (a band of rows
inside one block row, the block row's shifts read once, each 8-byte half of
a 16-byte vector with its own source column and row; the byte path at other
scales) and K6's launch geometry, summation order and argmin on resized
luma.  The card holds the kernels themselves to their plain versions
(``chip_smoke.py`` phase 25)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_flow import _argmin_lanes, _shifts_loop
from tpuseg.video import flow as jflow
from tpuseg_torch.video import flow

torch.set_num_threads(2)

BAND_ROWS = 2  # kBandRows
MAX_SMEM = 227 * 1024


def _offset(s, pos, scale, extent, radius):
    """``source_offset``: s * scale where the shift is nonzero, within the
    radius and its source in [0, extent), else 0."""
    src = pos - s * scale
    ok = (s != 0) & (np.abs(s) <= radius) & (src >= 0) & (src < extent)
    return np.where(ok, s * scale, 0)


def _warp_bands(key, dy, dx, scale, block, radius=4):
    """K7's schedule: the vector path (scale % 8 == 0, w % 16 == 0) in bands
    of 2 rows, each 8-pixel half of a 16-byte vector moved as one; else the
    byte path in bands of 2 rows (1 where scale * block is odd).  Per band the block row's dx and dy are read once; each
    half's (or byte's) source column and its dy come from them once for the
    band, and only the row rule runs per row.  Returns (out, path)."""
    b, h, w = key.shape
    up = scale * block
    vec = scale % 8 == 0 and w % 16 == 0
    band, group = (BAND_ROWS, 8) if vec else (min(BAND_ROWS, up & -up), 1)
    assert up % band == 0 and h % band == 0
    out = np.empty_like(key)
    x = np.arange(0, w, group)
    for n in range(b):
        flat = key[n].ravel()
        for y0 in range(0, h, band):
            dxr, dyr = dx[n, y0 // up], dy[n, y0 // up]  # staged once a band
            xs = x - _offset(dxr[x // up], x, scale, w, radius)
            sy = dyr[xs // up]
            if vec:  # a half never straddles a block and moves whole
                assert (xs % 8 == 0).all() and ((xs + 7) // up == xs // up).all()
            for y in range(y0, y0 + band):
                ys = y - _offset(sy, y, scale, h, radius)
                src = (ys * w + xs)[:, None] + np.arange(group)
                out[n, y] = flat[src.ravel()]
    return out, "vector" if vec else "byte"


def _fields(case, rng, b, nby, nbx):
    """(dy, dx) int32 (b, nby, nbx) for a named K7 case."""
    shape = (b, nby, nbx)
    if case == "odd dx":  # sources 8 bytes off 16-byte alignment
        dx = rng.choice([-3, -1, 1, 3], size=shape)
        dy = rng.integers(-4, 5, size=shape)
    elif case == "edge halves":  # odd dx at the frame's edges splits a vector
        dx = np.zeros(shape, np.int64)
        dx[..., 0] = rng.choice([1, 3, 4], size=shape[:2])
        dx[..., -1] = rng.choice([-1, -3, -4], size=shape[:2])
        dx[..., 1:-1] = rng.choice([-4, 4], size=(b, nby, nbx - 2))
        dy = rng.integers(-4, 5, size=shape)
    elif case == "seams":  # neighbours' dy differ, sources cross the seam
        dx = rng.choice([-2, -1, 1, 2], size=shape)
        dy = np.where(np.arange(nbx) % 2 == 0, 3, -2) * np.ones(shape, np.int64)
    else:  # "out of radius"
        dx = rng.choice([-7, -5, -4, 0, 4, 5, 7], size=shape)
        dy = rng.choice([-6, -5, -1, 1, 5, 6], size=shape)
    return dy.astype(np.int32), dx.astype(np.int32)


@pytest.mark.parametrize("case", ["odd dx", "edge halves", "seams", "out of radius"])
def test_band_schedule_vector_path_equals_tpuseg(case):
    """(2, 256, 384) ids at scale 8, block 16 (a width a multiple of 128 but
    not of 256): the band schedule on the vector path equals tpuseg's warp,
    and so does the port's plain version."""
    rng = np.random.default_rng(["odd dx", "edge halves", "seams", "out of radius"].index(case))
    ids = rng.integers(0, 19, size=(2, 256, 384)).astype(np.uint8)
    dy, dx = _fields(case, rng, 2, 2, 3)
    want = np.asarray(jflow.warp_ids(jnp.asarray(ids), jnp.asarray(dy), jnp.asarray(dx),
                                     scale=8, block=16))
    got, path = _warp_bands(ids, dy, dx, 8, 16)
    assert path == "vector"
    np.testing.assert_array_equal(got, want)
    plain = flow.warp_ids(torch.from_numpy(ids), torch.from_numpy(dy), torch.from_numpy(dx),
                          scale=8, block=16)
    np.testing.assert_array_equal(plain.numpy(), want)
    if case == "edge halves":  # some vector had one half's source in the frame, one out
        x = np.arange(0, 384, 8)
        inside = (x - dx[0, 0, x // 128] * 8 >= 0) & (x - dx[0, 0, x // 128] * 8 < 384)
        assert (inside[0::2] != inside[1::2]).any()


@pytest.mark.parametrize("shape,scale,block", [((2, 128, 192), 4, 16), ((2, 64, 96), 4, 4),
                                               ((2, 48, 40), 8, 1), ((1, 36, 30), 1, 3)])
def test_band_schedule_byte_path_equals_tpuseg(shape, scale, block):
    """The byte path: scale 4, scale 8 on a width not a multiple of 16, and
    scale 1 x block 3 (bands of 1 row: 3-px blocks)."""
    rng = np.random.default_rng(11)
    b, h, w = shape
    up = scale * block
    ids = rng.integers(0, 19, size=shape).astype(np.uint8)
    dy = rng.integers(-6, 7, size=(b, h // up, w // up)).astype(np.int32)
    dx = rng.integers(-6, 7, size=(b, h // up, w // up)).astype(np.int32)
    want = np.asarray(jflow.warp_ids(jnp.asarray(ids), jnp.asarray(dy), jnp.asarray(dx),
                                     scale=scale, block=block))
    got, path = _warp_bands(ids, dy, dx, scale, block)
    assert path == "byte"
    np.testing.assert_array_equal(got, want)


def _round_up(v, m):
    return -(-v // m) * m


def _row_pitch(need):
    return need + (4 - need % 32) % 32


def _k6_geometry(radius, block, ws):
    """``launch_block_shifts``'s choices and the kernel's staged columns:
    (run, threads, window pitch, cur pitch, shared bytes, window float4s,
    cur float4s)."""
    k, wv = 2 * radius + 1, (4 + 2 * radius + 3) // 4
    run = min(ws // block, 288 // (4 * k), 128 // block)
    bw = _round_up(block, 4)
    pw = _row_pitch(_round_up(max(run * block + 2 * radius, (run - 1) * block + bw - 4 + 4 * wv),
                              4))
    pc = _row_pitch(_round_up((run - 1) * block + bw, 4))
    smem = 4 * ((block + 2 * radius) * pw + block * pc + run * k * k)
    cur4 = -(-((run - 1) * block + bw) // 4)
    return run, _round_up(run * k * 4, 32), pw, pc, smem, cur4 - 1 + wv, cur4


@pytest.mark.parametrize("radius", range(8))
def test_k6_geometry_fits(radius):
    """For every radius the kernel takes and every block up to 32 at a wide
    and a one-block grid: at least one block a CTA, at most 288 threads in
    whole warps, pitches of 4 mod 32 words, staged columns that hold every
    column a thread reads and fit the pitch, and shared memory within the
    card's 227 KB; the serving case (r = 4, block 16) is 8 blocks, 288
    threads, 26,784 bytes, 34 and 32 float4s a row staged."""
    for block in range(1, 33):
        for ws in (block, 16 * block):
            run, threads, pw, pc, smem, win4, cur4 = _k6_geometry(radius, block, ws)
            k, wv = 2 * radius + 1, (4 + 2 * radius + 3) // 4
            assert 1 <= run and run * k * 4 <= threads <= 288 and threads % 32 == 0
            assert pw % 32 == 4 and pc % 32 == 4
            last = (run - 1) * block + _round_up(block, 4) - 4  # a thread's last 4-column step
            assert last + 4 * wv <= 4 * win4 <= pw and last + 4 <= 4 * cur4 <= pc
            assert smem <= MAX_SMEM
    if radius == 4:
        assert _k6_geometry(4, 16, 256) == (8, 288, 164, 132, 26784, 34, 32)


def test_k6_schedule_on_resized_luma():
    """On resized (non-integer) luma K6 sums in its own order: on 8 frames
    of a 360x640 decode onto the 32x64 grid its schedule agrees with
    tpuseg's shifts on >= 0.99 of the blocks, as the plain version does."""
    rng = np.random.default_rng(4)
    f = rng.integers(0, 256, size=(8, 360, 640, 3), dtype=np.uint8)
    g = np.roll(f, (8, -8), axis=(1, 2))
    key = flow.pooled_luma(torch.from_numpy(f), grid=(32, 64)).numpy()
    cur = flow.pooled_luma(torch.from_numpy(g), grid=(32, 64)).numpy()
    want = jflow.estimate_block_shifts(jnp.asarray(key), jnp.asarray(cur))
    got = _shifts_loop(key, cur)
    agree = np.mean([(a == np.asarray(b)).mean() for a, b in zip(got, want)])
    assert agree >= 0.99, agree


def test_argmin_lanes_first_least():
    """The shuffle argmin is the first least index: ties at the ends, a
    tie between lanes 3 and 35, all equal, and a NaN (first, as
    torch.argmin)."""
    f32 = np.float32
    cases = [np.full(81, 5, f32), np.r_[f32(1), np.full(79, 5, f32), f32(1)].astype(f32),
             np.where(np.isin(np.arange(81), [3, 35]), f32(0), f32(2)).astype(f32)]
    for sad in cases:
        assert _argmin_lanes(sad) == int(np.argmin(sad))
    nan = np.full(81, 3, f32)
    nan[40], nan[70] = np.nan, f32(0)
    assert _argmin_lanes(nan) == int(torch.argmin(torch.from_numpy(nan))) == 40


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    """On CPU tensors both wrappers return their plain versions' outputs
    (dy, dx contiguous (B, hs/block, ws/block)) and count no launch."""
    flow.estimate_block_shifts.launches = flow.warp_ids.launches = 0
    rng = np.random.default_rng(9)
    key = torch.from_numpy(rng.integers(0, 40000, size=(2, 32, 64)).astype(np.float32))
    cur = torch.roll(key, (1, -2), dims=(1, 2))
    dy, dx = flow.estimate_block_shifts(key, cur)
    ry, rx = flow.estimate_block_shifts_reference(key, cur)
    assert dy.shape == dx.shape == (2, 2, 4) and dy.is_contiguous() and dx.is_contiguous()
    assert torch.equal(dy, ry) and torch.equal(dx, rx)
    ids = torch.from_numpy(rng.integers(0, 19, size=(2, 256, 512)).astype(np.uint8))
    assert torch.equal(flow.warp_ids(ids, dy, dx, scale=8, block=16),
                       flow.warp_ids_reference(ids, dy, dx, scale=8, block=16))
    assert (flow.estimate_block_shifts.launches, flow.warp_ids.launches) == (0, 0)
