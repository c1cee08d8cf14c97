"""K8's schedule (``tpuseg_torch/csrc/yuv.cu``) in numpy, held to
``tpuseg.video.yuv.i420_to_rgb_flat`` on the CPU bit for bit: row-pair tiles
(one chroma row of one frame a CTA), the vector path's 16-column groups
(two 16-byte Y words, one 8-byte U and V word, each chroma sample's four
products computed once, the output staged a warp at a time and stored in
16-byte chunks), the byte path (a 2x2 block a thread), the kernel's
byte <-> float conversions, ``k8_vector_path`` and the C entry's limits.
The card holds the kernel itself to its plain version (``chip_smoke.py``
phase 25)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.video import yuv as jyuv
from tpuseg_torch.video import yuv

torch.set_num_threads(2)

F32 = np.float32
U32 = np.uint32
SOURCE = Path(yuv.__file__).resolve().parent.parent / "csrc" / "yuv.cu"
MAX_GRID_YZ, VEC_THREADS, BYTE_THREADS, INT_MAX = 65535, 128, 256, 2 ** 31 - 1
LUMA, CHROMA, ROUND = F32(8388608.0), F32(8388736.0), F32(12582912.0)


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm``: byte k of the result is byte nibble k of s of
    the eight bytes (y << 32) | x (selectors below 8: no sign replication)."""
    v = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for k in range(4):
        sel = (s >> (4 * k)) & 0xF
        assert sel < 8
        out |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(U32)


def _byte_f(word, i, bias):
    """``byte_f``: byte i of ``word`` put in the mantissa of 2^23, less
    ``bias`` (2^23 for luma, 2^23 + 128 for chroma)."""
    return _byte_perm(word, U32(0x4B000000), 0x7540 | i).view(F32) - bias


def _u8_bits(v):
    """``u8_of``: clip to [0, 255], then + 1.5 * 2^23 rounds half to even
    into the low byte of the bits."""
    return (np.minimum(np.maximum(v, F32(0)), F32(255)) + ROUND).view(U32)


def _pack4(a, b, c, d):
    return _byte_perm(_byte_perm(a, b, 0x0040), _byte_perm(c, d, 0x0040), 0x5410)


class _Products:
    """``chroma``: the four products of a (u, v) sample, counting samples."""

    def __init__(self):
        self.samples = 0

    def __call__(self, u, v):
        self.samples += np.size(u)
        return F32(1.402) * v, F32(0.344136) * u, F32(0.714136) * v, F32(1.772) * u


def _rgb(y, c):
    """``rgb``: one pixel's three channels (low bytes of the bits)."""
    dr, gu, gv, db = c
    return _u8_bits(y + dr), _u8_bits((y - gu) - gv), _u8_bits(y + db)


def _words(row_bytes):
    """Little-endian 32-bit words of a (groups, 4k) uint8 array."""
    return np.ascontiguousarray(row_bytes).view("<u4")


def entry(n, h, w, in_ptr=0, out_ptr=0):
    """The C entry ``tpuseg_i420_to_rgb`` in Python: raises ValueError where
    it returns cudaErrorInvalidValue, else (path, grid (x, y, z), threads)."""
    if n <= 0 or h <= 0 or w <= 0 or h % 4 or w % 2:
        raise ValueError(f"not an I420 shape: {n} x {h}x{w}")
    if n > MAX_GRID_YZ or h // 2 > MAX_GRID_YZ or 3 * h * w > INT_MAX:
        raise ValueError(f"beyond K8's limits: {n} x {h}x{w}")
    if w % 16 == 0 and in_ptr % 16 == 0 and out_ptr % 16 == 0:
        groups = w // 16
        threads = min(VEC_THREADS, -(-groups // 32) * 32)
        return "vector", (-(-groups // threads), h // 2, n), threads
    threads = min(BYTE_THREADS, -(-(w // 2) // 32) * 32)
    return "byte", (-(-(w // 2) // threads), h // 2, n), threads


def _schedule(x, in_ptr=0, out_ptr=0):
    """K8 run tile by tile: each (frame, chroma row) CTA as the kernel does
    it, vectorized over the row's threads.  Returns (out, path, chroma
    samples whose products were computed); asserts each output byte is
    written exactly once."""
    n, rows, w = x.shape
    h = rows * 2 // 3
    path, grid, threads = entry(n, h, w, in_ptr, out_ptr)
    assert grid[1:] == (h // 2, n)
    assert grid[0] * threads >= (w // 16 if path == "vector" else w // 2)
    plane = h * w
    out = np.zeros((n, h * w * 3), np.uint8)
    written = np.zeros(out.shape, np.int32)
    products = _Products()
    for b in range(n):
        f = x[b].ravel()
        o, seen = out[b], written[b]
        for cy in range(h // 2):
            base = 2 * cy * 3 * w
            if path == "vector":
                groups = w // 16
                ya = _words(f[2 * cy * w:(2 * cy + 1) * w].reshape(groups, 16))
                yb = _words(f[(2 * cy + 1) * w:(2 * cy + 2) * w].reshape(groups, 16))
                c = plane + cy * (w // 2)
                uu = _words(f[c:c + w // 2].reshape(groups, 8))
                vv = _words(f[c + plane // 4:c + plane // 4 + w // 2].reshape(groups, 8))
                cs = [products(_byte_f(uu[:, k >> 2], k & 3, CHROMA),
                               _byte_f(vv[:, k >> 2], k & 3, CHROMA)) for k in range(8)]
                for j, ys in enumerate((ya, yb)):
                    px = [ch for p in range(16)
                          for ch in _rgb(_byte_f(ys[:, p >> 2], p & 3, LUMA), cs[p >> 1])]
                    words = np.stack([_pack4(*px[4 * i:4 * i + 4]) for i in range(12)], 1)
                    lane_bytes = words.astype("<u4").view(np.uint8)  # (groups, 48)
                    for g0 in range(0, groups, 32):  # a warp: stage, then 16-byte chunks
                        active = min(32, groups - g0)
                        stage = lane_bytes[g0:g0 + active].reshape(3 * active, 16)
                        for lane in range(32):
                            for k in range(3):
                                chunk = lane + 32 * k
                                if chunk < 3 * active:
                                    at = base + j * 3 * w + 48 * g0 + 16 * chunk
                                    o[at:at + 16] = stage[chunk]
                                    seen[at:at + 16] += 1
            else:
                cx = np.arange(w // 2)
                c = plane + cy * (w // 2) + cx
                cs = products(f[c].astype(F32) - F32(128), f[c + plane // 4].astype(F32) - F32(128))
                for q in range(4):
                    yq = f[(2 * cy + (q >> 1)) * w + 2 * cx + (q & 1)].astype(F32)
                    at = base + (q >> 1) * 3 * w + 6 * cx + 3 * (q & 1)
                    for ch, bits in enumerate(_rgb(yq, cs)):
                        o[at + ch] = (bits & U32(0xFF)).astype(np.uint8)
                        seen[at + ch] += 1
    assert (written == 1).all()
    return out.reshape(n, h, 3 * w), path, products.samples


def _tpuseg(x):
    return np.asarray(jyuv.i420_to_rgb_flat(jnp.asarray(x)))


@pytest.mark.parametrize("n,h,w,offset,path", [
    (2, 4, 16, 0, "vector"), (1, 360, 640, 0, "vector"),
    (1, 8, 2048, 0, "vector"), (2, 4, 18, 0, "byte"), (2, 8, 130, 0, "byte"),
    (1, 8, 854, 0, "byte"), (2, 8, 64, 1, "byte")])
def test_schedule_equals_tpuseg(n, h, w, offset, path):
    """Row-pair tiles on each path equal tpuseg's function bit for bit, and
    the products are computed once a chroma sample: widths whose 16-column
    groups fill whole warps (2048), part of one (16: 1 lane; 640: a second
    warp of 8) or none (18, 130, 854: the byte path), and a
    16-multiple width whose input lies one byte off 16-byte alignment (the
    byte path)."""
    rng = np.random.default_rng(h * w + offset)
    x = rng.integers(0, 256, size=(n, h * 3 // 2, w), dtype=np.uint8)
    x[0, :h // 2] = 255  # clipping at both ends alongside random planes
    x[-1, h - 2:h] = 0
    got, took, samples = _schedule(x, in_ptr=offset)
    assert took == path
    assert samples == n * (h // 2) * (w // 2)
    want = _tpuseg(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(yuv.i420_to_rgb_flat(torch.from_numpy(x)).numpy(), want)


def test_every_yuv_triple():
    """The kernel's arithmetic (``byte_f``, each sample's products once,
    ``rgb``, ``u8_of``) on every (Y, U, V) triple equals tpuseg's expression
    evaluated op by op in f32 (``tpuseg/video/yuv.py:94-98``: each product
    and sum rounded on its own, round half to even, clip), which
    ``test_schedule_equals_tpuseg`` and ``test_torch_transport.py`` hold to
    tpuseg's function; the card runs the same sweep through the kernel
    (phase 25)."""
    uv = np.arange(256 * 256, dtype=U32)
    u8, v8 = uv >> U32(8), uv & U32(0xFF)
    products = _Products()
    cs = products(_byte_f(u8, 0, CHROMA), _byte_f(v8, 0, CHROMA))
    u, v = u8.astype(F32) - F32(128), v8.astype(F32) - F32(128)
    for y0 in range(0, 256, 32):
        y8 = np.arange(y0, y0 + 32, dtype=U32)[:, None]
        got = np.stack([(c & U32(0xFF)).astype(np.uint8)
                        for c in _rgb(_byte_f(y8, 0, LUMA), cs)], -1)
        y = y8.astype(F32)
        want = np.stack([y + F32(1.402) * v, y - F32(0.344136) * u - F32(0.714136) * v,
                         y + F32(1.772) * u], -1)
        np.testing.assert_array_equal(got, np.clip(np.round(want), 0, 255).astype(np.uint8))
    assert products.samples == 256 * 256


def test_conversions():
    """``byte_f`` is exact for every byte in every position of a word (the
    PRMT selector) for luma and chroma; ``u8_of`` equals rint (half to even)
    then clip on [-400, 700] in steps of 1/8, every tie included."""
    b = np.arange(256, dtype=U32)
    for i in range(4):
        word = b << U32(8 * i) | U32(0x5A5A5A5A & ~(0xFF << (8 * i)))
        np.testing.assert_array_equal(_byte_f(word, i, LUMA), b.astype(F32))
        np.testing.assert_array_equal(_byte_f(word, i, CHROMA), b.astype(F32) - F32(128))
    v = np.arange(-3200, 5601, dtype=F32) / F32(8)
    want = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal((_u8_bits(v) & U32(0xFF)).astype(np.uint8), want)
    bytes_ = [U32(0x4B400000 | k) for k in (0x11, 0x22, 0x33, 0x44)]
    assert _pack4(*bytes_) == U32(0x44332211)


def _view(n, h, w, offset):
    """A contiguous (n, h*3/2, w) uint8 tensor whose data starts ``offset``
    bytes into a fresh allocation, and an output for it."""
    size = n * (h * 3 // 2) * w
    x = torch.zeros(size + offset, dtype=torch.uint8)[offset:].view(n, h * 3 // 2, w)
    return x, torch.empty((n, h, 3 * w), dtype=torch.uint8)


@pytest.mark.parametrize("w,offset,vector", [
    (16, 0, True), (48, 0, True), (640, 0, True), (2048, 0, True),
    (18, 0, False), (130, 0, False), (854, 0, False), (64, 1, False)])
def test_k8_vector_path(w, offset, vector):
    """``k8_vector_path`` is the C entry's test: W % 16 == 0 and both
    pointers 16-byte aligned; a contiguous view one byte off takes the byte
    path."""
    x, out = _view(2, 4, w, offset)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset
    assert yuv.k8_vector_path(x, out) is vector
    assert entry(2, 4, w, x.data_ptr(), out.data_ptr())[0] == ("vector" if vector else "byte")


@pytest.mark.parametrize("n,h,w,ok", [
    (65535, 4, 16, True), (65536, 4, 16, False), (1, 131068, 16, True),
    (1, 131072, 16, False), (1, 4, 178956970, True), (1, 4, 178956972, False),
    (8, 1024, 2048, True), (1, 6, 16, False), (1, 4, 15, False), (0, 4, 16, False)])
def test_entry_limits(n, h, w, ok):
    """The C entry's limits, mirrored: H/2 and B at most 65,535 (the grid's
    y and z), 3*H*W below 2^31, H % 4 == 0, W even, B > 0; the mirror's
    constants are the source's."""
    src = SOURCE.read_text()
    for name, value in (("kMaxGridYZ", MAX_GRID_YZ), ("kVecThreads", VEC_THREADS),
                        ("kByteThreads", BYTE_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    if ok:
        entry(n, h, w)
    else:
        with pytest.raises(ValueError):
            entry(n, h, w)


@pytest.mark.parametrize("h,w,grid,threads", [
    (1024, 2048, (1, 512, 8), 128), (512, 1024, (1, 256, 8), 64), (360, 640, (1, 180, 8), 64),
    (480, 854, (2, 240, 8), 256)])
def test_launch_geometry(h, w, grid, threads):
    """The served shapes' launches: a CTA a chroma row of a frame, 128
    threads across 2048 columns, 64 across 1024 and 640 (40 groups: the
    second warp 8 lanes), the byte path 256 threads over 427 samples."""
    assert entry(8, h, w)[1:] == (grid, threads)


def test_cpu_wrapper_checks_and_counts_nothing():
    """On a CPU tensor the wrapper runs the plain version, keeps its checks
    and counts no launch on either counter."""
    yuv.i420_to_rgb_flat.launches = yuv.i420_to_rgb_flat.vector_launches = 0
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 12, 16), dtype=np.uint8))
    assert torch.equal(yuv.i420_to_rgb_flat(x), yuv.i420_to_rgb_flat_reference(x))
    with pytest.raises(ValueError, match="I420"):
        yuv.i420_to_rgb_flat(torch.zeros((1, 13, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="H%4"):
        yuv.i420_to_rgb_flat(torch.zeros((1, 9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        yuv.i420_to_rgb_flat(torch.zeros((1, 12, 8)))
    assert (yuv.i420_to_rgb_flat.launches, yuv.i420_to_rgb_flat.vector_launches) == (0, 0)
