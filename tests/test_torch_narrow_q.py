"""B3's narrow-channel route and the quantize pass's channel-map descriptor,
on the CPU against ``tpuseg``.

- ``int8_packing``'s narrow packings (cin / cout of 16, 32, 48, 64; k 1 and
  3) through B3's plain version: bit-equal to ``tpuseg``'s XLA int8 conv
  (``QuantConv.apply``), and ``stem_packing``'s through the stem's plain
  route: bit-equal to ``tpuseg``'s int8 stem conv
  (``tpuseg/ops/polyphase.py:340-359``, the same ops on the same inputs);
  where cin is less than the packing's K, its padding map (the quantize
  pass's, on the card) gives the zero-padded x and the same integer sums;
- the narrow route's tile (``b3_narrow_tile``) and the kernel's grid,
  step skipping and epilogue addressing transcribed in numpy: every output
  pixel written once, a skipped step only padding;
- the host entry raising on a (K, N, epilogue) it has no instance for, and
  handing each packing to one kernel's launcher, whose count moves only
  when its launch succeeds;
- ``channel_map_vectors`` and its plain reader against ``select_channels``
  on conv0's padding map, a random map and ``CompactSparseQ``'s block maps.

The kernels themselves run only on the card (``chip_smoke.py`` phases 10,
19, 38 and 40)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.ops.quant import QuantConv as JQuantConv
from tpuseg_torch.models.sparse_exec import CompactSparseQ
from tpuseg_torch.ops.quant import (
    QuantConv,
    int8_packing,
    narrow_widths,
    quant_conv_apply,
    quant_conv_reference,
    quantize_weight,
    stem_packing,
)
from tpuseg_torch.ops.sparse_conv import (
    B3_NARROW_INSTANCES,
    GATHER_VEC,
    ZERO_VEC,
    _launch_b3,
    b3_narrow_instance,
    b3_narrow_tile,
    channel_map_vectors,
    fused_sparse_conv_apply_q,
    fused_sparse_conv_q_bias_relu,
    fused_sparse_conv_q_bias_relu_reference,
    fused_sparse_conv_q_reference,
    int_conv_exact,
    plan_fused_sparse_conv,
    quantize_activation,
    quantize_fused_plan,
    select_channels,
    select_channels_by_vectors,
)
from tpuseg_torch.ops import _build
from tpuseg_torch.ops import sparse_conv as sc

torch.set_num_threads(2)

WIDTHS = (16, 32, 48, 64)


def _bits(a):
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).tobytes()


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cout", WIDTHS)
@pytest.mark.parametrize("cin", WIDTHS)
def test_narrow_packing_matches_tpuseg(cin, cout, k):
    """A narrow conv's packing run by B3's plain version on the unpadded x,
    per-frame and static scales, equals ``tpuseg``'s ``QuantConv.apply``
    bit for bit, and so does the route the card takes
    (``quant_conv_apply``, plain on the CPU)."""
    rng = np.random.default_rng(cin * 100 + cout * 3 + k)
    wq, ws = quantize_weight(rng.normal(size=(k, k, cin, cout)).astype(np.float32))
    d = 2 if k == 3 and cin == cout else 1
    pad = d * (k - 1) // 2
    x = rng.normal(size=(3, 7, 9, cin)).astype(np.float32)
    packed = int8_packing("c", wq, ws, d, pad)
    assert packed.narrow and (packed.bk, packed.bm) == narrow_widths(cin, cout)
    assert (packed.bk, packed.bm) == (32 if cin <= 32 else 64, 16 if cout <= 16 else
                                      32 if cout <= 32 else 64)
    if cin == packed.bk:
        assert packed.in_chan is None and packed.in_vecs is None
    else:  # the quantize pass pads x to K through zero vectors
        assert packed.in_chan.tolist() == list(range(cin)) + [-1] * (packed.bk - cin)
        assert packed.in_vecs.tolist() == list(range(0, cin, 8)) + [ZERO_VEC] * (
            (packed.bk - cin) // 8)
        tx = torch.from_numpy(x)
        padded = torch.nn.functional.pad(tx, (0, packed.bk - cin))
        assert torch.equal(select_channels_by_vectors(tx, packed.in_chan, packed.in_vecs),
                           padded)
        # the padded operand through the packing's full K gives the same sums
        xq, xs = quantize_activation(padded, None)
        w = packed.vals.reshape(k, k, packed.bk, packed.bm).double()[..., :cout]
        assert torch.equal(int_conv_exact(xq, w, d),
                           int_conv_exact(xq[..., :cin], torch.from_numpy(wq).double(), d))
    for x_scale in (None, float(np.abs(x).max()) / 127.0 * 0.7):
        p = dataclasses.replace(packed, x_scale=x_scale)
        qc = QuantConv(torch.from_numpy(wq), torch.from_numpy(ws), 1, d, pad, x_scale, p)
        want = np.asarray(JQuantConv(jnp.asarray(wq), jnp.asarray(ws), 1, d, pad,
                                     x_scale).apply(jnp.asarray(x)))
        tx = torch.from_numpy(x)
        assert _bits(fused_sparse_conv_q_reference(tx, p)) == want.tobytes()
        assert _bits(quant_conv_reference(tx, qc)) == want.tobytes()
        assert _bits(quant_conv_apply(tx, qc)) == want.tobytes()


def _jax_stem_conv(x, wq, ws, bias, plo, phi, xs, dtype):
    """``tpuseg``'s int8 stem conv (polyphase.py:340-359) on NHWC x: scale
    xs or per frame, int32 conv, relu(y * (xs * ws) + bias) in f32, cast."""
    x = jnp.asarray(x)
    if xs is None:
        absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=(1, 2, 3), keepdims=True)
        xs = jnp.maximum(absmax, 1e-8) / 127.0
    else:
        xs = jnp.float32(xs)
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / xs), -127, 127).astype(jnp.int8)
    y = jax.lax.conv_general_dilated(xq, jnp.asarray(wq), (1, 1), [(plo, phi), (plo, phi)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     preferred_element_type=jnp.int32)
    return jax.nn.relu(y.astype(jnp.float32) * (xs * jnp.asarray(ws))
                       + jnp.asarray(bias, jnp.float32)).astype(dtype)


@pytest.mark.parametrize("kernel,plo,phi", [(3, 1, 1), (2, 1, 0), (1, 0, 0)])
@pytest.mark.parametrize("cin,cout", [(16, 16), (32, 64), (48, 256), (64, 48)])
def test_narrow_stem_route_matches_tpuseg(cin, cout, kernel, plo, phi):
    """``stem_packing``'s narrow packing (48 -> 256 is conv0's) through the
    stem route's plain version (relu(y + bias), f32 and bf16 out, per-frame
    and static scales) equals ``tpuseg``'s int8 stem conv bit for bit; an
    embedded 2x2 kernel walks only its own taps."""
    rng = np.random.default_rng(cin + cout + kernel)
    wq, ws = quantize_weight(rng.normal(size=(kernel, kernel, cin, cout)).astype(np.float32))
    bias = rng.normal(size=(cout,)).astype(np.float32)
    plan = stem_packing("conv", wq, ws, plo, phi)
    assert plan.narrow and (plan.bk, plan.bm) == narrow_widths(cin, cout)
    assert int(plan.nsteps.sum()) == -(-cout // plan.bm) * kernel * kernel
    x = rng.normal(size=(2, 6, 11, cin)).astype(np.float32)
    for xs in (None, 0.02):
        p = dataclasses.replace(plan, x_scale=xs)
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            xt = torch.from_numpy(x).to(tdt)
            xj = jnp.asarray(x).astype(jdt)
            want = np.asarray(_jax_stem_conv(xj, wq, ws, bias, plo, phi, xs, jdt)
                              .astype(jnp.float32))
            got = fused_sparse_conv_q_bias_relu(xt, p, torch.from_numpy(bias), tdt)
            ref = fused_sparse_conv_q_bias_relu_reference(xt, p, torch.from_numpy(bias), tdt)
            assert got.dtype == tdt and torch.equal(got, ref)
            assert got.float().numpy().tobytes() == want.tobytes()


def test_narrow_widths_and_packing_limits():
    """K and N of the narrow route, and the convs it cannot take."""
    assert [narrow_widths(c, c) for c in (8, 16, 32, 33, 48, 64, 96, 160)] == [
        (32, 16), (32, 16), (32, 32), (64, 64), (64, 64), (64, 64), (128, 128), (128, 128)]
    assert narrow_widths(128, 200) == (128, 128) and narrow_widths(16, 24) == (32, 32)
    wq, ws = quantize_weight(np.ones((3, 3, 20, 16), np.float32))
    with pytest.raises(ValueError, match="layer1.1.conv1"):  # the quantize pass's 8 channels
        int8_packing("layer1.1.conv1", wq, ws, 1, 1)
    p24 = int8_packing("c", *quantize_weight(np.ones((3, 3, 24, 16), np.float32)), 1, 1)
    assert p24.in_vecs.tolist() == [0, 8, 16, ZERO_VEC]
    wq, ws = quantize_weight(np.ones((3, 3, 16, 20), np.float32))
    with pytest.raises(ValueError, match="layer1.1.conv2"):
        int8_packing("layer1.1.conv2", wq, ws, 1, 1)
    packed = int8_packing("c", *quantize_weight(np.ones((3, 3, 160, 200), np.float32)), 1, 1)
    assert (packed.bk, packed.bm, packed.s, packed.narrow) == (128, 128, 2, True)
    assert tuple(packed.vals_k.shape) == (2, 18, 128, 128) and packed.in_chan.numel() == 256
    moved = packed.to("cpu")
    assert torch.equal(moved.in_chan, packed.in_chan) and torch.equal(moved.in_vecs,
                                                                      packed.in_vecs)


@pytest.mark.parametrize("kb,bn,mode", [(32, 16, 1), (64, 64, 2), (64, 32, 3), (128, 16, 2),
                                        (16, 16, 0), (96, 64, 0), (32, 48, 0), (64, 128, 1),
                                        (32, 16, 4), (64, 64, 5), (128, 64, 4), (64, 32, 5),
                                        (128, 32, 5), (96, 128, 4)])
def test_narrow_host_entry_raises_on_unsupported(kb, bn, mode):
    """The host entry (``_launch_b3`` on a narrow packing) raises
    ``ValueError`` for a (K, N, epilogue) without an instance, before it
    builds or launches anything (the int8 hand-off's modes 4 and 5 exist at
    N = 128 alone); the instances callers use pass."""
    with pytest.raises(ValueError, match="no instance"):
        b3_narrow_instance(kb, bn, mode)
    if kb in (32, 64, 128) and bn in (16, 32, 64, 128):  # a packing int8_packing makes
        cin = {32: 16, 64: 64, 128: 128}[kb]
        packed = int8_packing("c", *quantize_weight(np.ones((3, 3, cin, bn), np.float32)), 1, 1)
        assert (packed.bk, packed.bm, packed.narrow) == (kb, bn, True)
        xq = torch.zeros((1, 4, 4, cin), dtype=torch.int8)
        with pytest.raises(ValueError, match="no instance"):
            _launch_b3(xq, torch.ones(1), packed, torch.zeros(bn), bool(mode & 1), mode >= 2,
                       0.02 if mode >= 4 else None)
    for kb in (32, 64, 128):
        for bn, mode in B3_NARROW_INSTANCES:
            b3_narrow_instance(kb, bn, mode)


def _narrow_grid(n, h, w, k, dil, cout, bn):
    """numpy transcription of ``csrc/sparse_conv_q_narrow.cu``'s grid, step
    skipping and epilogue addressing: -> (pixels written per (img, i, j),
    live steps per tile, whether every skipped step's box was padding)."""
    rows, imgs = b3_narrow_tile(n, h, w)
    box_w = min(w, 256)
    segs, bands = -(-w // 256), -(-h // rows)
    nmb = -(-cout // bn)
    pad = dil * (k - 1) // 2
    written = np.zeros((n, h, w), np.int64)
    skipped_only_padding = True
    lives = []
    for cta in range(nmb * segs * bands * -(-n // imgs)):
        jb = cta % nmb
        tile = cta // nmb
        j0 = (tile % segs) * 256
        band = tile // segs
        i0 = (band % bands) * rows
        n0 = (band // bands) * imgs
        live = 0
        for t in range(k * k):
            p, q = divmod(t, k)
            ii, jj = i0 + p * dil - pad, j0 + q * dil - pad
            is_live = ii < h and ii + rows > 0 and jj < w and jj + box_w > 0
            live += is_live
            if not is_live:  # the box must hold no pixel of the image
                r = np.arange(ii, ii + rows)
                c = np.arange(jj, jj + box_w)
                skipped_only_padding &= not (((r >= 0) & (r < h)).any()
                                             and ((c >= 0) & (c < w)).any())
        lives.append(live)
        if jb:
            continue
        per_img = rows * box_w
        for m in range(256):
            gi, rem = divmod(m, per_img)
            ri, ji = divmod(rem, box_w)
            img, i, j = n0 + gi, i0 + ri, j0 + ji
            if gi < imgs and img < n and i < h and j < w:
                written[img, i, j] += 1
    return written, lives, skipped_only_padding, (rows, imgs)


@pytest.mark.parametrize("n,h,w,k,dil", [(64, 32, 32, 3, 1), (64, 16, 16, 3, 1),
                                         (64, 8, 8, 3, 1), (3, 7, 9, 3, 2), (2, 33, 31, 3, 1),
                                         (5, 1, 1, 3, 1), (2, 3, 300, 3, 1), (1, 2, 520, 1, 1),
                                         (7, 8, 8, 3, 4)])
def test_narrow_tile_writes_each_pixel_once(n, h, w, k, dil):
    """R rows or G whole images a tile (R = min(256 // w, h); G > 1 only
    when an image fits), every output pixel stored exactly once, and a
    step skipped by the one step rule holds only padding."""
    written, lives, only_padding, (rows, imgs) = _narrow_grid(n, h, w, k, dil, 64, 32)
    assert (written == 1).all()
    assert only_padding and all(0 < v <= k * k for v in lives)
    assert rows * min(w, 256) * imgs <= 256 and rows <= h and imgs <= n
    assert imgs == 1 or (rows == h and imgs * h * w <= 256)
    if w < 256 and h * w > 256:
        assert (rows, imgs) == (256 // w, 1)


def test_r20_tiles():
    """cifar_resnet20's maps at batch 64: 8 rows of 32, one 16x16 image, 4
    8x8 images a tile: 256 tiles each, no idle pixel."""
    assert [b3_narrow_tile(64, s, s) for s in (32, 16, 8)] == [(8, 1), (16, 1), (8, 4)]
    assert b3_narrow_tile(32, 256, 512) == (1, 1)  # conv0: 256-pixel segments


@pytest.mark.parametrize("kind", ["conv0", "random", "compact_blocks", "mixed"])
def test_channel_map_vectors_read_as_select_channels(kind):
    """Each map's descriptor has the kinds it should, and its plain reader
    reproduces ``select_channels`` exactly; the quantize pass through the
    map equals the one on the gathered x (scales too)."""
    rng = np.random.default_rng(len(kind))
    if kind == "conv0":  # 48 channels padded to the narrow route's 64
        chan = np.r_[np.arange(48), -np.ones(16, np.int64)]
        want = [0, 8, 16, 24, 32, 40, ZERO_VEC, ZERO_VEC]
    elif kind == "random":
        chan = rng.permutation(512)[:96]
        want = None
    elif kind == "compact_blocks":  # CompactSparseQ: whole live 128-blocks
        chan = np.r_[np.arange(128, 256), np.arange(384, 512)]
        want = list(range(128, 256, 8)) + list(range(384, 512, 8))
    else:
        chan = np.r_[np.arange(8, 24), [5, 3, 1, 400, 2, 7, 9, 11], -np.ones(8, np.int64),
                     [-1, 3, 4, 5, 6, 7, 8, 9], np.arange(504, 512)]
        want = [8, 16, GATHER_VEC, ZERO_VEC, GATHER_VEC, 504]
    chan = torch.from_numpy(chan).to(torch.int32)
    vecs = channel_map_vectors(chan)
    assert vecs.dtype == torch.int32 and vecs.shape == (chan.numel() // 8,)
    if want is not None:
        assert vecs.tolist() == want
    else:
        assert set(vecs.tolist()) <= {GATHER_VEC} | set(range(0, 512, 8))
    x = torch.from_numpy(rng.normal(size=(3, 5, 6, 512)).astype(np.float32))
    x[1] *= 40.0
    for t in (x, x.to(torch.bfloat16)):
        assert torch.equal(select_channels_by_vectors(t, chan, vecs), select_channels(t, chan))
        for x_scale in (None, 0.013):
            got = quantize_activation(t, x_scale, chan, vecs=vecs)
            want_q = quantize_activation(select_channels(t, chan), x_scale)
            assert torch.equal(got[0], want_q[0]) and torch.equal(got[1], want_q[1])


def test_channel_map_vectors_rejects_a_ragged_map():
    with pytest.raises(ValueError, match="multiple of 8"):
        channel_map_vectors(torch.arange(12, dtype=torch.int32))


def test_compact_sparse_q_carries_its_vectors():
    """``CompactSparseQ`` builds its map's descriptor once (every vector of
    a block map contiguous), moves it with the plan, and its CPU route is
    the plain conv of the gathered x."""
    rng = np.random.default_rng(9)
    live = torch.cat([torch.arange(0, 128), torch.arange(256, 384)])
    w = (rng.normal(size=(128, 256, 3, 3)) * 0.05).astype(np.float32)
    inner = quantize_fused_plan(plan_fused_sparse_conv(w, np.ones_like(w), dilation=2,
                                                       dtype=torch.float32))
    plan = CompactSparseQ(live, inner)
    assert plan.live_vecs.tolist() == list(range(0, 128, 8)) + list(range(256, 384, 8))
    moved = plan.to("cpu")
    assert torch.equal(moved.live_vecs, plan.live_vecs) and moved.live_vecs.dtype == torch.int32
    x = torch.from_numpy(rng.normal(size=(1, 6, 7, 512)).astype(np.float32))
    want = fused_sparse_conv_q_reference(x.index_select(3, live), inner)
    assert torch.equal(plan.apply(x), want)
    assert torch.equal(fused_sparse_conv_apply_q(x, inner, chan=plan.live_in32,
                                                 vecs=plan.live_vecs), want)


def _dispatch_packings():
    """r20's 16-wide conv and conv0's 48 -> 256 (narrow), a 128-wide conv,
    and the int8 stem's conv1 (256 -> 256, 3x3) and conv2 (256 -> 128, its
    2x2 pad (1, 0) embedded in the 3x3) from ``stem_packing``: 128-wide
    blocks, sent to the narrow route by the plan's ``narrow_route``."""
    rng = np.random.default_rng(11)
    out = []
    for cin, cout in ((16, 16), (48, 256), (128, 128)):
        w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
        out.append(int8_packing("c", *quantize_weight(w), 1, 1))
    for k, (plo, phi), cout in ((3, (1, 1), 256), (2, (1, 0), 128)):
        w = (rng.normal(size=(k, k, 256, cout)) * 0.1).astype(np.float32)
        out.append(stem_packing("c", *quantize_weight(w), plo, phi))
    return out


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4])
def test_launch_b3_hands_each_packing_to_one_kernel(which, monkeypatch):
    """``_launch_b3`` calls the narrow kernel's launcher for a narrow
    packing (the stem's 128-wide ones included) and the 128-wide kernel's
    otherwise, once, with the epilogue mode and an output cout wide; so
    each kernel's launches count apart.  The stem's packings take relu(y +
    bias) as bf16 (mode 3) and its int8 hand-off from bf16 (mode 5, int8
    out, the scale passed on) on the narrow kernel."""
    packed = _dispatch_packings()[which]
    calls = []
    for name in ("sparse_conv_q_kernel", "sparse_conv_q_narrow_kernel"):
        monkeypatch.setattr(sc, name, lambda *a, name=name: calls.append((name, a[4], a[5])))
    monkeypatch.setattr(sc, "_on_device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(sc, "_raw_stream", lambda dev: 0)
    xq = torch.zeros((1, 4, 5, packed.cin), dtype=torch.int8)
    relu = which in (1, 3, 4)  # the stem's epilogue, relu(y + bias) as bf16
    bias = torch.zeros(packed.cout) if relu else None
    out = _launch_b3(xq, torch.ones(1), packed, bias, relu, relu)
    want = "sparse_conv_q_narrow_kernel" if packed.narrow else "sparse_conv_q_kernel"
    assert packed.narrow == (which != 2) and packed.narrow_route == (which > 2)
    assert [(c[0], c[1]) for c in calls] == [(want, 3 if relu else 0)]
    assert calls[0][2] is out and out.shape == (1, 4, 5, packed.cout)
    assert out.dtype == (torch.bfloat16 if relu else torch.float32)
    if which > 2:
        out = _launch_b3(xq, torch.ones(1), packed, bias, True, True, 0.05)
        assert calls[1][:2] == (want, 5) and calls[1][2] is out and out.dtype == torch.int8


class _FakeLib:
    """The kernel library's two B3 entries, returning ``err``."""

    def __init__(self, err):
        self.err, self.called = err, []

    def tpuseg_sparse_conv_q(self, *args):
        self.called.append(("sparse_conv_q", args[-1]))
        return self.err

    def tpuseg_sparse_conv_q_narrow(self, *args):
        self.called.append(("sparse_conv_q_narrow", args[-1]))
        return self.err

    def tpuseg_cuda_error_string(self, err):
        return b"invalid argument"


@pytest.mark.parametrize("err", [0, 1])
def test_b3_kernel_launchers_count_their_own_launches(err, monkeypatch):
    """Each of B3's kernel launchers calls its own C entry on the stream it
    is given and adds one to its own count when the entry returns 0; on an
    error it raises and neither count moves."""
    lib = _FakeLib(err)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(sc.sparse_conv_q_kernel, "launches", 0)
    monkeypatch.setattr(sc.sparse_conv_q_narrow_kernel, "launches", 0)
    narrow, _, wide = _dispatch_packings()[:3]
    for packed, launcher in ((narrow, sc.sparse_conv_q_narrow_kernel),
                             (wide, sc.sparse_conv_q_kernel)):
        xq = torch.zeros((1, 4, 5, packed.cin), dtype=torch.int8)
        out = torch.empty((1, 4, 5, packed.cout))
        if err:
            with pytest.raises(RuntimeError, match="invalid argument"):
                launcher(xq, torch.ones(1), packed, None, 0, out, 7)
        else:
            launcher(xq, torch.ones(1), packed, None, 0, out, 7)
    assert lib.called == [("sparse_conv_q_narrow", 7), ("sparse_conv_q", 7)]
    assert (sc.sparse_conv_q_narrow_kernel.launches, sc.sparse_conv_q_kernel.launches) == (
        (0, 0) if err else (1, 1))
