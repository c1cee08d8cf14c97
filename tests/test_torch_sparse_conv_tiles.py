"""The tile geometry of kernel B2's bf16 path (``csrc/sparse_conv.cu``), on
the CPU: a tile is R = ``b2_tile_rows(w)`` whole image rows of a narrow map
(R = floor(256 / w) when w < 256), else a 256-pixel segment of one row.

The kernel cannot run here, so its tile walk is transcribed in numpy, with
the grid, the tile's first pixel (``i0``, ``j0``), ``pix0``, ``valid`` and
the step-skipping rule (``step_box``) as the .cu computes them: the walk
must cover every output pixel once, skip a step exactly when its x box holds
only padding, and, run as the kernel runs it (TMA zero fill outside x,
stale rows past the box), give B2's function.  The plain version at narrow
shapes is held to ``tpuseg``'s Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg_torch.ops.sparse_conv import (
    B2_TILE_PIXELS,
    b2_tile_rows,
    fused_sparse_conv_apply,
    fused_sparse_conv_reference,
    plan_fused_sparse_conv,
)

torch.set_num_threads(2)

TILE = B2_TILE_PIXELS
# the widths chip_smoke.py's phase 31 runs: narrow maps (R > 1), a width
# that does not divide 256, R past h, one and two row segments
WIDTHS = (64, 96, 112, 128, 8, 40, 200, 256, 300)
HEIGHTS = (1, 2, 5, 64)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _tiles(n, h, w, nmb, rows):
    """The kernel's grid, CTA by CTA: (jb, n, i0, j0, pix0, valid), out-block
    fastest; ceil(h / R) bands of R rows an image, each in ceil(w / 256)
    segments."""
    segs = -(-w // TILE)
    bands = -(-h // rows)
    for block in range(n * bands * segs * nmb):
        jb, tile = block % nmb, block // nmb
        band, j0 = tile // segs, (tile % segs) * TILE
        i0, img = (band % bands) * rows, band // bands
        valid = min(TILE, min(rows, h - i0) * w - j0)
        pix0 = (img * h + i0) * w + j0
        yield jb, img, i0, j0, pix0, valid


def _box_w(w, rows):
    return w if rows > 1 else TILE


def _step_box(t, i0, j0, h, w, k, d, rows):
    """``step_box``: the x box's first row and column for tap t, and
    whether any of its pixels lies in the image."""
    p = t // k
    pad = d * (k - 1) // 2
    ii = i0 + p * d - pad
    jj = j0 + (t - p * k) * d - pad
    live = ii < h and ii + rows > 0 and jj < w and jj + _box_w(w, rows) > 0
    return ii, jj, live


@pytest.mark.parametrize("w", [256, 257, 300, 511, 512, 1024, 2048, 2 ** 20])
def test_tile_rows_is_one_from_256(w):
    """R = 1 for every w >= 256, so the served (w = 256), B4 (one row of
    2**20 pixels) and B7 shapes keep their 256-pixel row segments and the
    (64, 256, 1, 1) box."""
    assert b2_tile_rows(w) == 1
    assert _box_w(w, 1) == TILE


@pytest.mark.parametrize("w", [1, 8, 40, 64, 96, 100, 112, 128, 129, 200, 255])
def test_tile_rows_fill_the_tile(w):
    """R = floor(256 / w): whole rows, as many as fit, so R * w <= 256 <
    (R + 1) * w; the C entry point's limit (R * w <= 256 when R > 1)
    holds."""
    r = b2_tile_rows(w)
    assert r == TILE // w and r * w <= TILE < (r + 1) * w
    assert r >= 1 and (r == 1 or r * w <= TILE)


def test_tile_rows_rejects_empty_maps():
    for w in (0, -3):
        with pytest.raises(ValueError):
            b2_tile_rows(w)


@pytest.mark.parametrize("h", HEIGHTS)
@pytest.mark.parametrize("w", WIDTHS)
def test_tile_walk_covers_each_pixel_once(w, h):
    """Over the grid, the stored runs [pix0, pix0 + valid) of each out-block
    cover every (n, i, j) exactly once, and tile row m < valid is pixel
    (i0 + (j0 + m) / w, (j0 + m) % w) of its image: R whole rows are one
    run of NHWC pixels."""
    n, nmb = 2, 2
    rows = b2_tile_rows(w)
    hits = np.zeros((nmb, n * h * w), np.int32)
    ctas = 0
    for jb, img, i0, j0, pix0, valid in _tiles(n, h, w, nmb, rows):
        ctas += 1
        assert 0 < valid <= TILE and i0 < h and j0 < w
        if rows > 1:
            assert j0 == 0 and valid <= rows * w
        m = np.arange(valid)
        assert np.array_equal(pix0 + m, (img * h + i0 + (j0 + m) // w) * w + (j0 + m) % w)
        hits[jb, pix0:pix0 + valid] += 1
    assert (hits == 1).all()
    assert ctas == n * -(-h // rows) * -(-w // TILE) * nmb


@pytest.mark.parametrize("k,d", [(3, 1), (3, 4), (1, 1), (3, 12)])
@pytest.mark.parametrize("w", WIDTHS)
def test_skip_rule_is_exactly_all_padding(w, k, d):
    """A (tile, step) pair is skipped exactly when the step's x box (R rows
    of box_w pixels at (ii, jj)) holds no pixel of the image; d = 12 on
    w = 8 puts whole boxes past the row's ends."""
    rows = b2_tile_rows(w)
    for h in HEIGHTS:
        for _, _, i0, j0, _, _ in _tiles(1, h, w, 1, rows):
            for t in range(k * k):
                ii, jj, live = _step_box(t, i0, j0, h, w, k, d, rows)
                r = ii + np.arange(rows)
                c = jj + np.arange(_box_w(w, rows))
                inside = ((r >= 0) & (r < h)).any() and ((c >= 0) & (c < w)).any()
                assert live == inside, (h, i0, j0, t)


def _mask(rng, k, cin, cout):
    """OIHW 0/1 mask of 128x128 blocks: per out-block two in-blocks, each tap
    dropping some (the last out-block keeps none), so steps vary per
    out-block and some out-block has none."""
    nkb, nmb = cin // 128, cout // 128
    m = np.zeros((cout, cin, k, k), np.float32)
    for j in range(nmb - 1):
        for kb in rng.choice(nkb, size=min(2, nkb), replace=False):
            taps = rng.random(k * k) < 0.7
            taps[j % (k * k)] = True
            m[j * 128:(j + 1) * 128, kb * 128:(kb + 1) * 128] = taps.reshape(k, k)
    return m


def _kernel_walk(x, plan):
    """B2's bf16 path transcribed: every CTA of the grid, its live steps
    (``steps[:nsteps]``, skipped by ``step_box``), each step's A tile the x
    box with TMA's zero fill and NaN in the rows past R * box_w (stale
    shared memory), one 256 x 128 accumulator in f64, then the store of
    rows m < valid at pix0 + m.  Output pixels no CTA stores stay NaN."""
    n, h, w, _ = x.shape
    k, d, S = plan.kernel, plan.dilation, plan.s
    nmb = plan.cout // 128
    rows = b2_tile_rows(w)
    box_w = _box_w(w, rows)
    xs = x.double().numpy()
    vals = plan.vals.double().numpy()
    steps, nsteps, srows = plan.steps.numpy(), plan.nsteps.numpy(), plan.rows.numpy()
    y = np.full((n * h * w, plan.cout), np.nan)
    for jb, img, i0, j0, pix0, valid in _tiles(n, h, w, nmb, rows):
        acc = np.zeros((TILE, 128))
        for ts in steps[jb, :nsteps[jb]]:
            t, s = divmod(int(ts), S)
            ii, jj, live = _step_box(t, i0, j0, h, w, k, d, rows)
            if not live:
                continue
            r = ii + np.arange(rows)[:, None]
            c = jj + np.arange(box_w)[None, :]
            inb = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            c0 = int(srows[jb, s]) * 128
            box = xs[img, np.clip(r, 0, h - 1), np.clip(c, 0, w - 1), c0:c0 + 128]
            a = np.full((TILE, 128), np.nan)
            a[:rows * box_w] = np.where(inb[..., None], box, 0.0).reshape(-1, 128)
            with np.errstate(invalid="ignore"):
                acc += a @ vals[jb, ts * 128:(ts + 1) * 128]
        y[pix0:pix0 + valid, jb * 128:(jb + 1) * 128] = acc[:valid]
    return y.reshape(n, h, w, plan.cout)


@pytest.mark.parametrize("k,d", [(3, 1), (3, 4), (1, 1)])
@pytest.mark.parametrize("shape", [(2, 5, 64), (2, 9, 96), (2, 7, 112), (2, 6, 128),
                                   (1, 4, 8), (1, 3, 200), (1, 2, 300)])
def test_kernel_walk_computes_b2(shape, k, d):
    """The transcribed walk gives B2's function: every output pixel stored
    (no NaN: no stale row reaches a stored pixel), within 1e-10 * max|ref|
    of the dense f64 conv of the masked weight (two f64 sums of the same
    products in other orders), and within 2*K*eps (f32) of the plain
    version."""
    rng = np.random.default_rng(sum(shape) + 10 * k + d)
    cin, cout = 256, 384
    w = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
    m = _mask(rng, k, cin, cout)
    plan = plan_fused_sparse_conv(w, m, dilation=d, dtype=torch.float32)
    x = torch.from_numpy(rng.normal(size=shape + (cin,)).astype(np.float32))
    got = _kernel_walk(x, plan)
    assert not np.isnan(got).any()
    want = F.conv2d(x.double().permute(0, 3, 1, 2), torch.from_numpy(w * m).double(), None, 1,
                    d * (k - 1) // 2, d).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    plain = fused_sparse_conv_reference(x, plan).double().numpy()
    k_len = k * k * plan.s * 128
    assert np.abs(got - plain).max() <= 2 * k_len * np.finfo(np.float32).eps * np.abs(want).max()
    assert (got[..., -128:] == 0).all()  # the out-block with no live step


@pytest.mark.parametrize("shape", [(2, 5, 64), (2, 9, 96)])
def test_plain_matches_jax_kernel_on_narrow_maps(shape):
    """The plain version (what a CPU tensor runs) at the narrow shapes vs
    ``tpuseg``'s Pallas kernel in interpret mode, k = 3, d = 4, bf16 plan:
    max abs error <= 1e-4 * max|ref| (``test_torch_sparse_conv.py``'s
    tolerance: bf16 products are exact in f32, only the order of the sums
    differs)."""
    rng = np.random.default_rng(shape[2])
    cin, cout = 256, 256
    w = (rng.normal(size=(cout, cin, 3, 3)) * 0.1).astype(np.float32)
    m = _mask(rng, 3, cin, cout)
    x = rng.normal(size=shape + (cin,)).astype(np.float32)
    tp = plan_fused_sparse_conv(w, m, dilation=4, dtype=torch.bfloat16)
    jp = jsc.plan_fused_sparse_conv(w.transpose(2, 3, 1, 0), m.transpose(2, 3, 1, 0),
                                    dilation=4, dtype=jnp.bfloat16)
    fused_sparse_conv_apply.launches = 0
    got = fused_sparse_conv_apply(torch.from_numpy(x), tp)
    assert fused_sparse_conv_apply.launches == 0  # a CPU tensor runs the plain version
    want = np.asarray(jsc.fused_sparse_conv_apply(jnp.asarray(x), jp))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == shape + (cout,)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())
