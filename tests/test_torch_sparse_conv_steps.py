"""The live-step lists that let kernel B2 skip zero tiles, and the served
bf16+bias route, against tpuseg on the same weights, masks and inputs.

Every B2-layout packing (``plan_fused_sparse_conv``,
``plan_shared_sparse_conv``, ``pack_xw_bsr``) carries, per out-block, the
ids t*S + s of its nonzero 128x128 tiles (``steps``) and their count
(``nsteps``), built with the packing.  The kernel walks only those steps;
here a plain walk over them stands in for it.  The JAX side is the Pallas
kernel in interpret mode."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.models.sparse_exec import build_sparse_plans as j_build
from tpuseg.ops.fold_bn import fold_bn as j_fold_bn
from tpuseg.sparsity import apply_masks as j_apply_masks
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg.video.pipeline import SyntheticFrames as JFrames
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models import drn as tdrn
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.sparse_exec import CompactSparse, build_sparse_plans
from tpuseg_torch.ops import sparse_conv as tsc
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.sparsity import apply_masks, create_masker
from tpuseg_torch.video.pipeline import SyntheticFrames as TFrames
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter

torch.set_num_threads(2)

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CONFIG = "optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json"
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
# port bf16 vs tpuseg bf16 ids, test_torch_pipeline.py's floor
BF16_AGREEMENT_MIN = 0.98


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _hwio(a):
    return np.ascontiguousarray(np.asarray(a).transpose(2, 3, 1, 0))


def _mask(rng, kind, k, cin, cout):
    """OIHW 0/1 mask of 128x128 blocks: ``per_tap`` (two in-blocks per
    out-block, each tap dropping some), ``dead_out`` (the last out-block
    keeps nothing), ``all_zero``."""
    nkb, nmb = cin // 128, cout // 128
    m = np.zeros((cout, cin, k, k), np.float32)
    if kind == "all_zero":
        return m
    for j in range(nmb - 1 if kind == "dead_out" else nmb):
        for kb in rng.choice(nkb, size=2, replace=False):
            taps = rng.random(k * k) < 0.6
            taps[j % (k * k)] = True
            m[j * 128:(j + 1) * 128, kb * 128:(kb + 1) * 128] = taps.reshape(k, k)
    return m


def _case(kind, k=3, d=2, cin=384, cout=384, dtype=torch.float32, seed=0):
    """(port packing, tpuseg packing, OIHW masked weight)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
    m = _mask(rng, "per_tap" if kind in ("shared", "xw") else kind, k, cin, cout)
    if kind == "xw":
        wkm = _hwio(w * m)[0, 0]
        return tsc.pack_xw_bsr(wkm, dtype), jsc.pack_xw_bsr(wkm, dtype=JDTYPE[dtype]), w * m
    if kind == "shared":
        return (tsc.plan_shared_sparse_conv(w, m, d, dtype),
                jsc.plan_shared_sparse_conv(_hwio(w), _hwio(m), d, JDTYPE[dtype]), w * m)
    return (tsc.plan_fused_sparse_conv(w, m, d, dtype),
            jsc.plan_fused_sparse_conv(_hwio(w), _hwio(m), dilation=d, dtype=JDTYPE[dtype]),
            w * m)


KINDS = [("per_tap", 3), ("dead_out", 3), ("all_zero", 3), ("per_tap", 1), ("shared", 3),
         ("xw", 1)]


def _walk(x: torch.Tensor, p, k: int, d: int) -> torch.Tensor:
    """The kernel's loop in plain PyTorch: for each out-block, only its
    live steps t*S + s, each the tap-shifted in-block rows[jb, s] of x times
    the tile vals[jb, (t*S + s)*128 : +128], summed in f32."""
    n, h, w, _ = x.shape
    nmb, S = p.rows.shape
    pad = d * (k - 1) // 2
    xp = F.pad(x.to(p.vals.dtype).float(), (0, 0, pad, pad, pad, pad))
    vals = p.vals.float()
    y = torch.zeros((n, h, w, nmb * 128))
    for jb in range(nmb):
        for ts in p.steps[jb, :int(p.nsteps[jb])].tolist():
            t, s = divmod(ts, S)
            dy, dx = divmod(t, k)
            c0 = int(p.rows[jb, s]) * 128
            xs = xp[:, dy * d:dy * d + h, dx * d:dx * d + w, c0:c0 + 128]
            y[..., jb * 128:(jb + 1) * 128] += xs @ vals[jb, ts * 128:(ts + 1) * 128]
    return y


@pytest.mark.parametrize("kind,k", KINDS)
def test_steps_are_the_nonzero_tiles(kind, k):
    """Each out-block's ``steps[:nsteps]`` lists exactly the nonzero tiles of
    its ``vals``, in order, padded with 0; int32, (nmb, T*S) and (nmb,)."""
    for dtype in (torch.float32, torch.bfloat16):
        p, _, _ = _case(kind, k=k, dtype=dtype)
        nmb = p.rows.shape[0]
        nonzero = (p.vals.float().reshape(nmb, -1, 128 * 128) != 0).any(-1).numpy()
        assert p.steps.dtype == p.nsteps.dtype == torch.int32
        assert tuple(p.steps.shape) == nonzero.shape and tuple(p.nsteps.shape) == (nmb,)
        for jb in range(nmb):
            n_live = int(p.nsteps[jb])
            np.testing.assert_array_equal(p.steps[jb, :n_live].numpy(),
                                          np.flatnonzero(nonzero[jb]))
            assert not p.steps[jb, n_live:].any()
    if kind == "dead_out":
        assert int(p.nsteps[-1]) == 0 and int(p.nsteps[0]) > 0
    if kind == "all_zero":
        assert not p.nsteps.any()
    if kind == "per_tap" and k == 3:
        # per-tap holes: some out-block has fewer live steps than T*S
        assert int(p.nsteps.min()) < p.steps.shape[1]


@pytest.mark.parametrize("kind,k", KINDS)
def test_rows_vals_byte_equal_and_steps_move(kind, k):
    """``rows``/``vals`` stay tpuseg's bytes beside the step lists, and
    ``.to()`` carries the lists with the plan."""
    p, jp, _ = _case(kind, k=k, dtype=torch.bfloat16)
    jrows = np.asarray(jp.rows, np.int32)
    if kind == "shared":
        jrows = np.broadcast_to(jrows, tuple(p.rows.shape))
    assert p.rows.numpy().tobytes() == np.ascontiguousarray(jrows).tobytes()
    assert p.vals.view(torch.int16).numpy().tobytes() == np.asarray(jp.vals).tobytes()
    q = p.to("cpu")
    assert torch.equal(q.steps, p.steps) and torch.equal(q.nsteps, p.nsteps)


@pytest.mark.parametrize("kind,k,d", [("per_tap", 3, 1), ("per_tap", 3, 2), ("dead_out", 3, 4),
                                      ("all_zero", 3, 1), ("per_tap", 1, 1), ("shared", 3, 2)])
def test_live_step_walk_matches_reference_and_jax(kind, k, d):
    """The walk over the live steps only equals fused_sparse_conv_reference
    (every step, zero tiles included) and tpuseg's kernel on the same plan
    and x (odd 7 x 10 grid, f32 plan).  rtol 1e-4, atol 1e-3: the B7 tests'
    tolerance, the sums of up to K = 9*S*128 unit-scale products taken in
    other orders."""
    p, jp, _ = _case(kind, k=k, d=d)
    x = np.random.default_rng(1).normal(size=(2, 7, 10, 384)).astype(np.float32)
    got = _walk(torch.from_numpy(x), p, k, d).numpy()
    np.testing.assert_allclose(got, tsc.fused_sparse_conv_reference(torch.from_numpy(x), p),
                               rtol=1e-4, atol=1e-3)
    if kind == "shared":
        want = jsc.shared_sparse_conv_apply(jnp.asarray(x), jp, rows_per_tile=1)
    else:
        want = jsc.fused_sparse_conv_apply(jnp.asarray(x), jp)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-3)
    if kind == "all_zero":
        assert not got.any()


def test_live_step_walk_matches_b4():
    """XwBsr (B4's packing, one tap): the walk on x viewed as one image row
    of P pixels equals bsr_matmul_xw's plain version and tpuseg's kernel."""
    p, jp, wm = _case("xw", k=1)
    x = np.random.default_rng(2).normal(size=(256, 384)).astype(np.float32)
    got = _walk(torch.from_numpy(x).view(1, 1, 256, 384), p, 1, 1).view(256, 384).numpy()
    np.testing.assert_allclose(got, tsc.bsr_matmul_xw(torch.from_numpy(x), p), rtol=1e-4,
                               atol=1e-3)
    want = jsc.bsr_matmul_xw(jnp.asarray(x), jp, bp=128)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-3)


def _nchw(rng, n, c, h, w):
    """A channels_last bf16 NCHW tensor, as the served layers pass them."""
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)).to(torch.bfloat16)
    return tdrn.nhwc_to_nchw(x)


@pytest.mark.parametrize("with_bias", [True, False])
def test_bf16_route_plain_is_the_two_passes(with_bias):
    """The served bf16 route of a bf16 FusedSparseConv and of a
    CompactSparse equals, bit for bit, models/drn.py's two passes (the f32
    conv cast to bf16, then the bf16 bias added), and counts no launch on
    the CPU; f32 plans and other plan kinds keep the two passes (None)."""
    rng = np.random.default_rng(3)
    plan, _, _ = _case("per_tap", dtype=torch.bfloat16)
    inner, _, _ = _case("dead_out", cin=256, dtype=torch.bfloat16, seed=4)
    # in-blocks 0 and 2 of a 512-channel input survive
    compact = CompactSparse(torch.cat([torch.arange(128), 256 + torch.arange(128)]), inner)
    bias = torch.from_numpy(rng.normal(size=384).astype(np.float32)) if with_bias else None
    cdef = tdrn.ConvDef("c", 384, 384, 3, 1, 2, 2)
    before = tsc.fused_sparse_conv_apply.launches
    for p, cin in ((plan, 384), (compact, 512)):
        x = _nchw(rng, 2, cin, 7, 10)
        got = tdrn._sparse_conv_bias_bf16(x, p, bias)
        want = tdrn._sparse_conv(x, p, cdef).to(torch.bfloat16)
        if bias is not None:
            want = want + bias.to(torch.bfloat16).view(1, -1, 1, 1)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 384, 7, 10)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert got.permute(0, 2, 3, 1).is_contiguous()
        nhwc = x.permute(0, 2, 3, 1)
        if p is plan:
            ref = tsc.fused_sparse_conv_bias_bf16_reference(nhwc, plan, bias)
            assert torch.equal(tsc.fused_sparse_conv_bias_bf16(nhwc, plan, bias), ref)
    assert tsc.fused_sparse_conv_apply.launches == before
    f32_plan, _, _ = _case("per_tap")
    assert tdrn._sparse_conv_bias_bf16(_nchw(rng, 1, 384, 4, 5), f32_plan, bias) is None
    with pytest.raises(TypeError, match="bf16 plan"):
        tsc.fused_sparse_conv_bias_bf16(_nchw(rng, 1, 384, 4, 5).permute(0, 2, 3, 1), f32_plan,
                                        bias)


def test_pruned_bf16_segmenter_matches_jax():
    """bf16 serving of block128reg_87.50 under the Pallas lowering (bf16
    plans; the 7 B2 convs take the bf16+bias route) vs tpuseg's bf16
    VideoSegmenter with its plans, 4 frames of 64x128: ids agreement >=
    0.98, test_torch_pipeline.py's bf16 floor."""
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    tmasks = create_masker(CONFIG, seed=0).generate_masks(tp)
    tp = apply_masks(tp, tmasks)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    jmasks = j_create_masker(CONFIG, seed=0).generate_masks(jp, is_static=True)
    jp = dict(j_apply_masks(jp, jmasks))
    tplans, _ = build_sparse_plans(fold_bn(tp, ts, tspec), tmasks, tspec)
    jplans, _ = j_build(j_fold_bn(jp, js, jspec), jmasks, jspec)
    routed = [n for n, p in tplans.items() if isinstance(p, (tsc.FusedSparseConv, CompactSparse))]
    assert len(routed) == 7
    seg = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.bfloat16,
                     batch=2, exec_plans=tplans)
    ids = seg.run(TFrames(4, (64, 128), seed=0), need_color=False)["ids"]
    jseg = JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=jnp.bfloat16, batch=2,
                      exec_plans=jplans)
    ref = np.asarray(jseg.run(JFrames(4, (64, 128), seed=0), need_color=False)["ids"])
    agreement = float((ids == ref).mean())
    assert agreement >= BF16_AGREEMENT_MIN, agreement


def test_ab_script_needs_a_card(capsys):
    """The kernel A/B script measures the card only: without CUDA it exits 1
    before building anything."""
    from tpuseg_torch import ab_sparse_conv

    assert ab_sparse_conv.main(["--old", "no_such_copy.cu"]) == 1
    assert "no CUDA card" in capsys.readouterr().err
