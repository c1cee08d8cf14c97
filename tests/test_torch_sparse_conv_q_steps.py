"""Kernel B3's live steps, its served bf16+bias route and the channel-map
quantize, against tpuseg on the same weights, masks and inputs.

Every int8 packing (``quantize_fused_plan``, ``full_support_packing``,
``quantize_gathered_plan``'s equivalent packing) carries, per out-block,
the ids t*S + s of its nonzero int8 tiles (``steps``) and their count
(``nsteps``); B3 walks only those.  Here a plain integer walk over them
stands in for the kernel.  The JAX side is the Pallas kernel in interpret
mode."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.models.sparse_exec import build_sparse_plans as j_build
from tpuseg.ops.fold_bn import fold_bn as j_fold_bn
from tpuseg.ops.gathered_conv import plan_gathered_conv as j_plan_gathered
from tpuseg.ops.gathered_conv import quantize_gathered_plan as j_quantize_gathered
from tpuseg.ops.quant import quantize_weight as j_quantize_weight
from tpuseg.sparsity import apply_masks as j_apply_masks
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg.video.pipeline import SyntheticFrames as JFrames
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models import drn as tdrn
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.sparse_exec import CompactSparseQ, build_sparse_plans
from tpuseg_torch.ops import sparse_conv as tsc
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.ops.gathered_conv import plan_gathered_conv, quantize_gathered_plan
from tpuseg_torch.ops.quant import QuantConv, full_support_packing, ids_agreement, quantize_weight
from tpuseg_torch.sparsity import apply_masks, create_masker
from tpuseg_torch.video.pipeline import SyntheticFrames as TFrames
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter

torch.set_num_threads(2)

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CONFIG = "optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json"
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
# port vs tpuseg int8 ids: test_torch_quant_serving.py's floor (two exact
# int8 paths on last-bit-different float activations round a few x/scale
# quotients apart, and each such step cascades)
INT8_AGREEMENT_MIN = 0.98


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
    keeps nothing), ``all_zero``; ``ones`` keeps everything."""
    nkb, nmb = cin // 128, cout // 128
    if kind == "ones":
        return np.ones((cout, cin, k, k), np.float32)
    m = np.zeros((cout, cin, k, k), np.float32)
    if kind == "all_zero":
        return m
    for j in range(nmb - 1 if kind == "dead_out" else nmb):
        for kb in rng.choice(nkb, size=2, replace=False):
            taps = rng.random(k * k) < 0.6
            taps[j % (k * k)] = True
            m[j * 128:(j + 1) * 128, kb * 128:(kb + 1) * 128] = taps.reshape(k, k)
    return m


def _weights(kind, k=3, cin=384, cout=384, seed=0):
    """OIHW weight and mask.  ``tiny_tile``: per_tap, with one live tile of
    out-block 0 scaled so far below the rest of its channels that it
    quantizes to all zeros.  ``ragged_dead`` (3 x 3 blocks): out-block 0
    keeps in-blocks 0 and 2, out-block 1 only in-block 1, out-block 2
    nothing, every tap."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
    if kind == "ragged_dead":
        sup = np.array([[1, 0, 0], [0, 1, 0], [1, 0, 0]], np.float32)  # (in, out) blocks
        m = np.kron(sup.T, np.ones((128, 128), np.float32))[:, :, None, None]
        return w, np.broadcast_to(m, w.shape).copy()
    m = _mask(rng, "per_tap" if kind == "tiny_tile" else kind, k, cin, cout)
    if kind == "tiny_tile":
        blocks = m[0, ::128].reshape(cin // 128, k * k)  # out-block 0: (in-block, tap)
        kb, tap = np.argwhere(blocks > 0)[-1]
        w[:128, kb * 128:(kb + 1) * 128, tap // k, tap % k] *= 1e-6
    return w, m


def _int8_packing(kind, k=3, d=2):
    """(port int8 packing, tpuseg's int8 packing or None, what the float
    packing counts as live) for ``kind``: fused (per_tap, dead_out,
    all_zero, tiny_tile), ``full`` (a QuantConv's full-support packing), or
    ``gathered_exact`` / ``gathered_split`` (the equivalent fused packing,
    padded slots and a dead out-block)."""
    if kind == "full":
        w, _ = _weights("ones", k=k)
        wq, ws = quantize_weight(_hwio(w))
        jwq, jws = j_quantize_weight(_hwio(w))
        assert wq.tobytes() == np.asarray(jwq).tobytes()
        return full_support_packing("c", wq, ws, d, d * (k - 1) // 2), None, None
    if kind.startswith("gathered"):
        mode = kind.split("_")[1]
        w, m = _weights("ragged_dead", k=k, seed=1)
        tq = quantize_gathered_plan(plan_gathered_conv(w, m, dilation=d, mode=mode))
        jq = j_quantize_gathered(j_plan_gathered(_hwio(w), _hwio(m), dilation=d, mode=mode))
        for j in range(len(tq.w_q)):
            if tq.w_q[j] is None:
                assert jq.w_q[j] is None
            else:
                assert tq.w_q[j].numpy().tobytes() == np.asarray(jq.w_q[j]).tobytes()
        return tq.packed, None, None
    w, m = _weights(kind, k=k)
    fplan = tsc.plan_fused_sparse_conv(w, m, dilation=d, dtype=torch.float32)
    tq = tsc.quantize_fused_plan(fplan)
    jq = jsc.quantize_fused_plan(
        jsc.plan_fused_sparse_conv(_hwio(w), _hwio(m), dilation=d, dtype=jnp.float32))
    return tq, jq, fplan


def _nonzero_tiles(p) -> np.ndarray:
    nmb = p.cout // p.bm
    return (p.vals.reshape(nmb, -1, p.bk * p.bm) != 0).any(-1).numpy()


KINDS = ["per_tap", "dead_out", "all_zero", "tiny_tile", "full", "gathered_exact",
         "gathered_split"]


@pytest.mark.parametrize("kind", KINDS)
def test_int8_steps_are_the_nonzero_int8_tiles(kind):
    """Each out-block's ``steps[:nsteps]`` lists exactly the nonzero tiles of
    the int8 ``vals``, in order, padded with 0 (int32, (nmb, T*S) and
    (nmb,)); ``vals`` stays tpuseg's bytes; ``.to()`` carries the lists."""
    tq, jq, fplan = _int8_packing(kind)
    nonzero = _nonzero_tiles(tq)
    nmb = tq.cout // tq.bm
    assert tq.steps.dtype == tq.nsteps.dtype == torch.int32
    assert tuple(tq.steps.shape) == nonzero.shape == (nmb, 9 * tq.s)
    assert tuple(tq.nsteps.shape) == (nmb,)
    for jb in range(nmb):
        n_live = int(tq.nsteps[jb])
        np.testing.assert_array_equal(tq.steps[jb, :n_live].numpy(), np.flatnonzero(nonzero[jb]))
        assert not tq.steps[jb, n_live:].any()
    if jq is not None:
        assert tq.vals.numpy().tobytes() == np.asarray(jq.vals).tobytes()
    moved = tq.to("cpu")
    assert torch.equal(moved.steps, tq.steps) and torch.equal(moved.nsteps, tq.nsteps)
    if kind in ("dead_out", "gathered_exact", "gathered_split"):
        assert int(tq.nsteps[-1]) == 0 and int(tq.nsteps[0]) > 0
    if kind == "all_zero":
        assert not tq.nsteps.any()
    if kind == "full":
        assert int(tq.nsteps.min()) == 9 * tq.s  # dense weights: every tile live
    if kind.startswith("gathered"):
        # out-block 1's padded slot holds zero tiles: only its 9 slot-0 steps
        assert tq.nsteps.tolist() == [18, 9, 0]
        assert all(ts % tq.s == 0 for ts in tq.steps[1, :9].tolist())
    if kind == "tiny_tile":
        # live in the float packing, all zero once quantized: one step fewer
        assert int(fplan.nsteps[0]) == int(tq.nsteps[0]) + 1
        assert torch.equal(fplan.nsteps[1:], tq.nsteps[1:])


def _walk_q(x: torch.Tensor, p) -> torch.Tensor:
    """B3's loop in plain PyTorch: quantize x, then for each out-block only
    its live steps, each the tap-shifted in-block rows[jb, s] of xq times
    the int8 tile, summed exactly in int64; then tpuseg's epilogue."""
    xq, xs = tsc.quantize_activation_reference(x, p.x_scale)
    n, h, w, _ = xq.shape
    nmb, S = p.rows.shape
    k, d = p.kernel, p.dilation
    pad = d * (k - 1) // 2
    xp = F.pad(xq.to(torch.int64), (0, 0, pad, pad, pad, pad))
    vals = p.vals.to(torch.int64)
    acc = torch.zeros((n, h, w, nmb * 128), dtype=torch.int64)
    for jb in range(nmb):
        for ts in p.steps[jb, :int(p.nsteps[jb])].tolist():
            t, s = divmod(ts, S)
            dy, dx = divmod(t, k)
            c0 = int(p.rows[jb, s]) * 128
            xt = xp[:, dy * d:dy * d + h, dx * d:dx * d + w, c0:c0 + 128]
            acc[..., jb * 128:(jb + 1) * 128] += xt @ vals[jb, ts * 128:(ts + 1) * 128]
    return tsc.dequantize(acc, xs, p.w_scale)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("static", [False, True])
def test_live_step_walk_equals_plain_version(kind, static):
    """The integer walk over the live steps only equals B3's plain version
    (every tile, zero ones included) bit for bit, on an odd 7 x 10 grid with
    bf16 x, per-frame and static scales."""
    tq, _, _ = _int8_packing(kind)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 7, 10, tq.cin))
                         .astype(np.float32)).to(torch.bfloat16)
    if static:
        tq.x_scale = float(x.float().abs().max()) / 127.0 * 0.8
    got = _walk_q(x, tq)
    want = tsc.fused_sparse_conv_q_reference(x, tq)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    if kind == "all_zero":
        assert not got.any()


def test_live_step_walk_equals_jax_kernel():
    """On the tiny-tile packing (a float-live tile that quantizes to zeros)
    the walk equals tpuseg's int8 Pallas kernel on the same plan and x."""
    tq, jq, _ = _int8_packing("tiny_tile")
    x = np.random.default_rng(3).normal(size=(2, 7, 10, 384)).astype(np.float32)
    got = _walk_q(torch.from_numpy(x), tq)
    want = np.asarray(jsc.fused_sparse_conv_apply_q(jnp.asarray(x), jq))
    assert got.numpy().tobytes() == want.tobytes()


def _plans_of_every_kind():
    """(plan, x channels) for the four int8 plan kinds, bf16 serving."""
    w, m = _weights("dead_out", cin=256, cout=384, seed=4)
    fused = tsc.quantize_fused_plan(tsc.plan_fused_sparse_conv(w, m, dilation=2))
    wq, ws = quantize_weight(_hwio(_weights("ones", cin=256, cout=384, seed=5)[0]))
    qc = QuantConv(torch.from_numpy(wq), torch.from_numpy(ws), 1, 2, 2, None,
                   full_support_packing("c", wq, ws, 2, 2))
    gq = quantize_gathered_plan(plan_gathered_conv(w, m, dilation=2, mode="exact"))
    # a 384-channel input whose in-block 1 is dead: CompactSparseQ compacts
    # channels 0-127 and 256-383 into the 256 the inner plan takes
    live = torch.cat([torch.arange(128), torch.arange(256, 384)])
    compact = CompactSparseQ(live, fused)
    return [(fused, 256), (qc, 256), (gq, 256), (compact, 384)]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("idx", range(4), ids=["FusedSparseConvQ", "QuantConv",
                                              "GatheredGroupConvQ", "CompactSparseQ"])
def test_int8_bf16_route_plain_is_cast_then_bias(idx, with_bias):
    """The served bf16 route of each int8 plan kind equals, bit for bit,
    models/drn.py's two passes (the f32 conv cast to bf16, then the bf16
    bias added), and counts no kernel launch on the CPU."""
    plan, cin = _plans_of_every_kind()[idx]
    rng = np.random.default_rng(7)
    x = tdrn.nhwc_to_nchw(torch.from_numpy(rng.normal(size=(2, 7, 10, cin)).astype(np.float32))
                          .to(torch.bfloat16))
    bias = torch.from_numpy(rng.normal(size=384).astype(np.float32)) if with_bias else None
    cdef = tdrn.ConvDef("c", cin, 384, 3, 1, 2, 2)
    before = (tsc.fused_sparse_conv_apply_q.launches, tsc.quantize_activation.launches,
              tsc.quantize_activation.absmax_launches)
    got = tdrn._sparse_conv_bias_bf16(x, plan, bias)
    want = tdrn._sparse_conv(x, plan, cdef).to(torch.bfloat16)
    if bias is not None:
        want = want + bias.to(torch.bfloat16).view(1, -1, 1, 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 384, 7, 10)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert got.permute(0, 2, 3, 1).is_contiguous()
    assert (tsc.fused_sparse_conv_apply_q.launches, tsc.quantize_activation.launches,
            tsc.quantize_activation.absmax_launches) == before
    if isinstance(plan, tsc.FusedSparseConvQ):
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        assert torch.equal(tsc.fused_sparse_conv_q_bias_bf16(nhwc, plan, bias),
                           tsc.fused_sparse_conv_q_bias_bf16_reference(nhwc, plan, bias))


def _jax_scale(x, x_scale):
    """The x scale exactly as tpuseg's fused_sparse_conv_apply_q computes it
    (tpuseg/ops/sparse_conv.py:1312-1318)."""
    if x_scale is None:
        absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=(1, 2, 3))
        return jnp.maximum(absmax, 1e-8) / 127.0
    return jnp.full((x.shape[0],), x_scale, jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static", [False, True])
def test_channel_map_quantize(dtype, static):
    """quantize_activation through an int32 channel map equals index_select
    followed by quantize_activation (xq and xs bit for bit) and tpuseg's
    scale on the gathered x; a frame of much larger range and an all-zero
    frame keep their own scales, and a frame holding a NaN gets a NaN scale
    (dynamic)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 5, 6, 384)).astype(np.float32)
    x[1, ..., 128:256] *= 1000.0  # outside the map: must not move frame 1's scale
    x[2] = 0.0
    x[3, 2, 3, 300] = np.nan
    chan = torch.cat([torch.arange(128), torch.arange(256, 384)]).to(torch.int32)
    tx = torch.from_numpy(x).to(dtype)
    x_scale = 0.013 if static else None
    xq, xs = tsc.quantize_activation(tx, x_scale, chan)
    gq, gs = tsc.quantize_activation(tx.index_select(3, chan.long()), x_scale)
    assert xq.shape == (4, 5, 6, 256) and xq.dtype == torch.int8
    assert xs.numpy().tobytes() == gs.numpy().tobytes()
    # PyTorch's cast of NaN to int8 is undefined: the NaN frame's xq is not compared
    assert torch.equal(xq[:3], gq[:3])
    js = np.asarray(_jax_scale(jnp.asarray(x[..., chan.numpy()], JDTYPE[dtype]), x_scale))
    assert xs[:3].numpy().tobytes() == js[:3].tobytes()
    if static:
        assert float(xs[3]) == float(js[3])
    else:
        assert np.isnan(float(xs[3])) and np.isnan(js[3])
        assert float(xs[1]) < 1.0  # the map kept the scaled-up channels out


def test_int8_wrappers_check_the_steps():
    """B3's wrapper refuses a packing whose step lists do not match its
    geometry, and a channel map of the wrong length, before anything runs."""
    tq, _, _ = _int8_packing("per_tap")
    x = torch.zeros((1, 4, 5, 384))
    bad = dataclasses.replace(tq, steps=tq.steps[:, :-1].contiguous())
    with pytest.raises(ValueError, match="steps"):
        tsc.fused_sparse_conv_apply_q(x, bad)
    with pytest.raises(ValueError, match="channels"):
        tsc.fused_sparse_conv_apply_q(x, tq, chan=torch.arange(256, dtype=torch.int32))
    with pytest.raises(ValueError, match="bias"):
        tsc.fused_sparse_conv_q_bias_bf16(x, tq, torch.zeros(5))


@pytest.mark.parametrize("lowering", [None, "pallas"])
def test_int8_bf16_segmenter_matches_jax(lowering):
    """bf16 int8 serving through the new route (every int8 conv takes B3's
    bf16+bias route) vs tpuseg's bf16 int8 VideoSegmenter, 2 frames of
    64x64, dense and block128reg_87.50 under the Pallas lowering: ids
    agreement >= INT8_AGREEMENT_MIN."""
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    tplans = jplans = None
    if lowering:
        tmasks = create_masker(CONFIG, seed=0).generate_masks(tp)
        tp = apply_masks(tp, tmasks)
        jmasks = j_create_masker(CONFIG, seed=0).generate_masks(jp, is_static=True)
        jp = dict(j_apply_masks(jp, jmasks))
        tplans, _ = build_sparse_plans(fold_bn(tp, ts, tspec), tmasks, tspec, lowering=lowering)
        jplans, _ = j_build(j_fold_bn(jp, js, jspec), jmasks, jspec, lowering=lowering)
    seg = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.bfloat16,
                     batch=2, exec_plans=tplans, quantize=True)
    int8 = [n for n, p in seg.exec_plans.items() if type(p).__name__ != "RbgpPlan"]
    assert len(int8) == (13 if lowering is None else 11)
    ids = seg.run(TFrames(2, (64, 64), seed=0), need_color=False)["ids"]
    jseg = JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=jnp.bfloat16, batch=2,
                      exec_plans=jplans, quantize=True)
    ref = np.asarray(jseg.run(JFrames(2, (64, 64), seed=0), warmup=False,
                              need_color=False)["ids"])
    agreement = ids_agreement(ids, ref)
    print(f"int8 bf16 ids agreement port vs tpuseg ({lowering or 'dense'}): {agreement:.6f}")
    assert agreement >= INT8_AGREEMENT_MIN, agreement


def test_ab_script_takes_the_b3_and_bsr_copies(capsys):
    """The A/B script takes old copies of B3's and B5/B6's sources beside
    B2's; without a card it exits 1 before building anything, and it
    refuses a run with no copy at all."""
    from tpuseg_torch import ab_sparse_conv

    assert ab_sparse_conv.main(["--old-q", "no_q.cu", "--old-bsr", "no_bsr.cu"]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ab_sparse_conv.main([])
