"""Port parity for the int8 stem (``PolyphaseFrontend(int8_stem=True)``,
``calibrate_stem_scales``, ``VideoSegmenter(quantize_stem=True)`` and the
CLI's ``--quantize-stem``) against tpuseg on the same seed, weights and
frames, at full width (DRN-D-22, 19 classes) and small frames.

The three int8 stem convs are compared bit for bit on the same input: XLA on
the CPU rounds the epilogue's multiply and add separately (no FMA), as the
port does, so no tolerance is needed."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models import drnseg as jseg
from tpuseg.ops import polyphase as jpoly
from tpuseg.ops.fold_bn import fold_bn as jfold
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.weights import from_jax_params
from tpuseg_torch.ops import polyphase as tpoly
from tpuseg_torch.ops.quant import ids_agreement, stem_packing
from tpuseg_torch.ops.sparse_conv import (
    ZERO_VEC,
    channel_map_vectors,
    fused_sparse_conv_apply_q,
    fused_sparse_conv_q_bias_relu,
    fused_sparse_conv_q_bias_relu_reference,
    int_conv_exact,
    quantize_activation,
    relu_tpuseg,
    select_channels_by_vectors,
)
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter

torch.set_num_threads(2)

MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# ids agreement of two correct int8 paths (tests/test_torch_quant_serving.py
# explains why it cannot be 1); 0.97 is the int8 floor chip_smoke.py holds
# CUDA against the CPU to (INT8_PARITY_MIN)
INT8_AGREEMENT_MIN = 0.97


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@functools.cache
def _folded():
    """tpuseg's folded DRN-D-22 params (seed 0) and the port's copy."""
    params, state, spec = jseg.init_drnseg(0, "drn_d_22", 19)
    folded = jfold(params, state, spec)
    return folded, from_jax_params(folded)[0]


@functools.cache
def _frontends(dtype):
    folded, tp = _folded()
    jd, td = DTYPES[dtype]
    jfe = jpoly.FusedStage3Frontend(folded, dtype=jd, normalize=(MEAN, STD), int8_stem=True)
    tfe = tpoly.FusedStage3Frontend(tp, device="cpu", dtype=td, normalize=(MEAN, STD),
                                    int8_stem=True)
    return jfe, tfe


def _bits(a):
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).tobytes()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_q_convs_and_conv0_scale_bit_equal(dtype):
    """(w_q, w_scale) of the three stem convs, quantized from the folded
    weights as cast to the compute dtype, and conv0's analytic scale."""
    jfe, tfe = _frontends(dtype)
    assert len(tfe.q_convs) == len(jfe.q_convs) == 3
    for (jq, js), (tq, ts) in zip(jfe.q_convs, tfe.q_convs):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert _bits(tq) == _bits(jq) and _bits(ts) == _bits(js)
    assert tfe.conv0_x_scale == jfe.conv0_x_scale is not None


def test_bf16_weights_quantize_from_the_cast():
    """In bf16 serving the int8 weights come from the bf16-rounded fold,
    which gives other int8 values than the f32 fold."""
    (_, f32), (_, b16) = _frontends("f32"), _frontends("bf16")
    assert any(not torch.equal(a[0], b[0]) for a, b in zip(f32.q_convs, b16.q_convs))


def _direct_int_conv(xq, wq, pad_lo, pad_hi):
    """The folded conv itself on integers, in float64 (exact): HWIO ``wq``,
    padding (pad_lo, pad_hi) on both axes."""
    x = F.pad(xq.double().permute(0, 3, 1, 2), (pad_lo, pad_hi, pad_lo, pad_hi))
    w = torch.from_numpy(wq.astype(np.float64)).permute(3, 2, 0, 1)
    return F.conv2d(x, w).permute(0, 2, 3, 1)


@pytest.mark.parametrize("conv", [0, 1, 2])
def test_stem_packing_equals_direct_int_conv(conv):
    """B3's stem packing (every conv on the narrow route; conv0: 48
    channels, K = 64, N = 128, x padded to 64 through its map; conv1 and
    conv2: K = 128, S = 2, N = 128; conv2: the 2x2 pad (1, 0) conv as a 3x3
    'same' conv) gives the folded conv's integer sum exactly, through the
    plain version and on the padded operand; dead taps of conv2 are no live
    steps."""
    _, tfe = _frontends("f32")
    wq, ws = (t.numpy() for t in tfe.q_convs[conv])
    _, _, plo, phi = tfe.convs[conv]
    plan = stem_packing(f"conv{conv}", wq, ws, plo, phi)
    assert plan.narrow and plan.narrow_route and plan.kernel == 3 and plan.cin == wq.shape[2]
    assert (plan.bk, plan.bm) == ((64, 128) if conv == 0 else (128, 128))
    if conv == 2:  # only taps (p, q) in {0, 1}^2 of the 3x3 kernel are walked
        live = plan.steps[0, :int(plan.nsteps[0])] // plan.s
        assert (plo, phi) == (1, 0) and 0 < len(live) <= 4 * 2
        assert set(live.tolist()) <= {0, 1, 3, 4}
    rng = np.random.default_rng(conv)
    xq = torch.from_numpy(rng.integers(-127, 128, size=(2, 9, 13, wq.shape[2]), dtype=np.int8))
    # the packing's dense weight through the plain version's integer conv
    k, S, bk, bm = plan.kernel, plan.s, plan.bk, plan.bm
    nmb = plan.cout // bm
    vals = plan.vals.double().reshape(nmb, k, k, S, bk, bm)
    w = torch.zeros((k, k, S * bk, plan.cout), dtype=torch.float64)
    for jb, blocks in enumerate(plan.rows.tolist()):
        for s_i, kb in enumerate(blocks):
            w[:, :, kb * bk:(kb + 1) * bk, jb * bm:(jb + 1) * bm] += vals[jb, :, :, s_i]
    assert not w[:, :, plan.cin:].any()  # the zero rows past cin
    got = int_conv_exact(xq, w[:, :, :plan.cin], 1)
    torch.testing.assert_close(got, _direct_int_conv(xq, wq, plo, phi), rtol=0, atol=0)
    assert (plan.in_chan is not None) == (conv == 0)
    if conv == 0:  # the card's operand: xq padded through the map
        xq_p = select_channels_by_vectors(xq.double(), plan.in_chan, plan.in_vecs)
        assert xq_p.shape[3] == S * bk == 64
        torch.testing.assert_close(int_conv_exact(xq_p.to(torch.int8), w, 1), got,
                                   rtol=0, atol=0)


def test_stem_packing_names_the_conv():
    with pytest.raises(ValueError, match="layer.9.0"):
        stem_packing("layer.9.0", np.zeros((2, 2, 48, 256), np.int8),
                     np.ones(256, np.float32), 0, 0)
    with pytest.raises(ValueError, match="conv_x"):
        stem_packing("conv_x", np.zeros((3, 3, 128, 100), np.int8),
                     np.ones(100, np.float32), 1, 1)


def test_padding_channel_map_matches_zero_padded_x():
    """A -1 in the quantize pass's channel map reads 0: its xq and scale
    equal those of x padded with zero channels, dynamic and static, at
    conv0's 48 channels padded to 64 (the narrow route's K) and to 128; the
    map's descriptor holds the 48 channels as contiguous vectors and the
    padding as zero vectors, and its plain reader gives the padded x."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 5, 7, 48)).astype(np.float32))
    for width in (64, 128):
        chan = torch.cat([torch.arange(48), torch.full((width - 48,), -1)]).to(torch.int32)
        vecs = channel_map_vectors(chan)
        assert vecs.tolist() == list(range(0, 48, 8)) + [ZERO_VEC] * ((width - 48) // 8)
        padded = F.pad(x, (0, width - 48))
        assert torch.equal(select_channels_by_vectors(x, chan, vecs), padded)
        for x_scale in (None, 0.02):
            got = quantize_activation(x, x_scale, chan, vecs=vecs)
            want = quantize_activation(padded, x_scale)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_relu_matches_jax_on_zero_and_nan():
    v = np.array([-0.0, 0.0, np.nan, -1.5, 2.25, -np.inf, np.inf], np.float32)
    got = relu_tpuseg(torch.from_numpy(v)).numpy()
    assert got.tobytes() == np.asarray(jax.nn.relu(jnp.asarray(v))).tobytes()
    assert not np.signbit(got[0])  # torch.relu would keep -0.0


@pytest.mark.parametrize("size", [(64, 128), (128, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stem_convs_bit_equal(dtype, size):
    """The three int8 stem convs (per-frame scales for conv1 and conv2,
    analytic for conv0) on the same normalized input: output before stage 3
    bit-equal to tpuseg's ``_stem_convs``; the plain version ran
    (``fused_sparse_conv_apply_q.launches`` unmoved on the CPU)."""
    jfe, tfe = _frontends(dtype)
    jd, td = DTYPES[dtype]
    h, w = size
    frames = np.random.default_rng(h).integers(0, 256, size=(2, h, w * 3), dtype=np.uint8)
    x = jpoly.fold_input(jnp.asarray(frames), 4)
    x = ((x.astype(jnp.float32) / 255.0 - jfe.normalize[0]) * jfe.normalize[1]).astype(jd)
    ref = np.asarray(jfe._stem_convs(x).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(td)
    before = fused_sparse_conv_apply_q.launches
    out = tpoly.nchw_to_nhwc(tfe._stem_convs(tpoly.nhwc_to_nchw(xt)))
    assert fused_sparse_conv_apply_q.launches == before
    assert out.dtype == td and out.shape == (2, h // 4, w // 4, 128)
    assert out.float().numpy().tobytes() == ref.tobytes()


def test_stem_route_plain_version_is_the_quantized_conv():
    """``fused_sparse_conv_q_bias_relu`` on the CPU is its plain version:
    quantize, the exact conv, the f32 bias, relu, cast (conv0's narrow
    packing on its unpadded 48-channel x)."""
    _, tfe = _frontends("f32")
    plan, bias = tfe.q_plans[0]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 6, 10, 48)).astype(np.float32))
    for p in (plan, dataclasses.replace(plan, x_scale=0.05)):
        for dt in (torch.float32, torch.bfloat16):
            got = fused_sparse_conv_q_bias_relu(x, p, bias, dt)
            want = fused_sparse_conv_q_bias_relu_reference(x, p, bias, dt)
            assert got.dtype == dt and torch.equal(got, want)


def test_calibrate_stem_scales_match_jax():
    """Static stem scales from the float stem convs over two batches, f32:
    equal tpuseg's within rtol 1e-6 (the float convs sum in other orders);
    conv0 keeps its analytic scale; installed on the frontend."""
    folded, tp = _folded()
    jfe = jpoly.FusedStage3Frontend(folded, dtype=jnp.float32, normalize=(MEAN, STD),
                                    int8_stem=True)
    tfe = tpoly.FusedStage3Frontend(tp, device="cpu", dtype=torch.float32,
                                    normalize=(MEAN, STD), int8_stem=True)
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 256, size=(2, 64, 128 * 3), dtype=np.uint8) for _ in range(2)]
    ref = jpoly.calibrate_stem_scales(jfe, batches)
    got = tpoly.calibrate_stem_scales(tfe, batches)
    assert tfe.stem_x_scales == got and got[0] == tfe.conv0_x_scale == ref[0]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@functools.cache
def _segmenters(size=(64, 128)):
    """Port and tpuseg VideoSegmenter(quantize, quantize_stem, calibrated on
    4 shapes frames), f32; their ids on 4 other frames; tpuseg's calibration
    calls in order, with what each returned; the calibration frames."""
    import tpuseg.ops.quant as jquant
    from tpuseg.data.shapes import shapes_video as j_shapes
    from tpuseg_torch.data.shapes import shapes_video as t_shapes

    calib = list(t_shapes(4, size, seed=3)[0])
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    tseg = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.float32,
                      batch=2, quantize=True, quantize_stem=True, calib_frames=calib)
    ids = tseg.run(list(t_shapes(4, size, seed=4)[0]), need_color=False)["ids"]
    calls = []
    orig = jpoly.calibrate_stem_scales, jquant.calibrate_scales

    def stem(*a, **kw):
        calls.append(("stem", list(orig[0](*a, **kw))))
        return calls[-1][1]

    def stages(*a, **kw):
        calls.append(("stages", dict(orig[1](*a, **kw))))
        return calls[-1][1]

    jpoly.calibrate_stem_scales, jquant.calibrate_scales = stem, stages
    try:
        jp, js, jspec = jseg.init_drnseg(0, "drn_d_22", 19)
        jsegm = JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=None, batch=2,
                           quantize=True, quantize_stem=True,
                           calib_frames=list(j_shapes(4, size, seed=3)[0]))
    finally:
        jpoly.calibrate_stem_scales, jquant.calibrate_scales = orig
    ref = np.asarray(jsegm.run(list(j_shapes(4, size, seed=4)[0]), warmup=False,
                               need_color=False)["ids"])
    return tseg, ids, ref, calls, calib


# stage 4-8 scales, port against tpuseg: the float convs before them sum in
# other orders, so absmaxes differ in the last bits
STAGE_SCALE_RTOL = 1e-4


def test_segmenter_int8_stem_matches_jax():
    """The whole int8 slice with the int8 stem, calibrated, f32 at 64x128:
    ids agreement with tpuseg's >= INT8_AGREEMENT_MIN; tpuseg calibrated
    the stem first, then the stages; the port installed the same stem
    scales (rtol 1e-6) and stage scales (STAGE_SCALE_RTOL) on 13 plans."""
    tseg, ids, ref, calls, _ = _segmenters()
    assert [c[0] for c in calls] == ["stem", "stages"]
    np.testing.assert_allclose(tseg.stem_fn.stem_x_scales, calls[0][1], rtol=1e-6)
    installed = {n: p.x_scale for n, p in tseg.exec_plans.items()}
    assert len(installed) == 13 and set(installed) == set(calls[1][1])
    for name, scale in installed.items():
        np.testing.assert_allclose(scale, calls[1][1][name], rtol=STAGE_SCALE_RTOL)
    assert ids.shape == ref.shape == (4, 64, 128)
    agreement = ids_agreement(ids, ref)
    print(f"int8 stem ids agreement port vs tpuseg: {agreement:.6f}")
    assert agreement >= INT8_AGREEMENT_MIN, agreement


def test_segmenter_calibrates_stages_through_the_int8_stem():
    """The order matters: the installed stage scales are ``calibrate_scales``
    run through the int8 stem (with its static scales), and calibrating
    through the float stem gives scales that miss tpuseg's by more than
    STAGE_SCALE_RTOL."""
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.ops.quant import build_quant_plans, calibrate_scales

    tseg, _, _, calls, calib = _segmenters()
    installed = {n: p.x_scale for n, p in tseg.exec_plans.items()}
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    plans = build_quant_plans(fold_bn(tp, ts, tspec), tspec)
    batches = [np.stack(calib[i:i + 2]).reshape(2, 64, -1) for i in (0, 2)]

    def scales(stem_fn):
        return calibrate_scales(tseg.params, {}, tseg.spec, batches, plans=plans,
                                compute_dtype=torch.float32, stem_fn=stem_fn,
                                stem_stages=tseg.stem_stages)

    assert scales(tseg.stem_fn) == installed
    float_stem = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu",
                            compute_dtype=torch.float32, batch=2).stem_fn
    via_float = scales(float_stem)
    worst = max(abs(via_float[n] / calls[1][1][n] - 1) for n in installed)
    assert worst > STAGE_SCALE_RTOL, worst


def test_cli_quantize_stem(capsys):
    """--quantize --quantize-stem --calibrate 2 on the CPU at 64x128 (shapes
    video): the int8_plans event says so, then the result line."""
    from tpuseg_torch.cli import seg_video

    seg_video.main(["--device", "cpu", "--video", "shapes", "--size", "64x128", "--frames", "4",
                    "--batch", "2", "--quantize", "--quantize-stem", "--calibrate", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[-2] == {"event": "int8_plans", "kinds": {"QuantConv": 13},
                         "calibrated_frames": 2, "int8_stem": True}
    assert lines[-1]["frames"] == 4 and lines[-1]["device"] == "cpu"


def test_cli_quantize_stem_needs_quantize():
    from tpuseg_torch.cli import seg_video

    with pytest.raises(SystemExit, match="--quantize"):
        seg_video.main(["--device", "cpu", "--video", "synthetic", "--size", "32x64",
                        "--frames", "1", "--quantize-stem"])
