"""Port parity for tpuseg_torch.ops.quant and the int8 plans of the slice:
quantize_weight, build_quant_plans (drn_d_22 and drn_d_54, full width),
the dense convs' B3 packings, QuantConv, calibrate_scales,
quantize_sparse_plans, and every int8 conv of the served forward on its own
activations, against tpuseg on the same seed and weights (its Pallas
kernels in interpret mode).  Plans and conv outputs are compared bit for
bit; calibrated scales within a stated tolerance."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drn import build_drn_spec as j_build_spec
from tpuseg.models.drn import init_drn as j_init_drn
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.models.sparse_exec import build_sparse_plans as j_build_sparse
from tpuseg.models.sparse_exec import quantize_sparse_plans as j_quantize_sparse
from tpuseg.ops.fold_bn import fold_bn as j_fold_bn
from tpuseg.ops.polyphase import FusedStage3Frontend as JFrontend
from tpuseg.ops.quant import build_quant_plans as j_build_quant
from tpuseg.ops.quant import calibrate_scales as j_calibrate
from tpuseg.ops.quant import quantize_weight as j_quantize_weight
from tpuseg.sparsity import apply_masks as j_apply_masks
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg_torch.models.drn import build_drn_spec, drn_forward, init_drn
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.sparse_exec import build_sparse_plans, quantize_sparse_plans
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.ops.polyphase import FusedStage3Frontend
from tpuseg_torch.ops.quant import (
    build_quant_plans,
    calibrate_scales,
    quantize_weight,
)
from tpuseg_torch.ops.sparse_conv import (
    FusedSparseConvQ,
    fused_sparse_conv_apply_q,
    plan_fused_sparse_conv,
    quantize_fused_plan,
)
from tpuseg_torch.sparsity import apply_masks, create_masker
from tpuseg_torch.video.pipeline import SyntheticFrames as TFrames

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "optimal_configs", "drn_d_22")
BLOCK = os.path.join(CONFIGS, "drn_d_22_block128_75.00.json")
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
# the 13 int8 convs of drn_d_22: stride-1 block convs and conv stages of
# stages 4-8 with >= 128 channels (layer.4.0.conv1 has stride 2)
D22_INT8 = (["layer.4.0.conv2", "layer.4.1.conv1", "layer.4.1.conv2"]
            + [f"layer.{s}.{b}.conv{c}" for s in (5, 6) for b in (0, 1) for c in (1, 2)]
            + ["layer.7.0", "layer.8.0"])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


@functools.cache
def _folded(arch="drn_d_22"):
    """(port folded f32 params, spec), (tpuseg the same), seed 0."""
    tp, ts, tspec = init_drnseg(0, arch, 19)
    jp, js, jspec = j_init(0, arch, 19)
    return (fold_bn(tp, ts, tspec), tspec), (j_fold_bn(jp, js, jspec), jspec)


@functools.cache
def _masked(config):
    """Port and tpuseg (params, state, spec, masks) with masks from masker
    seed 0, applied."""
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    tmasks = create_masker(config, seed=0).generate_masks(tp)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    jmasks = j_create_masker(config, seed=0).generate_masks(jp, is_static=True)
    return ((apply_masks(tp, tmasks), ts, tspec, tmasks),
            (dict(j_apply_masks(jp, jmasks)), js, jspec, jmasks))


def test_quantize_weight_bit_equal():
    """int8 weights and per-channel scales equal tpuseg's, including an
    all-zero output channel (scale 1e-8/127, weights 0)."""
    w = np.random.default_rng(0).normal(size=(3, 3, 64, 32)).astype(np.float32)
    w[..., 5] = 0.0
    tq, ts = quantize_weight(w)
    jq, js = j_quantize_weight(w)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert _bits(tq) == _bits(jq) and _bits(ts) == _bits(js)
    assert not tq[..., 5].any()


@pytest.mark.parametrize("arch", ["drn_d_22", "drn_d_54"])
def test_build_quant_plans_bit_equal(arch):
    """Full width: the same conv names, w_q, w_scale, stride, dilation and
    padding as tpuseg's build_quant_plans on the same folded weights; every
    plan carries a B3 packing of its own conv."""
    (tfold, tspec), (jfold, jspec) = _folded(arch)
    tplans = build_quant_plans(tfold, tspec)
    jplans = j_build_quant(jfold, jspec)
    assert list(tplans) == list(jplans)
    if arch == "drn_d_22":
        assert list(tplans) == D22_INT8
    for name, tp in tplans.items():
        jpl = jplans[name]
        assert _bits(tp.w_q) == _bits(jpl.w_q), name
        assert _bits(tp.w_scale) == _bits(jpl.w_scale), name
        assert (tp.stride, tp.dilation, tp.padding, tp.x_scale) == (
            jpl.stride, jpl.dilation, jpl.padding, jpl.x_scale)
        kh, kw, cin, cout = tp.w_q.shape
        assert (tp.packed.cin, tp.packed.cout, tp.packed.s, tp.packed.kernel) == (
            cin, cout, cin // 128, kh)


def test_dense_packings_equal_fused_quantization():
    """For each of drn_d_22's 13 int8 convs, the B3 packing equals
    quantize_fused_plan(plan_fused_sparse_conv(w, ones, f32)) value for
    value; with x_scales the static scale reaches the packing too."""
    (tfold, tspec), _ = _folded()
    scales = {n: 0.01 * (i + 1) for i, n in enumerate(D22_INT8)}
    plans = build_quant_plans(tfold, tspec, x_scales=scales)
    for name, p in plans.items():
        w = tfold[f"{name}.weight"]
        ref = quantize_fused_plan(
            plan_fused_sparse_conv(w, torch.ones_like(w), dilation=p.dilation,
                                   dtype=torch.float32), scales[name])
        for field in ("vals", "w_scale", "rows"):
            assert torch.equal(getattr(p.packed, field), getattr(ref, field)), (name, field)
        assert p.x_scale == p.packed.x_scale == scales[name]


def test_build_quant_plans_raises_on_bf16_weights():
    (tfold, tspec), _ = _folded()
    with pytest.raises(ValueError, match="f32 folded"):
        build_quant_plans({k: v.to(torch.bfloat16) for k, v in tfold.items()}, tspec)


def test_quant_plans_classifier_naming():
    """The cls naming ('layer5', no dot) yields plans too, as in tpuseg."""
    spec = build_drn_spec("drn_d_22", num_classes=10, naming="cls")
    tp, ts = init_drn(0, spec)
    jspec = j_build_spec("drn_d_22", num_classes=10, naming="cls")
    jp, js = j_init_drn(0, jspec)
    tplans = build_quant_plans(fold_bn(tp, ts, spec), spec)
    jplans = j_build_quant(j_fold_bn(jp, js, jspec), jspec)
    assert list(tplans) == list(jplans) and len(tplans) == 13


@pytest.mark.parametrize("static", [False, True])
def test_quant_conv_apply_matches_jax(static):
    """QuantConv.apply on the CPU (the plain version) vs tpuseg's
    QuantConv.apply for layer.6.1.conv2 (512->512, d=4) of drn_d_22, bit for
    bit, f32 and bf16 x; dynamic scales are per frame (the first frame's
    output is the same alone)."""
    (tfold, tspec), (jfold, jspec) = _folded()
    name = "layer.6.1.conv2"
    scales = {name: 0.02} if static else None
    tp = build_quant_plans(tfold, tspec, x_scales=scales)[name]
    jpl = j_build_quant(jfold, jspec, x_scales=scales)[name]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 7, 512)).astype(np.float32)
    x[1] *= 30.0
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tp.apply(torch.from_numpy(x).to(tdt))
        want = jpl.apply(jnp.asarray(x, jdt))
        assert _bits(got) == _bits(want), tdt
        alone = tp.apply(torch.from_numpy(x[:1]).to(tdt))
        assert torch.equal(alone, got[:1])


def _calibration_inputs(size, n=2):
    """Calibration frames as both segmenters feed them: raw flat uint8 on
    the stem path (H, W divisible by 8), normalized f32 otherwise."""
    arr = np.stack(list(TFrames(n, size, seed=3)))
    if size[0] % 8 == 0 and size[1] % 8 == 0:
        return [arr.reshape(n, size[0], -1)], True
    norm = (arr.astype(np.float32) / 255.0 - np.asarray(MEAN, np.float32)) / np.asarray(
        STD, np.float32)
    return [norm], False


@pytest.mark.parametrize("size", [(64, 64), (36, 36)])
def test_calibrate_scales_match_jax(size):
    """calibrate_scales on drn_d_22 in f32: the same 13 names as tpuseg's and
    each scale within 1e-4 relative (the float forwards sum in different
    orders).  64x64 runs the fused stage-3 frontend on raw bytes, 36x36 the
    normalized non-stem path."""
    (tfold, tspec), (jfold, jspec) = _folded()
    batches, stem = _calibration_inputs(size)
    tplans = build_quant_plans(tfold, tspec)
    jplans = j_build_quant(jfold, jspec)
    tstem = jstem = None
    if stem:
        tstem = FusedStage3Frontend(tfold, device="cpu", dtype=torch.float32,
                                    normalize=(MEAN, STD))
        jstem = JFrontend(jfold, dtype=jnp.float32, normalize=(MEAN, STD))
    tsc = calibrate_scales(tfold, {}, tspec, batches, plans=tplans, compute_dtype=None,
                           stem_fn=tstem, stem_stages=4 if stem else 1)
    jsc_ = j_calibrate(jfold, {}, jspec, batches, plans=jplans, compute_dtype=None,
                       stem_fn=jstem, stem_stages=4 if stem else 1)
    assert sorted(tsc) == sorted(jsc_) == sorted(D22_INT8)
    for name, v in tsc.items():
        assert isinstance(v, float) and v > 0
        assert abs(v - jsc_[name]) <= 1e-4 * jsc_[name], (name, v, jsc_[name])


def _pruned_plans(config):
    """Port and tpuseg (params, state, spec, f32 Pallas-lowering plans)."""
    (tp, ts, tspec, tmasks), (jp, js, jspec, jmasks) = _masked(config)
    tpl, _ = build_sparse_plans(fold_bn(tp, ts, tspec), tmasks, tspec, dtype=torch.float32)
    jpl, _ = j_build_sparse(j_fold_bn(jp, js, jspec), jmasks, jspec, dtype=jnp.float32)
    return (tp, ts, tspec, tpl), (jp, js, jspec, jpl)


class _Spy:
    """A port plan that records each input of the int8 plan it wraps (the
    port's dispatch runs any plan with ``.apply``)."""

    def __init__(self, plan, log):
        self.plan, self.log = plan, log

    def apply(self, x):
        self.log.append(x.clone())
        if isinstance(self.plan, FusedSparseConvQ):
            return fused_sparse_conv_apply_q(x, self.plan)
        return self.plan.apply(x)


def _jax_apply(plan, x):
    """tpuseg's int8 plan on x, as its dispatch runs it."""
    if isinstance(plan, jsc.FusedSparseConvQ):
        return jsc.fused_sparse_conv_apply_q(x, plan)
    return plan.apply(x)


@pytest.mark.parametrize("config", [None, BLOCK], ids=["dense", "block128_75.00"])
def test_int8_convs_bit_equal_on_slice_activations(config):
    """The port's int8 forward (drn_d_22, 2x64x64 f32) records the input of
    every int8 conv; on that input the port's plan and tpuseg's plan for the
    conv (eager, Pallas in interpret mode) give the same f32 output bit for
    bit: 13 QuantConv (dense), or the QuantConv / FusedSparseConvQ /
    CompactSparseQ mix of block128_75.00 under the Pallas lowering."""
    if config is None:
        (tfold, tspec), (jfold, jspec) = _folded()
        tplans, jplans = build_quant_plans(tfold, tspec), j_build_quant(jfold, jspec)
    else:
        (tp, ts, tspec, tpl), (jp, js, jspec, jpl) = _pruned_plans(config)
        tfold, jfold = fold_bn(tp, ts, tspec), j_fold_bn(jp, js, jspec)
        tplans = {**build_quant_plans(tfold, tspec), **quantize_sparse_plans(tpl)}
        jplans = {**j_build_quant(jfold, jspec), **j_quantize_sparse(jpl)}
    int8 = sorted(n for n, p in tplans.items() if type(p).__name__ != "RbgpPlan")
    logs = {n: [] for n in int8}
    spies = {n: _Spy(p, logs[n]) if n in logs else p for n, p in tplans.items()}
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    drn_forward(tfold, {}, torch.from_numpy(x), tspec, sparse_plans=spies)
    for name in int8:
        (xin,) = logs[name]
        got = spies[name].apply(xin)
        want = _jax_apply(jplans[name], jnp.asarray(xin.numpy()))
        assert _bits(got) == _bits(want), name
    kinds = {type(tplans[n]).__name__ for n in int8}
    assert kinds == ({"QuantConv"} if config is None
                     else {"QuantConv", "FusedSparseConvQ", "CompactSparseQ"}), kinds
