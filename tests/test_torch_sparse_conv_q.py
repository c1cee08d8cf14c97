"""Port parity for the int8 block-sparse conv (kernel B3's side):
quantize_fused_plan, quantize_activation and fused_sparse_conv_q_reference
against tpuseg's quantize_fused_plan and fused_sparse_conv_apply_q (its
Pallas kernel in interpret mode), the int8 gathered and compact plans, and
the two route identities that let B3 run QuantConv and GatheredGroupConvQ
on the card.  Outputs are compared bit for bit: every path computes the
same exact integer sums and rounds the same f32 epilogue."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.models.sparse_exec import CompactSparseQ as JCompactSparseQ
from tpuseg.models.sparse_exec import build_sparse_plans as j_build_sparse
from tpuseg.models.sparse_exec import quantize_sparse_plans as j_quantize_sparse
from tpuseg.ops.fold_bn import fold_bn as j_fold_bn
from tpuseg.ops.gathered_conv import plan_gathered_conv as j_plan_gathered
from tpuseg.ops.gathered_conv import quantize_gathered_plan as j_quantize_gathered
from tpuseg.ops.quant import QuantConv as JQuantConv
from tpuseg.sparsity import apply_masks as j_apply_masks
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.sparse_exec import (
    CompactSparseQ,
    build_sparse_plans,
    quantize_sparse_plans,
)
from tpuseg_torch.ops import sparse_conv as tsc
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.ops.gathered_conv import (
    gathered_conv_q_reference,
    plan_gathered_conv,
    quantize_gathered_plan,
)
from tpuseg_torch.ops.quant import (
    QuantConv,
    build_quant_plans,
    full_support_packing,
    quant_conv_reference,
    quantize_weight,
)
from tpuseg_torch.ops.rbgp_matmul import plan_rbgp
from tpuseg_torch.ops.sparse_conv import (
    fused_sparse_conv_apply,
    fused_sparse_conv_apply_q,
    fused_sparse_conv_q_reference,
    plan_fused_sparse_conv,
    quantize_activation,
    quantize_fused_plan,
)
from tpuseg_torch.sparsity import apply_masks, create_masker

torch.set_num_threads(2)

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
REG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "optimal_configs", "drn_d_22", "drn_d_22_block128reg_87.50.json")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _hwio(a):
    return np.ascontiguousarray(np.asarray(a).transpose(2, 3, 1, 0))


def _block_mask(rng, k, cin, cout, support, per_tap=False):
    """OIHW 0/1 mask from a (nkb, nmb) bool block support; ``per_tap`` drops
    some support blocks in taps after the first (the union stays)."""
    nkb, nmb = cin // 128, cout // 128
    m = np.zeros((cout, cin, k, k), np.float32)
    for t in range(k * k):
        tap = support & (rng.random((nkb, nmb)) < 0.7) if per_tap and t else support
        m[:, :, t // k, t % k] = np.kron(tap.T.astype(np.float32), np.ones((128, 128), np.float32))
    return m


def _case(seed, k, cin, cout, s, mask_kind="ragged"):
    """Weights and a block mask: out-block 0 keeps ``s`` in-blocks, the
    others 1..s; ``dead_out`` empties the last out-block, ``all_dead``
    everything."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
    nkb, nmb = cin // 128, cout // 128
    sup = np.zeros((nkb, nmb), bool)
    for j in range(nmb):
        sup[rng.choice(nkb, size=s if j == 0 else int(rng.integers(1, s + 1)),
                       replace=False), j] = True
    if mask_kind == "dead_out":
        sup[:, -1] = False
    if mask_kind == "all_dead":
        sup[:] = False
    return rng, w, _block_mask(rng, k, cin, cout, sup, per_tap=mask_kind == "per_tap")


def _bits(a):
    """Raw bytes of a torch tensor or a JAX/numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


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


def _x(rng, shape, dtype):
    """The same input on both sides: numpy f32 -> torch / jnp in ``dtype``
    (both round to nearest even for bf16)."""
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype), jnp.asarray(x, JDTYPE[dtype])


def _jax_quantize(x, x_scale):
    """tpuseg's x quantization as fused_sparse_conv_apply_q writes it."""
    n = x.shape[0]
    if x_scale is None:
        absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=(1, 2, 3))
        xs = jnp.maximum(absmax, 1e-8) / 127.0
    else:
        xs = jnp.full((n,), x_scale, jnp.float32)
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / xs[:, None, None, None]), -127, 127)
    return xq.astype(jnp.int8), xs


@pytest.mark.parametrize("mask_kind,k,d,cin,cout,s", [
    ("per_tap", 3, 1, 384, 256, 2),
    ("ragged", 3, 4, 512, 384, 2),
    ("dead_out", 3, 2, 256, 384, 2),
    ("all_dead", 3, 1, 256, 256, 1),
    ("ragged", 1, 1, 512, 256, 2),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_fused_plan_bit_equal(mask_kind, k, d, cin, cout, s, dtype):
    """vals / w_scale / rows / geometry equal tpuseg's quantize_fused_plan
    byte for byte, from bf16 and f32 float plans; vals_k is vals per tile,
    transposed."""
    _, w, m = _case(1, k, cin, cout, s, mask_kind)
    tq = quantize_fused_plan(plan_fused_sparse_conv(w, m, dilation=d, dtype=dtype), x_scale=0.25)
    jq = jsc.quantize_fused_plan(
        jsc.plan_fused_sparse_conv(_hwio(w), _hwio(m), dilation=d, dtype=JDTYPE[dtype]),
        x_scale=0.25)
    assert tq.vals.dtype == torch.int8 and tq.w_scale.dtype == torch.float32
    assert tuple(tq.vals.shape) == jq.vals.shape and tuple(tq.w_scale.shape) == jq.w_scale.shape
    assert _bits(tq.vals) == _bits(jq.vals)
    assert _bits(tq.w_scale) == _bits(jq.w_scale)
    assert _bits(tq.rows) == _bits(jq.rows)
    np.testing.assert_array_equal(tq.taps, jq.taps)
    assert (tq.s, tq.kernel, tq.dilation, tq.cin, tq.cout, tq.block_density, tq.x_scale) == (
        jq.s, jq.kernel, jq.dilation, jq.cin, jq.cout, jq.block_density, jq.x_scale)
    nmb, T = cout // 128, k * k
    want_k = tq.vals.reshape(nmb, T * tq.s, 128, 128).transpose(2, 3)
    assert torch.equal(tq.vals_k, want_k) and tq.vals_k.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_activation_bit_equal(dtype, static):
    """Per-frame scales and int8 x equal tpuseg's, with frames of very
    different ranges and an all-zero frame (scale 1e-8/127); a static scale
    small enough that values clip."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 7, 256)).astype(np.float32)
    x[1] *= 40.0
    x[2] = 0.0
    x_scale = 0.013 if static else None
    tq, ts = quantize_activation(torch.from_numpy(x).to(dtype), x_scale)
    jq, js = _jax_quantize(jnp.asarray(x, JDTYPE[dtype]), x_scale)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3,)
    assert _bits(ts) == _bits(js)
    assert _bits(tq) == _bits(jq)
    if static:
        assert int(tq.abs().max()) == 127  # clipped
    else:
        assert float(ts[2]) == float(np.float32(1e-8) / np.float32(127.0))


@pytest.mark.parametrize("shape,k,d,cin,cout,s,mask_kind,dtype,static", [
    ((1, 17, 33), 3, 1, 384, 256, 3, "per_tap", torch.float32, False),
    ((1, 17, 33), 3, 2, 384, 256, 2, "per_tap", torch.bfloat16, True),
    ((2, 8, 12), 3, 4, 256, 256, 1, "ragged", torch.bfloat16, False),
    ((2, 8, 12), 3, 4, 256, 256, 1, "ragged", torch.float32, True),
    ((1, 9, 20), 1, 1, 512, 256, 2, "ragged", torch.float32, False),
    ((1, 6, 10), 3, 1, 384, 128, 3, "per_tap", torch.bfloat16, False),
    ((2, 7, 9), 3, 2, 256, 384, 2, "dead_out", torch.float32, False),
    ((1, 5, 6), 3, 1, 256, 256, 1, "all_dead", torch.float32, True),
])
def test_b3_plain_matches_jax_kernel(shape, k, d, cin, cout, s, mask_kind, dtype, static):
    """The plain version of B3 (what a CPU tensor runs) vs tpuseg's Pallas
    int8 kernel on the same plan and x: output bit-equal (both sum integers
    exactly and round float(acc) * (xs * ws) in f32).  A dead out-block and
    an all-dead plan give exact zeros."""
    rng, w, m = _case(3, k, cin, cout, s, mask_kind)
    tx, jx = _x(rng, shape + (cin,), dtype)
    x_scale = float(np.abs(np.asarray(tx.float())).max()) / 127.0 * 0.8 if static else None
    tq = quantize_fused_plan(plan_fused_sparse_conv(w, m, dilation=d), x_scale=x_scale)
    jq = jsc.quantize_fused_plan(
        jsc.plan_fused_sparse_conv(_hwio(w), _hwio(m), dilation=d), x_scale=x_scale)
    fused_sparse_conv_apply_q.launches = 0
    got = fused_sparse_conv_apply_q(tx, tq)
    assert fused_sparse_conv_apply_q.launches == 0  # a CPU tensor runs the plain version
    want = np.asarray(jsc.fused_sparse_conv_apply_q(jx, jq))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == shape + (cout,)
    assert _bits(got) == _bits(want), float(np.abs(got.numpy() - want).max())
    if mask_kind == "dead_out":
        assert torch.all(got[..., 256:] == 0)
    if mask_kind == "all_dead":
        assert torch.all(got == 0)


@pytest.mark.parametrize("k,d,cin,cout", [(3, 2, 256, 256), (3, 4, 384, 128), (1, 1, 256, 384)])
@pytest.mark.parametrize("static", [False, True])
def test_full_support_route_identity(k, d, cin, cout, static):
    """QuantConv's B3 packing equals quantize_fused_plan(plan_fused_sparse_
    conv(w, ones, f32)) value for value, and B3's plain version on it equals
    QuantConv's plain version (and tpuseg's QuantConv.apply) bit for bit."""
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
    wq, ws = quantize_weight(_hwio(w))
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    x_scale = float(np.abs(x).max()) / 127.0 * 0.7 if static else None
    pad = d * (k - 1) // 2
    packed = full_support_packing("conv", wq, ws, d, pad, x_scale)
    ref = quantize_fused_plan(
        plan_fused_sparse_conv(w, np.ones_like(w), dilation=d, dtype=torch.float32), x_scale)
    for name in ("vals", "w_scale", "rows", "vals_k"):
        assert torch.equal(getattr(packed, name), getattr(ref, name)), name
    assert (packed.s, packed.block_density) == (cin // 128, 1.0)
    qc = QuantConv(torch.from_numpy(wq), torch.from_numpy(ws), 1, d, pad, x_scale, packed)
    tx = torch.from_numpy(x)
    via_b3 = fused_sparse_conv_q_reference(tx, packed)
    direct = quant_conv_reference(tx, qc)
    assert _bits(via_b3) == _bits(direct)
    assert _bits(qc.apply(tx)) == _bits(direct)
    jqc = JQuantConv(jnp.asarray(wq), jnp.asarray(ws), 1, d, pad, x_scale)
    assert _bits(direct) == _bits(jqc.apply(jnp.asarray(x)))


def test_full_support_packing_rejects_what_b3_cannot_run():
    """A conv B3 cannot run raises ValueError naming it (no fallback)."""
    wq = np.zeros((3, 3, 192, 128), np.int8)
    ws = np.ones(128, np.float32)
    with pytest.raises(ValueError, match="layer.5.0.conv1"):
        full_support_packing("layer.5.0.conv1", wq, ws, 2, 2)
    with pytest.raises(ValueError, match="layer.x"):
        full_support_packing("layer.x", np.zeros((3, 3, 128, 128), np.int8), ws, 2, 1)


@pytest.mark.parametrize("mode", ["exact", "split"])
@pytest.mark.parametrize("k,d", [(3, 2), (1, 1)])
@pytest.mark.parametrize("static", [False, True])
def test_gathered_q_matches_jax_and_b3(mode, k, d, static):
    """quantize_gathered_plan equals tpuseg's (w_q, w_scale per block, bit
    for bit, from bf16 plans); the plain version equals tpuseg's
    GatheredGroupConvQ.apply and B3's plain version on the equivalent
    packing, bit for bit; the dead out-block gives zeros."""
    rng, w, m = _case(6, k, 384, 384, 2, "dead_out")
    x = rng.normal(size=(2, 10, 13, 384)).astype(np.float32)
    x_scale = float(np.abs(x).max()) / 127.0 * 0.9 if static else None
    tq = quantize_gathered_plan(plan_gathered_conv(w, m, dilation=d, mode=mode), x_scale)
    jq = j_quantize_gathered(j_plan_gathered(_hwio(w), _hwio(m), dilation=d, mode=mode), x_scale)
    for j in range(3):
        if mode == "exact" and jq.w_q[j] is None:
            assert tq.w_q[j] is None and tq.w_scale[j] is None
            continue
        assert _bits(tq.w_q[j]) == _bits(jq.w_q[j])
        assert _bits(tq.w_scale[j]) == _bits(jq.w_scale[j])
    tx = torch.from_numpy(x)
    got = gathered_conv_q_reference(tx, tq)
    assert _bits(got) == _bits(jq.apply(jnp.asarray(x)))
    assert _bits(got) == _bits(fused_sparse_conv_q_reference(tx, tq.packed))
    assert _bits(tq.apply(tx)) == _bits(got)
    assert torch.all(got[..., 256:] == 0)


def test_compact_sparse_q_matches_jax():
    """CompactSparseQ (channel gather, then quantize: the per-frame scale is
    over the live channels) vs tpuseg's CompactSparseQ, bit for bit."""
    rng = np.random.default_rng(7)
    sup = np.array([[1, 0], [0, 1], [0, 0]], bool)  # in-block 2 dead everywhere
    m = _block_mask(rng, 3, 384, 256, sup)
    w = (rng.normal(size=m.shape) * 0.1).astype(np.float32)
    rp = plan_rbgp(w, m, dtype=torch.float32)
    live = rp.live_in.numpy()
    x = rng.normal(size=(2, 9, 11, 384)).astype(np.float32)
    x[..., 256:] *= 100.0  # dead channels: a scale over all of x would differ
    inner = quantize_fused_plan(plan_fused_sparse_conv(w[:, live], m[:, live], dilation=4))
    jinner = jsc.quantize_fused_plan(
        jsc.plan_fused_sparse_conv(_hwio(w[:, live]), _hwio(m[:, live]), dilation=4))
    got = CompactSparseQ(rp.live_in, inner).apply(torch.from_numpy(x))
    want = JCompactSparseQ(live.astype(np.int32), jinner).apply(jnp.asarray(x))
    assert _bits(got) == _bits(want)


def test_b3_plain_is_batch_independent():
    """Per-frame dynamic scales: a frame's output is the same alone and in a
    batch with a very different frame."""
    rng, w, m = _case(8, 3, 256, 256, 2)
    plan = quantize_fused_plan(plan_fused_sparse_conv(w, m, dilation=2))
    x = torch.from_numpy(rng.normal(size=(2, 6, 8, 256)).astype(np.float32))
    x[1] *= 50.0
    both = fused_sparse_conv_apply_q(x, plan)
    alone = fused_sparse_conv_apply_q(x[:1].contiguous(), plan)
    assert torch.equal(both[:1], alone)


def test_wrappers_reject_bad_inputs(monkeypatch):
    """B3's wrapper raises on a wrong dtype, a non-contiguous NHWC view, the
    wrong cin and a 3-D x before anything runs; B2's wrapper raises on an
    int8 plan."""
    _, w, m = _case(9, 3, 256, 128, 1)
    qplan = quantize_fused_plan(plan_fused_sparse_conv(w, m))
    called = []
    monkeypatch.setattr(tsc, "fused_sparse_conv_q_reference", lambda *a: called.append(a))
    x = torch.zeros((1, 4, 5, 256))
    cases = [
        (x.to(torch.float16), TypeError),
        (torch.zeros((1, 256, 4, 5)).permute(0, 2, 3, 1), ValueError),  # NCHW memory
        (torch.zeros((1, 4, 5, 384)), ValueError),
        (x[0], ValueError),
    ]
    for bad, exc in cases:
        with pytest.raises(exc):
            fused_sparse_conv_apply_q(bad, qplan)
    assert not called and fused_sparse_conv_apply_q.launches == 0
    fused_sparse_conv_apply_q(x, qplan)
    assert len(called) == 1
    with pytest.raises(TypeError):
        fused_sparse_conv_apply(x, qplan)


@pytest.mark.parametrize("lowering,kinds", [
    ("pallas", {"QuantConv": 4, "FusedSparseConvQ": 3, "CompactSparseQ": 4, "RbgpPlan": 3}),
    ("gathered", {"QuantConv": 4, "GatheredGroupConvQ": 9}),
])
def test_quantize_sparse_plans_kinds(lowering, kinds):
    """block128reg_87.50 lifted to int8 gives the same plan kind per conv as
    tpuseg's quantize_sparse_plans; merged over the dense int8 plans, the
    split is 4/3/4/3 (Pallas) and 9/4 (gathered)."""
    (tp, ts, tspec, tmasks), (jp, js, jspec, jmasks) = _masked(REG)
    tfold, jfold = fold_bn(tp, ts, tspec), j_fold_bn(jp, js, jspec)
    tuser, _ = build_sparse_plans(tfold, tmasks, tspec, lowering=lowering)
    juser, _ = j_build_sparse(jfold, jmasks, jspec, lowering=lowering)
    tq = quantize_sparse_plans(tuser)
    jq = j_quantize_sparse(juser)
    assert {k: type(v).__name__ for k, v in tq.items()} == {
        k: type(v).__name__ for k, v in jq.items()}
    merged = {**build_quant_plans(tfold, tspec), **tq}
    got: dict = {}
    for v in merged.values():
        got[type(v).__name__] = got.get(type(v).__name__, 0) + 1
    assert got == kinds
    b3 = sum(n for k, n in kinds.items() if k != "RbgpPlan")
    assert b3 == (11 if lowering == "pallas" else 13)
