"""Port parity for the sparse conv lowerings: tpuseg_torch.ops.sparse_conv
(packing and the plain version of kernel B2), rbgp_matmul and gathered_conv
against their tpuseg functions on the same weights, masks and inputs.  The
JAX side of B2 is the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.sparse_exec import CompactSparse as JCompactSparse
from tpuseg.ops.gathered_conv import gathered_conv_apply as j_gathered_apply
from tpuseg.ops.gathered_conv import plan_gathered_conv as j_plan_gathered
from tpuseg.ops.rbgp_matmul import plan_rbgp as j_plan_rbgp
from tpuseg.ops.rbgp_matmul import rbgp_conv_apply as j_rbgp_apply
from tpuseg.sparsity.srmbrep import SRMBRepConfig, construct_srmbrep_mask
from tpuseg_torch.models.sparse_exec import CompactSparse
from tpuseg_torch.ops import sparse_conv as tsc
from tpuseg_torch.ops.gathered_conv import gathered_conv_apply, plan_gathered_conv
from tpuseg_torch.ops.rbgp_matmul import plan_rbgp, rbgp_conv_apply
from tpuseg_torch.ops.sparse_conv import (
    fused_sparse_conv_apply,
    fused_sparse_conv_reference,
    plan_fused_sparse_conv,
)

torch.set_num_threads(2)

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _hwio(a):
    return np.ascontiguousarray(np.asarray(a).transpose(2, 3, 1, 0))


def _block_mask(rng, k, cin, cout, support, per_tap=False):
    """OIHW 0/1 mask from a (nkb, nmb) bool block support; with ``per_tap``
    each tap drops some of the support blocks (the union stays
    ``support``), so the packing needs zero tiles for missing taps."""
    nkb, nmb = cin // 128, cout // 128
    m = np.zeros((cout, cin, k, k), np.float32)
    for t in range(k * k):
        tap = support & (rng.random((nkb, nmb)) < 0.7) if per_tap and t else support
        full = np.kron(tap.T.astype(np.float32), np.ones((128, 128), np.float32))
        m[:, :, t // k, t % k] = full
    return m


def _support(rng, nkb, nmb, s):
    """Random (nkb, nmb) support with exactly ``s`` in-blocks for out-block
    0 and 1..s for the others (a ragged, repeat-padded packing)."""
    sup = np.zeros((nkb, nmb), bool)
    for j in range(nmb):
        sup[rng.choice(nkb, size=s if j == 0 else int(rng.integers(1, s + 1)),
                       replace=False), j] = True
    return sup


def _case(seed, k, cin, cout, s, mask_kind="ragged"):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
    nkb, nmb = cin // 128, cout // 128
    if mask_kind == "all_dead":
        m = np.zeros_like(w)
    else:
        sup = _support(rng, nkb, nmb, s)
        if mask_kind == "dead_out":
            sup[:, -1] = False
        m = _block_mask(rng, k, cin, cout, sup, per_tap=mask_kind == "per_tap")
    return rng, w, m


def _bits(a):
    """Raw bytes of a torch tensor or a JAX/numpy array, for bit equality."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("mask_kind,k,d,cin,cout,s", [
    ("per_tap", 3, 1, 384, 256, 2),
    ("per_tap", 3, 2, 384, 256, 3),
    ("ragged", 3, 4, 512, 384, 2),
    ("dead_out", 3, 2, 256, 384, 2),
    ("all_dead", 3, 1, 256, 256, 1),
    ("ragged", 1, 1, 512, 256, 2),
])
def test_packing_bit_equal(mask_kind, k, d, cin, cout, s):
    """rows/vals/taps/s/block_density equal tpuseg's plan_fused_sparse_conv
    exactly, for bf16 and f32 plans (tolerance: none, bytes compared)."""
    _, w, m = _case(1, k, cin, cout, s, mask_kind)
    for dtype in (torch.bfloat16, torch.float32):
        tp = plan_fused_sparse_conv(w, m, dilation=d, dtype=dtype)
        jp = jsc.plan_fused_sparse_conv(_hwio(w), _hwio(m), dilation=d, dtype=JDTYPE[dtype])
        assert tp.vals.dtype == dtype and tp.rows.dtype == torch.int32
        assert tuple(tp.vals.shape) == jp.vals.shape and tuple(tp.rows.shape) == jp.rows.shape
        assert _bits(tp.vals) == _bits(jp.vals)
        assert _bits(tp.rows) == _bits(jp.rows)
        np.testing.assert_array_equal(tp.taps, jp.taps)
        assert (tp.s, tp.block_density, tp.kernel, tp.dilation, tp.cin, tp.cout) == (
            jp.s, jp.block_density, jp.kernel, jp.dilation, jp.cin, jp.cout)
    if mask_kind == "all_dead":
        assert tp.block_density == 0.0 and not tp.vals.any()


@pytest.mark.parametrize("shape,k,d,cin,cout,s,dtype", [
    ((1, 17, 33), 3, 1, 384, 256, 3, torch.float32),
    ((1, 17, 33), 3, 2, 384, 256, 2, torch.bfloat16),
    ((2, 8, 12), 3, 4, 256, 256, 1, torch.bfloat16),
    ((2, 8, 12), 3, 4, 256, 256, 1, torch.float32),
    ((1, 9, 20), 1, 1, 512, 256, 2, torch.float32),
    ((1, 6, 10), 3, 1, 384, 128, 3, torch.bfloat16),
])
def test_b2_plain_matches_jax_kernel(shape, k, d, cin, cout, s, dtype):
    """The plain version of B2 (what a CPU tensor runs) vs tpuseg's Pallas
    kernel on the same plan and x.  Tolerance: max abs error <= 1e-4 *
    max|ref| on the f32 output, for both plan dtypes (bf16 products are
    exact in f32, so only the summation order differs)."""
    rng, w, m = _case(2, k, cin, cout, s, "per_tap")
    x = rng.normal(size=shape + (cin,)).astype(np.float32)
    tp = plan_fused_sparse_conv(w, m, dilation=d, dtype=dtype)
    jp = jsc.plan_fused_sparse_conv(_hwio(w), _hwio(m), dilation=d, dtype=JDTYPE[dtype])
    assert tp.s == s
    fused_sparse_conv_apply.launches = 0
    got = fused_sparse_conv_apply(torch.from_numpy(x), tp)
    assert fused_sparse_conv_apply.launches == 0  # a CPU tensor runs the plain version
    want = np.asarray(jsc.fused_sparse_conv_apply(jnp.asarray(x), jp))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == shape + (cout,)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err


def test_b2_plain_zero_plans_give_exact_zeros():
    """An all-dead plan and the zero-weight padded slots contribute exact
    zeros: the dead out-block of a plan is 0.0 everywhere."""
    rng, w, m = _case(3, 3, 256, 384, 2, "dead_out")
    x = torch.from_numpy(rng.normal(size=(1, 7, 9, 256)).astype(np.float32))
    y = fused_sparse_conv_reference(x, plan_fused_sparse_conv(w, m, dilation=2))
    assert torch.all(y[..., 256:] == 0)
    z = fused_sparse_conv_reference(x, plan_fused_sparse_conv(w, np.zeros_like(m)))
    assert torch.all(z == 0) and z.shape == (1, 7, 9, 384)


def test_b2_wrapper_rejects_bad_inputs(monkeypatch):
    """Wrong dtype, a non-contiguous NHWC view and the wrong cin raise
    before anything runs (the plain version is never reached)."""
    _, w, m = _case(4, 3, 256, 128, 1)
    plan = plan_fused_sparse_conv(w, m)
    called = []
    monkeypatch.setattr(tsc, "fused_sparse_conv_reference", lambda *a: called.append(a))
    x = torch.zeros((1, 4, 5, 256))
    cases = [
        (x.to(torch.float16), TypeError),
        (torch.zeros((1, 256, 4, 5)).permute(0, 2, 3, 1), ValueError),  # NCHW memory
        (torch.zeros((1, 4, 5, 384)), ValueError),
        (x[0], ValueError),
    ]
    for bad, exc in cases:
        with pytest.raises(exc):
            fused_sparse_conv_apply(bad, plan)
    assert not called and fused_sparse_conv_apply.launches == 0
    fused_sparse_conv_apply(x, plan)
    assert len(called) == 1


def _srmb_mask(shape_oihw, ipat, isp=0.5, ibh=1, ibw=1, ph=32, pw=32, seed=0):
    cfg = SRMBRepConfig(obh=-1, obw=-1, cbh=ph * ibh, cbw=pw * ibw, ibh=ibh, ibw=ibw,
                        osp=0.0, opat="RAMANUJAN", isp=isp, ipat=ipat,
                        is_repetitive=True, collapse_tensor=True)
    t = np.zeros(shape_oihw, np.float32)
    return construct_srmbrep_mask(t, cfg, np.random.default_rng(seed)).astype(np.float32)


@pytest.mark.parametrize("kind,k,d,mask_args", [
    ("column_compact", 1, 1, ("COLUMN", 0.5)),
    ("tap_compact", 3, 2, ("COLUMN", 0.5)),
    ("grouped_conv", 1, 1, ("GROUP", 0.5, 4, 4, 8, 8)),
    ("dense", 3, 1, ("RAMANUJAN", 0.5)),
])
def test_rbgp_plans_match_jax(kind, k, d, mask_args):
    """Same plan kind and note string as tpuseg's plan_rbgp, and
    rbgp_conv_apply agrees within 1e-4 * max|ref| (f32)."""
    rng = np.random.default_rng(5)
    m = _srmb_mask((128, 128, k, k), *mask_args)
    w = rng.normal(size=(128, 128, k, k)).astype(np.float32)
    tp = plan_rbgp(w, m, dtype=torch.float32)
    jp = j_plan_rbgp(_hwio(w), _hwio(m), dtype=jnp.float32)
    assert tp.kind == jp.kind == kind and tp.note == jp.note
    if kind == "dense":
        return
    x = rng.normal(size=(1, 8, 16, 128)).astype(np.float32)
    got = rbgp_conv_apply(torch.from_numpy(x), tp, dilation=d).numpy()
    want = np.asarray(j_rbgp_apply(jnp.asarray(x), jp, dilation=d))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


@pytest.mark.parametrize("mode", ["exact", "split", "grouped"])
@pytest.mark.parametrize("k,d", [(3, 2), (1, 1)])
def test_gathered_conv_matches_jax(mode, k, d):
    """gathered_conv_apply vs tpuseg's, on a ragged mask with a dead
    out-block (exact mode emits zeros for it); f32, 1e-4 * max|ref|."""
    rng, w, m = _case(6, k, 384, 384, 2, "dead_out")
    x = rng.normal(size=(1, 10, 13, 384)).astype(np.float32)
    tp = plan_gathered_conv(w, m, dilation=d, dtype=torch.float32, mode=mode)
    jp = j_plan_gathered(_hwio(w), _hwio(m), dilation=d, dtype=jnp.float32, mode=mode)
    assert (tp.s, tp.block_density) == (jp.s, jp.block_density)
    got = gathered_conv_apply(torch.from_numpy(x), tp).numpy()
    want = np.asarray(j_gathered_apply(jnp.asarray(x), jp))
    assert got.shape == want.shape == (1, 10, 13, 384)
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
    assert np.all(got[..., 256:] == 0)


def test_compact_sparse_matches_jax():
    """CompactSparse.apply (channel slice + B2's plain version) vs tpuseg's
    CompactSparse.apply (slice + Pallas kernel): in-block 2 dead in every
    tap, survivor block-sparse; f32, 1e-4 * max|ref|."""
    rng = np.random.default_rng(7)
    sup = np.array([[1, 0], [0, 1], [0, 0]], bool)  # (nkb=3, nmb=2)
    m = _block_mask(rng, 3, 384, 256, sup)
    w = (rng.normal(size=m.shape) * 0.1).astype(np.float32)
    rp = plan_rbgp(w, m, dtype=torch.float32)
    assert rp.kind == "column_compact"
    live = rp.live_in.numpy()
    inner = plan_fused_sparse_conv(w[:, live], m[:, live], dilation=4, dtype=torch.float32)
    jinner = jsc.plan_fused_sparse_conv(_hwio(w[:, live]), _hwio(m[:, live]), dilation=4,
                                        dtype=jnp.float32)
    assert inner.block_density == 0.5
    x = rng.normal(size=(1, 9, 11, 384)).astype(np.float32)
    got = CompactSparse(rp.live_in, inner).apply(torch.from_numpy(x)).numpy()
    want = np.asarray(JCompactSparse(live.astype(np.int32), jinner).apply(jnp.asarray(x)))
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
