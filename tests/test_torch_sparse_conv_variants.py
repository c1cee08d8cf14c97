"""Port parity for the round-3 sparse conv variants (kernels B7a-f):
``plan_shared_sparse_conv`` (byte-equal packing) and the six entry points,
each against its tpuseg function (the Pallas kernel in interpret mode) on
the same weights, masks and inputs, at tests/test_sparse_conv.py's
shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drn import conv2d as j_conv2d
from tpuseg_torch.ops import sparse_conv as tsc

torch.set_num_threads(2)

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# entry point -> (packing, tpuseg's keyword arguments in its test)
VARIANTS = {
    "shared_sparse_conv_apply": ("shared", {"rows_per_tile": 4}),
    "fused_phase_sparse_conv_apply": ("fused", {"rows_per_tile": 4}),
    "imcol_phase_sparse_conv_apply": ("fused", {"rows_per_tile": 4}),
    "cphase_sparse_conv_apply": ("fused", {"rows_per_tile": 4}),
    "phase_sparse_conv_apply": ("shared", {"rows_per_tile": 4}),
    "shared_concat_sparse_conv_apply": ("shared", {"rows_per_tile": 4, "out_split": 2}),
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _oihw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1))


def _mask(nz, k):
    """HWIO mask: the (nkb, nmb) block support ``nz`` on every tap."""
    m2 = np.kron(np.asarray(nz, np.float32), np.ones((128, 128), np.float32))
    return np.broadcast_to(m2, (k, k) + m2.shape).copy()


def _plans(w, mask, dilation, dtype):
    """(port plan, tpuseg plan) of both packings."""
    return {
        "shared": (tsc.plan_shared_sparse_conv(_oihw(w), _oihw(mask), dilation, dtype),
                   jsc.plan_shared_sparse_conv(w, mask, dilation, JDTYPE[dtype])),
        "fused": (tsc.plan_fused_sparse_conv(_oihw(w), _oihw(mask), dilation, dtype),
                  jsc.plan_fused_sparse_conv(w, mask, dilation, JDTYPE[dtype])),
    }


@pytest.mark.parametrize("case", ["union_01_of_2", "union_13_of_4", "all_zero", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_shared_byte_equal(case, dtype):
    """vals, the union rows, S and union_density equal tpuseg's; the
    kernel's (nmb, S) int32 rows repeat the union rows."""
    rng = np.random.default_rng(8)
    k, cin, cout = 3, 512, 256
    nz = {"union_01_of_2": [[1, 0], [1, 1], [0, 0], [0, 0]],
          "union_13_of_4": [[0, 0], [1, 1], [0, 0], [1, 0]],
          "all_zero": np.zeros((4, 2)),
          "full": np.ones((4, 2))}[case]
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    got, want = _plans(w, _mask(nz, k), 2, dtype)["shared"]
    assert got.union_rows == want.rows and isinstance(got.union_rows, tuple)
    assert (got.s, got.kernel, got.dilation, got.cin, got.cout, got.union_density) == (
        want.s, want.kernel, want.dilation, want.cin, want.cout, want.union_density)
    np.testing.assert_array_equal(got.taps, want.taps)
    assert got.vals.dtype == dtype
    assert got.vals.float().numpy().tobytes() == np.asarray(want.vals, np.float32).tobytes()
    assert isinstance(got, tsc.FusedSparseConv)
    assert got.rows.dtype == torch.int32 and got.rows.is_contiguous()
    assert got.rows.tolist() == [list(got.union_rows)] * (cout // 128)
    assert got.block_density == got.union_density


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("dilation", [1, 2])
def test_variant_matches_jax(name, dilation):
    """f32 plan: the port's plain path vs the tpuseg function at its test's
    shapes and mask, and vs the masked dense conv; the CPU path launches
    nothing.  The sides differ only in summation order: over K = 9*S*128 =
    2304 unit-normal products the partial sums reach |y| ~ 50, so the
    absolute difference reaches ~1e-4 where y is near 0.  rtol is 1e-4 and
    atol 1e-3, the atol of tpuseg's own tests of these six functions."""
    rng = np.random.default_rng(9)
    k, cin, cout = 3, 512, 256
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    mask = _mask([[0, 1], [1, 0], [0, 0], [0, 1]], k)
    x = rng.normal(size=(2, 8, 16, cin)).astype(np.float32)
    packing, kw = VARIANTS[name]
    plan, jplan = _plans(w, mask, dilation, torch.float32)[packing]
    entry = getattr(tsc, name)
    before = entry.launches
    got = entry(torch.from_numpy(x), plan)
    assert entry.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, 16, cout)
    want = np.asarray(getattr(jsc, name)(jnp.asarray(x), jplan, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    ref = np.asarray(j_conv2d(jnp.asarray(x), jnp.asarray(w * mask), stride=1,
                              dilation=dilation, padding=dilation))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_odd_width_bf16(name):
    """Port only (tpuseg's phase kernels need w % 8 == 0 and fit VMEM): an
    odd grid (7 x 10) with a bf16 plan, a per-tap support and an all-zero
    out-block, within 2*K*eps of the f32 masked dense conv on the same bf16
    operands."""
    rng = np.random.default_rng(10)
    k, cin, cout, d = 3, 384, 384, 2
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    mask = _mask([[1, 0, 0], [0, 0, 0], [1, 1, 0]], k)
    mask[0, 1, :, :128] = 0  # a tap missing one block of out-block 0
    plan = _plans(w, mask, d, torch.bfloat16)[VARIANTS[name][0]][0]
    x = torch.from_numpy(rng.normal(size=(2, 7, 10, cin)).astype(np.float32))
    got = getattr(tsc, name)(x, plan)
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wb = torch.from_numpy(_oihw(w * mask)).to(torch.bfloat16).float()
    ref = torch.nn.functional.conv2d(xb, wb, None, 1, d, d).permute(0, 2, 3, 1)
    assert not got[..., 256:].any()
    tol = 2 * k * k * cin * np.finfo(np.float32).eps * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol
